"""Hot reload, the circuit breaker, the preemption drain and the shadow
hook of the port's ``ModelServer``, on the CPU.

Versions are JAX-built MLPs of different seeds (``torch_serving_models``)
saved through the port's ``CheckpointManager`` at distinct steps; every
answer is held against the JAX ``output`` of the version that served it
(``kernel_tols``: rtol 2e-4, atol 2e-5 in f32).
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

import torch_serving_models as M
from conftest import kernel_tols
from deeplearning4j_tpu_torch.resilience.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.resilience.preemption import PreemptionHandler
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.util.model_serializer import restore_model


def _post(port, body, path="/predict"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def _readyz(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/readyz")
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def versions(tmp_path_factory):
    """Three JAX MLPs (seeds 3, 7, 11) and their zips."""
    d = tmp_path_factory.mktemp("versions")
    return [M.pair("mlp", d, seed=s)[:2] for s in (3, 7, 11)]


def _manager(tmp_path, versions, steps=(10, 20)):
    mgr = CheckpointManager(tmp_path / "ckpt", keep_last=5, device="cpu")
    for (_, path), step in zip(versions, steps):
        net = restore_model(path, device="cpu")
        net.iteration_count = step
        mgr.save(net)
    return mgr


def _check(port, jnet, version, seed=0):
    x = M.rows("mlp", 2, seed)
    code, body, _ = _post(port, {"features": x.tolist()})
    assert code == 200, body
    assert body["model_version"] == version
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(np.asarray(body["output"], np.float32),
                               np.asarray(jnet.output(x)), rtol=rtol,
                               atol=atol)


def test_reload_by_path_manager_and_step(tmp_path, versions):
    mgr = _manager(tmp_path, versions)
    server = ModelServer(checkpoint_manager=mgr, device="cpu").start()
    try:
        _check(server.port, versions[1][0], 1)  # the latest: step 20
        code, body = server.reload({"step": 10})
        assert code == 200 and body["source"] == "checkpoint-step-10"
        _check(server.port, versions[0][0], 2)
        code, body = server.reload({"path": versions[2][1]})
        assert code == 200 and body["version"] == 3
        _check(server.port, versions[2][0], 3)
        code, body = server.reload({})  # the manager's latest again
        assert code == 200 and body["source"] == "checkpoint-step-20"
        _check(server.port, versions[1][0], 4)
        code, body, _ = _post(server.port, {"step": 999},
                              path="/admin/reload")
        assert code == 400 and body["error"]["status"] == "no_reload_source"
        assert server.metrics.get("reload_total") == 3
    finally:
        server.stop()


def test_same_step_is_a_counted_noop_unless_forced(tmp_path, versions):
    mgr = _manager(tmp_path, versions)
    server = ModelServer(checkpoint_manager=mgr, device="cpu").start()
    try:
        code, body = server.reload({})
        assert code == 200 and body["status"] == "skipped"
        assert body["step"] == 20 and body["version"] == 1
        assert server.metrics.get("reload_skipped_total") == 1
        code, body = server.reload({"force": True})
        assert code == 200 and body["status"] == "reloaded"
        assert body["version"] == 2
        _check(server.port, versions[1][0], 2)
    finally:
        server.stop()


def test_failed_canary_keeps_the_old_version_serving(tmp_path, versions):
    bad = restore_model(versions[2][1], device="cpu")
    bad.set_params_flat(np.full(bad.num_params(), np.nan, np.float32))
    from deeplearning4j_tpu_torch.util.model_serializer import write_model

    bad_path = str(tmp_path / "nan.zip")
    write_model(bad, bad_path)
    server = ModelServer(versions[0][1], device="cpu").start()
    try:
        code, body = server.reload({"path": bad_path})
        assert code == 503 and body["error"]["status"] == "reload_failed"
        assert "error_id" in body["error"]
        assert server.metrics.get("reload_failure_total") == 1
        _check(server.port, versions[0][0], 1)
        assert _readyz(server.port)[0] == 200
    finally:
        server.stop()


def test_reload_under_traffic_loses_nothing(tmp_path, versions):
    server = ModelServer(versions[0][1], device="cpu", max_batch_size=4,
                         batch_timeout_ms=1.0).start()
    results = []
    lock = threading.Lock()
    done = threading.Event()

    def client(i):
        j = 0
        while not done.is_set() or j < 5:
            x = M.rows("mlp", 1, 1000 * i + j)
            code, body, _ = _post(server.port, {"features": x.tolist()})
            with lock:
                results.append((code, body.get("model_version"), x, body))
            j += 1

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        code, body = server.reload({"path": versions[1][1]})
        assert code == 200 and body["version"] == 2
        time.sleep(0.2)
        done.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        done.set()
        server.stop()
    assert {r[0] for r in results} == {200}
    assert {r[1] for r in results} == {1, 2}
    rtol, atol = kernel_tols()
    for _, version, x, body in results:
        jnet = versions[version - 1][0]
        np.testing.assert_allclose(np.asarray(body["output"], np.float32),
                                   np.asarray(jnet.output(x)), rtol=rtol,
                                   atol=atol)


def test_watch_swaps_in_a_new_checkpoint(tmp_path, versions):
    mgr = _manager(tmp_path, versions, steps=(10,))
    server = ModelServer(checkpoint_manager=mgr, device="cpu").start()
    try:
        server.watch(interval=0.05)
        net = restore_model(versions[1][1], device="cpu")
        net.iteration_count = 30
        mgr.save(net)
        for _ in range(400):
            if server.model_version == 2:
                break
            time.sleep(0.025)
        assert server.model_version == 2
        _check(server.port, versions[1][0], 2)
    finally:
        server.stop()
    assert server._watch_thread is None


def test_breaker_opens_fails_fast_then_closes(versions):
    poisoned = threading.Event()

    def transform(feats):
        if poisoned.is_set():
            raise RuntimeError("poisoned model")
        return feats

    breaker = CircuitBreaker(failure_threshold=2, reset_timeout=0.3,
                             name="predict")
    server = ModelServer(versions[0][1], device="cpu", breaker=breaker,
                         transform=transform).start()
    try:
        poisoned.set()
        for _ in range(2):
            code, body, _ = _post(server.port, {
                "features": M.rows("mlp", 1, 0).tolist()})
            assert code == 500 and body["error"]["status"] == "model_error"
        assert breaker.state == "open"
        code, body, headers = _post(server.port, {
            "features": M.rows("mlp", 1, 1).tolist()})
        assert code == 503 and body["error"]["status"] == "circuit_open"
        assert int(headers["Retry-After"]) >= 1
        code, ready = _readyz(server.port)
        assert code == 503 and "breaker_open" in ready["reasons"]
        time.sleep(0.35)
        assert breaker.state == "half_open"
        poisoned.clear()
        _check(server.port, versions[0][0], 1)
        assert breaker.state == "closed"
        assert _readyz(server.port)[0] == 200
        assert server.metrics.get("breaker_rejected_total") >= 1
    finally:
        server.stop()


def test_preemption_drain_finishes_in_flight_work(versions):
    gate = threading.Event()

    def held(feats):
        gate.wait(timeout=30)
        return feats

    server = ModelServer(versions[0][1], device="cpu", transform=held,
                         max_batch_size=4, batch_timeout_ms=1.0)
    gate.set()
    server.start()
    gate.clear()
    handler = PreemptionHandler()  # no signal handlers: notify() only
    server.install_preemption_drain(handler=handler, drain_timeout=20.0)
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(_post(
        server.port, {"features": M.rows("mlp", 1, i).tolist()})))
        for i in range(3)]
    for t in threads:
        t.start()
    for _ in range(500):
        if server.metrics.inflight == 3:
            break
        time.sleep(0.01)
    assert server.metrics.inflight == 3
    handler.notify("simulated")
    for _ in range(500):
        if server._draining:
            break
        time.sleep(0.01)
    code, body, _ = _post(server.port, {
        "features": M.rows("mlp", 1, 9).tolist()})
    assert code == 503 and body["error"]["status"] == "draining"
    gate.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert [r[0] for r in results] == [200, 200, 200]
    for _ in range(500):  # the drain closes the listener
        if server._httpd.socket.fileno() == -1:
            break
        time.sleep(0.01)
    assert server._httpd.socket.fileno() == -1


def test_shadow_sees_traffic_after_the_response_and_never_hurts_it(
        versions):
    class Scorer:
        def __init__(self, fail=False):
            self.calls = []
            self.fail = fail

        def observe(self, feats, out, live_ms):
            time.sleep(0.5)
            self.calls.append((np.array(feats), np.array(out), live_ms))
            if self.fail:
                raise RuntimeError("scorer fault")

    server = ModelServer(versions[0][1], device="cpu", max_batch_size=4,
                         batch_timeout_ms=1.0).start()
    try:
        for fail in (False, True):
            scorer = Scorer(fail)
            server.set_shadow(scorer)
            x = M.rows("mlp", 2, 3)
            t0 = time.perf_counter()
            code, body, _ = _post(server.port, {"features": x.tolist()})
            took = time.perf_counter() - t0
            assert code == 200 and took < 0.45  # not held by observe
            for _ in range(200):
                if scorer.calls:
                    break
                time.sleep(0.01)
            feats, out, live_ms = scorer.calls[0]
            np.testing.assert_array_equal(feats, x)
            np.testing.assert_array_equal(
                out, np.asarray(body["output"], np.float32))
            assert live_ms >= 0
        server.set_shadow(None)
        _check(server.port, versions[0][0], 1)
    finally:
        server.stop()

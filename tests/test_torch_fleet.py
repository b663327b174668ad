"""The port's multi-tenant serving against the JAX package's, on the CPU.

- the registry's eviction order against JAX's ``ModelRegistry`` on the
  same seeded sequence of admissions, touches (held and released) and
  pins, under a model-count and a byte budget;
- a page-out / page-in round trip: the same shapes, dtypes and dict
  structure in fresh dicts, the answers bitwise;
- quotas shedding ``503 tenant_quota`` against the tenant's own bound;
- one server over an MLP, a conv net and two graphs (VGG- and
  ResNet-shaped): each answer against JAX's ``output`` (``kernel_tols``:
  rtol 2e-4, atol 2e-5 in f32), bucketed answers bitwise their solo
  answers, a 404 listing the names, ``GET /models``, paging under a
  budget of two resident models with the shape counters flat, and a
  per-tenant reload;
- ``retry_after_value`` against JAX's on the same drain sequence;
- the router's candidate order against JAX's ``ServingRouter`` for
  seeded names, backends, loads and health, and a failover with zero
  lost requests when one of two CPU servers stops under load.
"""

import http.client
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serving_models as M
from conftest import kernel_tols
from deeplearning4j_tpu.serving import metrics as jmetrics
from deeplearning4j_tpu.serving import registry as jregistry
from deeplearning4j_tpu.serving.router import ServingRouter as JRouter
from deeplearning4j_tpu.serving.server import ModelServer as JModelServer
from deeplearning4j_tpu_torch.serving import ModelServer, ServingRouter
from deeplearning4j_tpu_torch.serving import metrics as pmetrics
from deeplearning4j_tpu_torch.serving import registry as pregistry
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


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


# -- the registry against JAX's -----------------------------------------------

class _Stub:
    def __init__(self, params, device=None):
        self.params = params
        self.state = {}
        self.device = device


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _registries(budget, sizes):
    jclock, pclock = _Clock(), _Clock()
    jreg = jregistry.ModelRegistry(clock=jclock, **budget)
    preg = pregistry.ModelRegistry(clock=pclock, **budget)
    for i, n in enumerate(sizes):
        name = f"m{i}"
        jreg.add(name, jregistry.ModelVersion(
            _Stub({"l": {"W": jnp.zeros(n, jnp.float32)}}), 1, "stub"))
        preg.add(name, pregistry.ModelVersion(
            _Stub({"l": {"W": torch.zeros(n)}}, torch.device("cpu")), 1,
            "stub"))
    return jreg, preg


def _residency(reg):
    return {n: reg.entry(n).resident for n in reg.names()}


@pytest.mark.parametrize("budget", [{"max_device_models": 2},
                                    {"max_device_bytes": 4 * 700}],
                         ids=["models", "bytes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eviction_order_matches_jax(budget, seed):
    sizes = [100, 200, 300, 400, 250]
    jreg, preg = _registries(budget, sizes)
    for reg in (jreg, preg):
        reg.enforce_budget()
    assert _residency(jreg) == _residency(preg)
    rng = np.random.RandomState(seed)
    held = []
    for step in range(60):
        op = rng.randint(0, 5)
        name = f"m{rng.randint(0, len(sizes))}"
        if op <= 1:  # a forward: touch and release
            for reg in (jreg, preg):
                reg.touch(reg.entry(name))
                reg.release(reg.entry(name))
        elif op == 2:  # a forward still running
            for reg in (jreg, preg):
                reg.touch(reg.entry(name))
            held.append(name)
        elif op == 3 and held:
            done = held.pop(0)
            for reg in (jreg, preg):
                reg.release(reg.entry(done))
        else:  # pin or unpin
            pinned = bool(rng.randint(0, 2))
            for reg in (jreg, preg):
                reg.pin(name, pinned)
        assert _residency(jreg) == _residency(preg), f"step {step}"
    js, ps = jreg.stats(), preg.stats()
    for key in ("weight_pagein_total", "weight_evict_total",
                "device_resident_models", "device_resident_bytes"):
        assert js[key] == ps[key], key


# -- paging -------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    return {kind: M.pair(kind, d) for kind in M.KINDS}


@pytest.mark.parametrize("kind", ["conv", "vgg", "resnet"])
def test_page_out_page_in_round_trip_is_bitwise(pairs, kind):
    _, path, _ = pairs[kind]
    net = restore_model(path, device="cpu")
    x = M.reshape_rows(M.rows(kind, 3, 5))
    before = net.output_padded(np.concatenate([x, x[:1] * 0]), n_valid=3)
    before = (before[0] if isinstance(before, list) else before).numpy()
    params, state = net.params, net.state
    sig = {a: {(ln, k): (tuple(t.shape), t.dtype)
               for ln, d in getattr(net, a).items() for k, t in d.items()}
           for a in ("params", "state")}
    nbytes = pregistry._tree_device_bytes(net)
    assert pregistry.page_out_model(net) == nbytes
    assert net.params is not params and net.state is not state
    assert pregistry.page_in_model(net) == nbytes
    for a in ("params", "state"):
        tree = getattr(net, a)
        assert {(ln, k): (tuple(t.shape), t.dtype) for ln, d in tree.items()
                for k, t in d.items()} == sig[a]
        for ln, d in tree.items():
            assert d is not (params if a == "params" else state)[ln]
    after = net.output_padded(np.concatenate([x, x[:1] * 0]), n_valid=3)
    after = (after[0] if isinstance(after, list) else after).numpy()
    np.testing.assert_array_equal(after, before)


# -- one server, four tenants -------------------------------------------------

def test_multi_tenant_serving_matches_jax_with_paging_and_reload(
        pairs, tmp_path):
    paths = {k: pairs[k][1] for k in M.KINDS}
    server = ModelServer(
        models={k: paths[k] for k in M.KINDS}, device="cpu",
        transform=M.reshape_rows, max_batch_size=4, max_device_models=2,
        batch_timeout_ms=1.0).start()
    rtol, atol = kernel_tols()
    try:
        snap = server.metrics_snapshot()
        warm = snap["counters"]["xla_compiles_total"]
        assert warm == 3 * len(M.KINDS)  # buckets 1, 2, 4 a tenant
        assert snap["paging"]["device_resident_models"] == 2
        solo = {}
        for round_ in range(2):  # round 2 faults evicted tenants back in
            for kind in M.KINDS:
                x = M.rows(kind, 3, 10 + M.KINDS.index(kind))
                code, body, _ = _post(server.port, {"features": x.tolist(),
                                                    "model": kind})
                assert code == 200, body
                assert body["model"] == kind and body["model_version"] == 1
                got = np.asarray(body["output"], np.float32)
                np.testing.assert_allclose(
                    got, M.jax_output(kind, pairs[kind][0], x),
                    rtol=rtol, atol=atol)
                if round_:
                    np.testing.assert_array_equal(got, solo[kind])
                solo[kind] = got
        snap = server.metrics_snapshot()
        assert snap["paging"]["weight_pagein_total"] >= 4
        assert snap["paging"]["device_resident_models"] <= 2
        # paging costs transfers, never a new shape
        assert snap["counters"]["xla_compiles_total"] == warm
        assert snap["counters"]["post_warmup_compiles_total"] == 0
        code, body, _ = _post(server.port, {"features": [[0.5] * 6],
                                            "model": "nope"})
        assert code == 404 and body["error"]["models"] == list(M.KINDS)
        code, models = _get(server.port, "/models")
        assert code == 200 and set(models["models"]) == set(M.KINDS)
        assert models["models"]["vgg"]["metrics"][
            "model_predictions_total"] == 2
        # per-tenant reload: vgg moves to a model of another seed
        jnew, newpath, _ = M.pair("vgg", tmp_path, seed=9)
        code, body = server.reload({"model": "vgg", "path": newpath})
        assert code == 200 and body["version"] == 2, body
        x = M.rows("vgg", 2, 20)
        code, body, _ = _post(server.port, {"features": x.tolist(),
                                            "model": "vgg"})
        assert code == 200 and body["model_version"] == 2
        np.testing.assert_allclose(np.asarray(body["output"], np.float32),
                                   M.jax_output("vgg", jnew, x),
                                   rtol=rtol, atol=atol)
        assert server.model_registry.entry("mlp").current.version == 1
    finally:
        server.stop()


def test_quota_sheds_the_tenant_not_its_neighbour(pairs):
    gate = threading.Event()
    gate.set()

    def held(feats):
        gate.wait(timeout=30)
        return feats

    server = ModelServer(
        models={"a": {"path": pairs["mlp"][1], "quota": 1},
                "b": pairs["mlp"][1]},
        device="cpu", transform=held, micro_batch=False, workers=2).start()
    try:
        gate.clear()
        first = {}
        t = threading.Thread(target=lambda: first.update(r=_post(
            server.port, {"features": M.rows("mlp", 1, 0).tolist(),
                          "model": "a"})))
        t.start()
        for _ in range(500):
            if server.model_registry.entry("a").inflight == 1:
                break
            time.sleep(0.01)
        code, body, headers = _post(server.port, {
            "features": M.rows("mlp", 1, 1).tolist(), "model": "a"})
        assert code == 503 and body["error"]["status"] == "tenant_quota"
        assert body["error"]["quota"] == 1 and "Retry-After" in headers
        second = {}
        u = threading.Thread(target=lambda: second.update(r=_post(
            server.port, {"features": M.rows("mlp", 1, 2).tolist(),
                          "model": "b"})))
        u.start()
        gate.set()
        for th in (t, u):
            th.join(timeout=30)
            assert not th.is_alive()
        assert first["r"][0] == 200 and second["r"][0] == 200
        snap = server.metrics_snapshot()
        assert snap["counters"]["quota_rejected_total"] == 1
        assert snap["models"]["a"]["model_shed_total"] == 1
        assert snap["models"]["b"].get("model_shed_total", 0) == 0
    finally:
        gate.set()
        server.stop()


# -- the adaptive Retry-After -------------------------------------------------

class _Queue:
    def __init__(self):
        self.n = 0

    def qsize(self):
        return self.n


class _Fake:
    def __init__(self, metrics, retry_after):
        self.metrics = metrics
        self.retry_after = retry_after
        self._queue = _Queue()


@pytest.mark.parametrize("knob", [0.01, 1.0, 30.0])
def test_retry_after_value_is_jax_formula(knob):
    jf = _Fake(jmetrics.ServingMetrics(), knob)
    pf = _Fake(pmetrics.ServingMetrics(), knob)
    rng = np.random.RandomState(int(knob * 100))
    now = 1000.0
    got, want = [], []
    for i in range(200):
        now += float(rng.exponential(0.02))
        if rng.rand() < 0.7:
            jf.metrics.note_completion(now)
            pf.metrics.note_completion(now)
        jf._queue.n = pf._queue.n = int(rng.randint(0, 40))
        want.append(JModelServer.retry_after_value(jf))
        got.append(ModelServer.retry_after_value(pf))
    assert got == want
    assert len(set(got)) > 1 or knob < 0.05


# -- the router --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_router_candidate_order_matches_jax(seed):
    rng = np.random.RandomState(seed)
    backends = [f"10.0.{rng.randint(0, 9)}.{i}:{8000 + rng.randint(0, 99)}"
                for i in range(int(rng.randint(2, 6)))]
    jr = JRouter(backends, spread_after=3)
    pr = ServingRouter(backends, spread_after=3)
    try:
        for trial in range(40):
            for jb, pb in zip(jr.backends, pr.backends):
                jb.outstanding = pb.outstanding = int(rng.randint(0, 10))
                jb.healthy = pb.healthy = bool(rng.rand() > 0.2)
            name = f"model-{rng.randint(0, 1000)}"
            assert ([b.address for b in pr.candidates(name)]
                    == [b.address for b in jr.candidates(name)]), trial
    finally:
        jr.stop()
        pr.stop()


def test_router_fails_over_with_zero_lost_requests(pairs):
    servers = [ModelServer(pairs["mlp"][1], device="cpu", max_batch_size=4,
                           batch_timeout_ms=1.0).start() for _ in range(2)]
    router = ServingRouter([f"127.0.0.1:{s.port}" for s in servers],
                           health_interval=0.05).start()
    statuses = []
    lock = threading.Lock()
    stop_at = threading.Event()

    def client(i):
        for j in range(30):
            code, _, _ = _post(router.port, {
                "features": M.rows("mlp", 1, 100 * i + j).tolist()})
            with lock:
                statuses.append(code)
                if len(statuses) == 40:
                    stop_at.set()

    owner = router.candidates("")[0]
    victim = next(s for s in servers if s.port == owner.port)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        assert stop_at.wait(timeout=60)
        victim.stop(drain_timeout=2.0)
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert len(statuses) == 120 and set(statuses) == {200}
        snap = router.metrics_snapshot()
        assert snap["router_unroutable_total"] == 0
        assert sum(b["forwarded"] for b in snap["backends"]) == 120
        survivor = next(s for s in servers if s is not victim)
        assert survivor.metrics.get("predictions_total") > 0
    finally:
        router.stop()
        for s in servers:
            if s is not victim:
                s.stop()

"""The port's ``ModelServer`` on the CPU: HTTP ``/predict`` answers
match the JAX package's ``output`` on the same weights (tolerance
``kernel_tols()``), micro-batched rows are bitwise equal to solo
predicts, and the request validation, admission bound and deadlines
answer as the JAX server does (400 / 422 / 503 / 504)."""

import http.client
import json
import threading

import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch.serving import ModelServer
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

WIDTH = 28 * 28


def _jax_lenet():
    conf = (
        JNeuralNetConfiguration.Builder().seed(3).updater("ADAM")
        .list()
        .layer(JConv(n_out=4, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JConv(n_out=6, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JDense(n_out=32, activation="relu"))
        .layer(JOutput(n_out=10, loss="MCXENT"))
        .set_input_type(JInputType.convolutional_flat(28, 28, 1))
        .build()
    )
    return JMultiLayerNetwork(conf).init()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jnet = _jax_lenet()
    path = tmp_path_factory.mktemp("serve") / "lenet.zip"
    jax_serializer.write_model(jnet, str(path))
    return jnet, str(path)


def _post(port, body, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        data = raw if raw is not None else json.dumps(body).encode()
        conn.request("POST", "/predict", body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _rows(n, seed):
    return np.random.RandomState(seed).rand(n, WIDTH).astype(np.float32)


def test_predict_matches_jax_output(models):
    jnet, path = models
    server = ModelServer(path, device="cpu", max_batch_size=8).start()
    try:
        x = _rows(3, 0)
        code, body = _post(server.port, {"features": x.tolist()})
        assert code == 200
        rtol, atol = kernel_tols()
        np.testing.assert_allclose(np.asarray(body["output"], np.float32),
                                   np.asarray(jnet.output(x)),
                                   rtol=rtol, atol=atol)
        code, body = _post(server.port, {"features": x[0].tolist()})
        assert code == 200 and len(body["output"]) == 10  # 1-d in, 1-d out
        assert _get(server.port, "/healthz") == (200, {
            "status": "ok", "model": "MultiLayerNetwork", "version": 1,
            "device": "cpu"})
        assert _get(server.port, "/readyz")[0] == 200
    finally:
        assert server.stop()


def test_micro_batched_rows_bitwise_equal_solo(models):
    _, path = models
    gate = threading.Event()
    gate.set()

    def held(feats):  # holds the drain thread while the gate is shut
        gate.wait(timeout=30)
        return feats

    # one bucket of 8 rows: solo and batched requests run the same shape
    server = ModelServer(path, device="cpu", bucket_ladder=[8],
                         transform=held, batch_timeout_ms=2000).start()
    try:
        feats = [_rows(2, s) for s in range(4)]
        solo = [_post(server.port, {"features": f.tolist()})[1]["output"]
                for f in feats]
        results = [None] * 5

        def call(i, f):
            results[i] = _post(server.port, {"features": f.tolist()})

        gate.clear()
        # a blocker request parks the drain thread in its transform, so
        # the next four queue up and coalesce into one 8-row batch
        threads = [threading.Thread(target=call, args=(4, _rows(1, 9)))]
        threads[0].start()
        for i, f in enumerate(feats):
            while server.metrics.inflight < i + 1:
                threading.Event().wait(0.005)
            threads.append(threading.Thread(target=call, args=(i, f)))
            threads[-1].start()
        while server.metrics.inflight < 5:
            threading.Event().wait(0.005)
        gate.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for (code, body), want in zip(results, solo):
            assert code == 200
            assert body["output"] == want
        snap = _get(server.port, "/metrics")[1]
        assert snap["batch_items"].get("4") == 1
        assert snap["counters"]["warmup_predicts_total"] == 1
    finally:
        gate.set()
        server.stop()


def test_bad_requests_get_400_and_422(models):
    _, path = models
    server = ModelServer(path, device="cpu", max_batch_size=4).start()
    try:
        code, body = _post(server.port, None, raw=b"{not json")
        assert code == 400
        assert body["error"]["status"] == "malformed_json"
        code, body = _post(server.port, {"rows": [1.0]})
        assert code == 400
        code, body = _post(server.port, {"features": [[1.0] * 17]})
        assert code == 422
        assert body["error"]["expected"] == [1, WIDTH]
        assert body["error"]["got"] == [1, 17]
        code, body = _post(server.port, {"features": [[[1.0]]]})
        assert code == 422
        code, body = _post(server.port, {"features": "abc"})
        assert code == 422
        code, body = _post(server.port, {"features": [[0.0] * WIDTH],
                                         "model": "other"})
        assert code == 404
    finally:
        server.stop()


def test_admission_bound_sheds_with_503_and_deadline_gives_504(models):
    _, path = models
    gate = threading.Event()

    def slow(feats):
        gate.wait(timeout=30)
        return feats

    net = restore_model(path, device="cpu")
    server = ModelServer(net, device="cpu", workers=1, queue_depth=0,
                         transform=slow, deadline=0.5, micro_batch=False)
    gate.set()  # warm-up must pass the transform
    server.start()
    gate.clear()
    try:
        first = {}
        t = threading.Thread(target=lambda: first.update(
            r=_post(server.port, {"features": _rows(1, 0).tolist()})))
        t.start()
        for _ in range(500):  # wait until the first request is admitted
            if server.metrics.inflight == 1:
                break
            threading.Event().wait(0.01)
        code, body = _post(server.port, {"features": _rows(1, 1).tolist()})
        assert code == 503
        assert body["error"]["status"] == "shed"
        t.join(timeout=30)
        assert not t.is_alive()
        assert first["r"][0] == 504
        assert first["r"][1]["error"]["status"] == "deadline_exceeded"
    finally:
        gate.set()
        server.stop()


def test_server_needs_a_card_unless_told_cpu(models):
    _, path = models
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelServer(path)
    net = restore_model(path, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelServer(net, device="cuda")

"""The port's exporters (``observability/export.py``) against the JAX
package's: ``prometheus_text`` byte-equal and ``registry_snapshot``
equal for registries filled by the same calls (counters, labelled
gauges with characters to escape, histograms, summaries, an empty
summary), ``parse_format_query`` the same; and the serving endpoint
``GET /metrics?format=prometheus``, which answers text in the format
(every sample line parses) beside the JSON default."""

import json
import re
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.observability import export as jexport
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu_torch.observability import export, metrics

SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r',?)*\})? (-?[0-9.e+-]+|\+Inf|-Inf|NaN)$')


def parse_prometheus(text: str) -> dict:
    """``{sample name with labels: value}`` of an exposition; raises on a
    line that is neither a comment nor a sample."""
    out = {}
    assert text.endswith("\n")
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        if not SAMPLE.match(line):
            raise AssertionError(f"not a Prometheus sample line: {line!r}")
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


def _fill(mod):
    reg = mod.MetricsRegistry(clock=lambda: 100.0)
    reg.counter("requests_total", help="all requests").inc(3)
    c = reg.counter("model_requests_total", help='per "model"\nrequests',
                    labels=("model",))
    c.labels(model="lenet").inc(2)
    c.labels(model='we"ird\\name\n').inc()
    reg.gauge("queue_depth").set(4)
    reg.gauge("loss", help="latest").set(0.125)
    reg.gauge("inf_gauge").set(float("inf"))
    h = reg.histogram("latency_ms", buckets=(1.0, 5.0, 25.0),
                      help="latency", labels=("route",))
    for v in (0.5, 2.0, 2.0, 30.0):
        h.labels(route="/predict").observe(v)
    s = reg.summary("step_ms", help="step", reservoir_size=16)
    for v in range(1, 11):
        s.observe(float(v))
    reg.summary("empty_ms")
    return reg


def test_prometheus_text_is_byte_equal_to_jax():
    ours, theirs = _fill(metrics), _fill(jmetrics)
    text = export.prometheus_text(ours)
    assert text == jexport.prometheus_text(theirs)
    samples = parse_prometheus(text)
    assert samples["requests_total"] == 3
    assert samples['latency_ms_bucket{route="/predict",le="+Inf"}'] == 4
    assert samples['latency_ms_bucket{route="/predict",le="5"}'] == 3
    assert samples['step_ms{quantile="0.5"}'] == 6  # nearest rank
    assert "# HELP model_requests_total per \"model\"\\nrequests" in text
    assert export.CONTENT_TYPE == jexport.CONTENT_TYPE


def test_registry_snapshot_equals_jax():
    ours, theirs = _fill(metrics), _fill(jmetrics)
    assert json.dumps(export.registry_snapshot(ours), sort_keys=True) == \
        json.dumps(jexport.registry_snapshot(theirs), sort_keys=True)


@pytest.mark.parametrize("path", ["/metrics", "/metrics?format=prometheus",
                                  "/metrics?format=json&x=1", "/healthz?"])
def test_parse_format_query_equals_jax(path):
    assert export.parse_format_query(path) == jexport.parse_format_query(path)


def test_server_answers_prometheus():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ModelServer

    conf = (NeuralNetConfiguration.Builder().seed(2).list()
            .layer(DenseLayer(n_in=4, n_out=5)).layer(OutputLayer(n_out=2))
            .build())
    server = ModelServer(MultiLayerNetwork(conf, device="cpu").init(),
                         device="cpu").start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        body = json.dumps({"features": np.ones((2, 4)).tolist()}).encode()
        req = urllib.request.Request(f"{base}/predict", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/metrics?format=prometheus",
                                    timeout=30) as r:
            assert r.headers["Content-Type"] == export.CONTENT_TYPE
            text = r.read().decode()
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            snap = json.loads(r.read())
    finally:
        server.stop()
    samples = parse_prometheus(text)
    assert samples["serving_predictions_total"] == 1
    assert samples["serving_requests_total"] >= 2
    assert samples["queue_depth"] == 0 and samples["model_version"] == 1
    assert samples["request_latency_seconds_count"] == 1
    assert snap["counters"]["predictions_total"] == 1  # JSON: the default

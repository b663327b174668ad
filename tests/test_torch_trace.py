"""The port's tracer (``observability/trace.py``) against the JAX
package's, and the spans and events of the modules it instruments.

- The same seed and the same calls give the same trace and span ids,
  parents, statuses and attributes, and the same JSONL lines but for
  the times; the sink rotates the same way.
- Retry attempts, a deadline cut and exhaustion, breaker transitions
  and a checkpoint save and restore emit the JAX package's event and
  span names with its attributes.
- The distributed trainer's ``train.fit`` / ``train.epoch`` spans.
- A ``ModelServer`` with a tracer: one trace id across each request's
  ``serving.request``, ``serving.admission``, ``serving.queue``,
  ``serving.batch_assembly`` and ``serving.predict`` spans, from the
  handler thread to the drain thread.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.observability import trace as jtrace
from deeplearning4j_tpu.resilience import breaker as jbreaker
from deeplearning4j_tpu.resilience import retry as jretry
from deeplearning4j_tpu_torch.observability import trace
from deeplearning4j_tpu_torch.resilience import breaker, retry

TIMES = ("start", "end", "duration_ms")


def _drive(mod, sink):
    """The same calls on either package's tracer."""
    t = mod.Tracer(seed=1234, sink=sink)
    root = t.start_span("serving.request", attrs={"rows": 3})
    child = t.start_span("serving.admission", parent=root)
    child.set_attr("outcome", "admitted").end()
    ctx = root.context
    handed = t.start_span("serving.queue", parent=ctx)
    handed.add_event("dequeued", depth=2)
    handed.end("timeout")
    t.event("breaker.transition", attrs={"from": "closed", "to": "open"})
    with pytest.raises(ValueError):
        with t.start_span("train.step", attrs={"step": 7}):
            raise ValueError("boom")
    root.end()
    root.end("error")  # idempotent: the first record stays
    return t


def _records(spans):
    out = []
    for s in spans:
        d = s.to_dict()
        for k in TIMES:
            d.pop(k)
        d["events"] = [{k: v for k, v in e.items() if k != "time"}
                       for e in d["events"]]
        out.append(d)
    return out


def test_same_seed_same_ids_and_records_as_jax(tmp_path):
    ours = _drive(trace, trace.JsonlSink(tmp_path / "port.jsonl"))
    theirs = _drive(jtrace, jtrace.JsonlSink(tmp_path / "jax.jsonl"))
    assert _records(ours.finished_spans()) == _records(
        theirs.finished_spans())
    names = [s.name for s in ours.finished_spans()]
    assert names == ["serving.admission", "serving.queue",
                     "breaker.transition", "train.step", "serving.request"]
    port_lines = (tmp_path / "port.jsonl").read_text().splitlines()
    jax_lines = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == 5

    def strip(line):
        d = json.loads(line)
        for k in TIMES:
            d.pop(k)
        for e in d["events"]:
            e.pop("time")
        return d

    assert [strip(x) for x in port_lines] == [strip(x) for x in jax_lines]
    err = next(s for s in ours.finished_spans() if s.name == "train.step")
    assert err.status == "error" and err.attrs["error_type"] == "ValueError"


def test_sink_rotation_matches_jax(tmp_path):
    counts = []
    for mod, name in ((trace, "p"), (jtrace, "j")):
        sink = mod.JsonlSink(tmp_path / f"{name}.jsonl", max_bytes=600)
        t = mod.Tracer(seed=0, sink=sink, clock=lambda: 1.0)
        for i in range(6):
            t.event("e", attrs={"i": i})
        sink.close()
        counts.append((sink.written, sink.rotations))
    assert counts[0] == counts[1] and counts[0][0] == 6 and counts[0][1] > 0
    assert ((tmp_path / "p.jsonl").read_text()
            == (tmp_path / "j.jsonl").read_text())
    assert ((tmp_path / "p.jsonl.1").read_text()
            == (tmp_path / "j.jsonl.1").read_text())


def test_disabled_and_global_tracer():
    off = trace.Tracer(enabled=False)
    assert off.start_span("x") is trace.NOOP_SPAN
    off.event("y")
    assert off.finished_spans() == []
    assert trace.get_tracer().enabled is False  # the default
    mine = trace.Tracer(seed=0)
    prev = trace.set_global_tracer(mine)
    try:
        assert trace.get_tracer() is mine
    finally:
        trace.set_global_tracer(prev)


@pytest.fixture
def tracers():
    """A seeded global tracer installed in each package."""
    ours, theirs = trace.Tracer(seed=5), jtrace.Tracer(seed=5)
    prev = trace.set_global_tracer(ours), jtrace.set_global_tracer(theirs)
    yield ours, theirs
    trace.set_global_tracer(prev[0])
    jtrace.set_global_tracer(prev[1])


def _events(tracer):
    return [(s.name, s.attrs, s.trace_id, s.span_id)
            for s in tracer.finished_spans()]


def test_retry_events_match_jax(tracers):
    for mod in (retry, jretry):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError("transient")
            return "ok"

        policy = mod.RetryPolicy(max_attempts=4, seed=3, sleep=lambda s: None)
        assert mod.retry_call(flaky, policy=policy) == "ok"

        def down():
            raise TimeoutError("down")

        with pytest.raises(Exception):
            mod.retry_call(down, policy=mod.RetryPolicy(
                max_attempts=2, seed=4, sleep=lambda s: None))
    ours, theirs = tracers
    assert _events(ours) == _events(theirs)
    assert [e[0] for e in _events(ours)] == [
        "retry.attempt", "retry.attempt", "retry.attempt", "retry.exhausted"]


def test_breaker_transitions_match_jax(tracers):
    for mod in (breaker, jbreaker):
        now = {"t": 0.0}
        b = mod.CircuitBreaker(failure_threshold=2, reset_timeout=5.0,
                               clock=lambda: now["t"], name="predict")
        b.record_failure()
        b.record_failure()  # -> open
        now["t"] = 6.0
        assert b.try_acquire()  # -> half-open, one probe
        b.record_success()  # -> closed
    ours, theirs = tracers
    assert _events(ours) == _events(theirs)
    assert [(e[1]["from"], e[1]["to"]) for e in _events(ours)] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "closed")]


def test_checkpoint_spans_carry_the_jax_names(tracers, tmp_path):
    from deeplearning4j_tpu.nn.conf import (
        NeuralNetConfiguration as JNeuralNetConfiguration,
    )
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
    from deeplearning4j_tpu.nn.multilayer import (
        MultiLayerNetwork as JMultiLayerNetwork,
    )
    from deeplearning4j_tpu.resilience.checkpoint import (
        CheckpointManager as JManager,
    )
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )

    jconf = (JNeuralNetConfiguration.Builder().seed(1).list()
             .layer(JDense(n_in=4, n_out=5)).layer(JOutput(n_out=2))
             .build())
    nets = [(MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init(),
        CheckpointManager(tmp_path / "port", device="cpu")),
        (JMultiLayerNetwork(jconf).init(), JManager(tmp_path / "jax"))]
    for net, mgr in nets:
        mgr.save(net)
        mgr.restore_latest()
    ours, theirs = tracers

    def shape(tracer):
        return [(s.name, sorted(s.attrs), s.attrs.get("step"),
                 s.attrs.get("fallbacks"), s.status)
                for s in tracer.finished_spans()]

    assert shape(ours) == shape(theirs)
    assert [s[0] for s in shape(ours)] == ["checkpoint.save",
                                           "checkpoint.restore"]


def test_trainer_fit_and_epoch_spans(tracers):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer

    conf = (NeuralNetConfiguration.Builder().seed(2).list()
            .layer(DenseLayer(n_in=4, n_out=5)).layer(OutputLayer(n_out=2))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.RandomState(0)
    data = [DataSet(rng.randn(4, 4).astype(np.float32),
                    np.eye(2, dtype=np.float32)[rng.randint(0, 2, 4)])
            for _ in range(3)]
    DistributedTrainer(net).fit(data, epochs=2)
    spans = tracers[0].finished_spans()
    fit = [s for s in spans if s.name == "train.fit"]
    epochs = [s for s in spans if s.name == "train.epoch"]
    assert len(fit) == 1 and len(epochs) == 2
    assert fit[0].attrs == {"epochs": 2, "engine": "MultiLayerNetwork",
                            "max_in_flight": 2}
    assert [e.attrs["epoch"] for e in epochs] == [0, 1]
    assert all(e.parent_id == fit[0].span_id
               and e.trace_id == fit[0].trace_id for e in epochs)
    assert all(np.isfinite(e.attrs["score"]) for e in epochs)


def test_server_requests_carry_one_trace_id(tmp_path):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ModelServer

    conf = (NeuralNetConfiguration.Builder().seed(2).list()
            .layer(DenseLayer(n_in=4, n_out=5)).layer(OutputLayer(n_out=2))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    tracer = trace.Tracer(seed=9)
    server = ModelServer(net, device="cpu", tracer=tracer,
                         max_batch_size=8).start()
    try:
        def post(rows):
            body = json.dumps({"features": np.full((rows, 4), 0.5).tolist()})
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/predict",
                data=body.encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200

        threads = [threading.Thread(target=post, args=(i + 1,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        server.stop()
    spans = tracer.finished_spans()
    roots = [s for s in spans if s.name == "serving.request"]
    assert len(roots) == 4
    for root in roots:
        mine = {s.name: s for s in spans if s.trace_id == root.trace_id}
        assert set(mine) == {"serving.request", "serving.admission",
                             "serving.queue", "serving.batch_assembly",
                             "serving.predict"}
        assert all(s.parent_id == root.span_id for n, s in mine.items()
                   if n != "serving.request")
        assert root.attrs["status_code"] == 200
        assert mine["serving.admission"].attrs["outcome"] == "admitted"
        assert mine["serving.predict"].attrs["mode"] == "batched"

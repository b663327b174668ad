"""The port's step profiler (``observability/profiler.py``) and profiler
listener (``optimize/profiler.py``) on the CPU.

- Under one injected clock and the same calls, the port's records and
  ``train.step`` spans equal the JAX package's, field for field (the
  split, the roofline class, the cost-model rates, the trace ids).
- The engines feed it: a record a per-step step (its cost model built
  from the step, MFU against a stated peak), a record a scan chunk, a
  record a megastep chunk; the parts sum to the wall time; an exception
  abandons the open step.
- The cost model's FLOPs of a narrow LeNet step equal the analytic count
  of what the plain path computes, and sit within a stated ratio of the
  JAX package's XLA count (the reason is in the test).
- ``ProfilerListener`` writes a ``torch.profiler`` Chrome trace of its
  iterations and forces the per-step path.
"""

import json

import numpy as np
import pytest

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
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import profiler as jprofiler
from deeplearning4j_tpu.observability import trace as jtrace
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import metrics, profiler, trace
from deeplearning4j_tpu_torch.optimize.profiler import (
    ProfilerListener,
    annotate,
)

B = 8


def _jlenet():
    return (JNeuralNetConfiguration.Builder().seed(7).updater("ADAM")
            .learning_rate(0.01).list()
            .layer(JConv(n_out=4, kernel_size=(5, 5), activation="relu"))
            .layer(JPool(pooling_type="MAX"))
            .layer(JConv(n_out=8, kernel_size=(5, 5), activation="relu"))
            .layer(JPool(pooling_type="MAX"))
            .layer(JDense(n_out=16, activation="relu"))
            .layer(JOutput(n_out=10, loss="MCXENT"))
            .set_input_type(JInputType.convolutional_flat(28, 28, 1))
            .build())


def _lenet():
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        _jlenet().to_dict()), device="cpu").init()


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet((rng.rand(B, 784) * 0.9 + 0.05).astype(np.float32),
                    np.eye(10, dtype=np.float32)[rng.randint(0, 10, B)])
            for _ in range(n)]


class _Recorder:
    def __init__(self):
        self.records = []

    def record(self, **rec):
        self.records.append(rec)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive(metrics_mod, trace_mod, prof_mod):
    """The same calls on either package's profiler, under one clock."""
    clock, rec = _Clock(), _Recorder()
    tracer = trace_mod.Tracer(seed=3, clock=clock)
    prof = prof_mod.StepProfiler(
        registry=metrics_mod.MetricsRegistry(), tracer=tracer, recorder=rec,
        peak=1e12, peak_bw=1e11, clock=clock)
    cost = prof_mod.CostModel("step:8x784:float32", 2.0e9, 4.0e7)
    prof.begin_step(1)
    clock.t += 0.004
    prof.note_input_wait_ms(0.5)
    prof.note_dispatch_ms(0.25)
    prof.note_device_ms(2.0)
    prof.note_listener_ms(0.3)
    clock.t += 0.006
    prof.end_step(score=1.25, grad_norm=0.5, rows=B, cost=cost)
    prof.begin_step(2)
    prof.note_input_wait_ms(9.0)  # input-bound: over a quarter of the wall
    clock.t += 0.01
    prof.end_step(rows=B, cost=prof_mod.CostModel("k", 1e6, 1e6))
    prof.begin_step(18)
    prof.note_device_ms(40.0)  # more than the wall: host clamps at 0
    clock.t += 0.025
    prof.end_step(score=0.75, rows=16 * B, chunk=16)
    prof.begin_step(19)
    prof.abandon_step()
    assert prof.end_step() is None  # unpaired
    spans = [(s.name, s.trace_id, s.span_id, s.parent_id, s.status,
              s.attrs) for s in tracer.finished_spans()]
    return rec.records, spans


def test_records_and_spans_equal_jax_under_one_clock():
    ours = _drive(metrics, trace, profiler)
    theirs = _drive(jmetrics, jtrace, jprofiler)
    assert ours == theirs
    first, second, third = ours[0]
    assert first["wall_ms"] == 10.0 and first["host_ms"] == 7.25
    assert first["mfu"] == 0.2 and first["roofline"] == "compute_bound"
    assert second["roofline"] == "input_bound"
    assert third["host_ms"] == 0.0 and third["chunk"] == 16
    assert ours[1][-1][4] == "error"  # the abandoned step's span


@pytest.fixture
def active():
    reg = metrics.MetricsRegistry()
    rec = _Recorder()
    prof = profiler.StepProfiler(registry=reg, recorder=rec, peak=1e12,
                                 peak_bw=1e11)
    prev = profiler.set_active_profiler(prof)
    yield prof, rec, reg
    profiler.set_active_profiler(prev)


def _sums_to_wall(rec):
    parts = (rec["input_stall_ms"] + rec["host_ms"] + rec["dispatch_ms"]
             + rec["device_ms"])
    assert abs(parts - rec["wall_ms"]) <= 0.01 * rec["wall_ms"] + 1e-3


def test_per_step_fit_records_each_step_with_its_cost(active):
    prof, rec, reg = active
    net = _lenet()
    net.scan_chunk = 1
    net.fit(_batches(3))
    assert [r["step"] for r in rec.records] == [1, 2, 3]
    for r in rec.records:
        _sums_to_wall(r)
        assert r["rows"] == B and r["cost_key"].startswith("step:8x784:")
        assert 0.0 < r["mfu"] <= 1.0
    assert reg.get("training_device_ms")._default().count == 3
    assert 0.0 < reg.get("step_mfu")._default().value <= 1.0
    assert len(prof.costs.snapshot()) == 1  # built once for the shape


def test_scan_and_megastep_record_a_chunk(active):
    _, rec, _ = active
    net = _lenet()
    net.fit(_batches(5))  # the scan: one chunk of 5
    assert len(rec.records) == 1
    assert rec.records[0]["step"] == 5 and rec.records[0]["rows"] == 5 * B
    net.fit(_batches(4), megastep=2)
    assert [(r["step"], r.get("chunk")) for r in rec.records[1:]] == [
        (7, 2), (9, 2)]
    for r in rec.records:
        _sums_to_wall(r)


def test_an_exception_abandons_the_open_step(active):
    prof, rec, _ = active
    tracer = trace.Tracer(seed=1)
    prof.tracer = tracer
    net = _lenet()
    net.scan_chunk = 1
    bad = DataSet(np.ones((B, 783), np.float32), _batches(1)[0].labels)
    with pytest.raises(Exception):
        net.fit([_batches(1)[0], bad])
    assert len(rec.records) == 1 and prof._state is None
    assert [s.status for s in tracer.finished_spans()
            if s.name == "train.step"] == ["ok", "error"]


def _analytic_flops(b):
    """What the plain path computes in one step of the narrow LeNet:
    each conv's forward, its f32 recompute in the backward and its dW,
    and dx for the second conv (the first has no input gradient); the
    dense kernel's forward, recompute, dW and dx; the output layer's
    product, dW and dx. Two FLOPs a multiply-add."""
    conv1 = b * 4 * 24 * 24 * 1 * 25
    conv2 = b * 8 * 8 * 8 * 4 * 25
    dense = b * 128 * 16
    out = b * 16 * 10
    return 2 * (3 * conv1 + 4 * conv2 + 4 * dense + 3 * out)


def test_cost_model_flops_are_the_analytic_count():
    net = _lenet()
    ds = _batches(1)[0]
    cost = profiler.train_step_cost(net, ds)
    assert cost["flops"] == _analytic_flops(B)
    assert cost["batch"] == B
    # bytes: params, gradients and Adam's two moments read and written,
    # each layer's activation written and read, the inputs read once
    p = sum(t.numel() * 4 for lp in net.params.values() for t in lp.values())
    acts = 4 * B * (4 * 24 * 24 + 4 * 12 * 12 + 8 * 8 * 8 + 8 * 4 * 4
                    + 16 + 10)
    assert cost["bytes_accessed"] == 2 * p + 2 * p + 2 * 2 * p + 2 * acts \
        + ds.features.nbytes + ds.labels.nbytes
    model = profiler.train_step_cost_model(net, ds)
    assert model.key == "step:8x784:float32"
    assert model.flops == cost["flops"]


def test_cost_model_flops_against_jax_xla_count():
    """JAX's count is XLA's ``cost_analysis`` of its compiled step: no
    recompute (its conv and dense backward reuse the forward's
    activations, where the port's kernels recompute the f32 accumulator:
    +1 pass a conv and dense layer) but every elementwise operation
    (activations, the loss, Adam), which ``FlopCounterMode`` does not
    count. So the port's count is above XLA's by about the recompute
    share: held within [1.0, 1.5]."""
    from deeplearning4j_tpu.util.flops import train_step_cost as jcost

    jnet = JMultiLayerNetwork(_jlenet()).init()
    ds = _batches(1)[0]
    from deeplearning4j_tpu.datasets import DataSet as JDataSet

    theirs = jcost(jnet, JDataSet(ds.features, ds.labels))["flops"]
    ratio = profiler.train_step_cost(_lenet(), ds)["flops"] / theirs
    assert 1.0 <= ratio <= 1.5, ratio


def test_profiler_listener_writes_a_trace_and_forces_per_step(tmp_path):
    tracer = trace.Tracer(seed=2)
    prev = trace.set_global_tracer(tracer)
    try:
        net = _lenet()
        listener = ProfilerListener(str(tmp_path / "prof"), 2, 2)
        net.add_listener(listener)
        assert not net._can_scan_steps()
        with annotate("data"):
            data = _batches(5)
        net.fit(data)
    finally:
        trace.set_global_tracer(prev)
    assert listener.trace_path is not None and not listener._active
    doc = json.loads(open(listener.trace_path).read())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert [s.name for s in tracer.finished_spans()] == [
        "profiler.trace_ready"]
    with pytest.raises(ValueError):
        ProfilerListener("/proc/not-a-dir/x")

"""Step telemetry on the CPU: ``TelemetryListener`` and the engines' and
trainer's ``enable_step_telemetry`` (``observability/runtime.py``).

- The listener turns the model's step telemetry on at its first
  callback; the gradient norm the step returns (computed with the step,
  on the device) is within ``kernel_tols()`` of the JAX package's for
  the same weights and batches, and so are the loss gauges; the counters
  and the step-time summary count as JAX's do.
- The norm inside a megastep chunk (one more output of the captured
  function) is bitwise the per-step loop's, and the trajectory with
  telemetry on is bitwise the one with it off.
- The distributed trainer's step returns the same norm as the engine's.
- Without a card the device-memory gauges stay absent.
"""

import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import runtime as jruntime
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability import metrics, runtime
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

B = 8


def _jconf():
    return (JNeuralNetConfiguration.Builder().seed(4).updater("NESTEROVS")
            .learning_rate(0.1).list()
            .layer(JDense(n_in=6, n_out=12, activation="tanh"))
            .layer(JDense(n_out=8, activation="sigmoid"))
            .layer(JOutput(n_out=3, loss="MCXENT"))
            .build())


def _pair():
    jnet = JMultiLayerNetwork(_jconf()).init()
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        _jconf().to_dict()), device="cpu").init(
            params=params_from_numpy(flat, "cpu"))
    return jnet, net


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet(rng.randn(B, 6).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)])
            for _ in range(n)]


def test_listener_norm_and_counters_match_jax():
    jnet, net = _pair()
    ours = runtime.TelemetryListener(registry=metrics.MetricsRegistry(),
                                     defer_reads=False)
    theirs = jruntime.TelemetryListener(
        registry=jmetrics.MetricsRegistry(), defer_reads=False)
    net.add_listener(ours)
    jnet.listeners.append(theirs)
    rtol, atol = kernel_tols()
    norms = []
    for ds in _batches(4):
        net.fit(ds)
        jnet.fit(JDataSet(ds.features, ds.labels))
        if jnet._last_grad_norm is not None:
            np.testing.assert_allclose(float(net._last_grad_norm),
                                       float(jnet._last_grad_norm),
                                       rtol=rtol, atol=atol)
            norms.append(float(net._last_grad_norm))
    assert len(norms) == 3  # the first step ran before the listener's call
    assert net._telemetry_grad_norm and jnet._telemetry_grad_norm
    for name in ("training_grad_global_norm", "training_loss"):
        np.testing.assert_allclose(
            ours.registry.get(name)._default().value,
            theirs.registry.get(name)._default().value, rtol=rtol, atol=atol)
    for name in ("training_steps_total", "training_examples_total"):
        assert (ours.registry.get(name)._default().value
                == theirs.registry.get(name)._default().value)
    assert ours.registry.get("training_steps_total")._default().value == 4
    assert (ours.registry.get("training_step_ms")._default().count
            == theirs.registry.get("training_step_ms")._default().count == 3)


def test_deferred_reads_publish_one_sample_late():
    _, net = _pair()
    listener = runtime.TelemetryListener(registry=metrics.MetricsRegistry())
    net.add_listener(listener)
    norms = []
    for ds in _batches(3):
        net.fit_minibatch(ds)
        norms.append(net._last_grad_norm)
    gauge = listener.registry.get("training_grad_global_norm")._default()
    assert gauge.value == float(norms[1])  # step 3's waits
    listener.flush()  # as at an epoch's end
    assert gauge.value == float(norms[2])


def _trees(net):
    return [t.detach().numpy().copy()
            for tree in (net.params, net.updater_state)
            for lp in tree.values() for v in lp.values()
            for t in (v if isinstance(v, tuple) else (v,))]


class _Norms:
    supports_batched_iterations = True

    def __init__(self):
        self.norms = []

    def iteration_done(self, model, iteration):
        self.norms.append(model._last_grad_norm)


class _ChunkNorms(_Norms):
    def chunk_done(self, model, it0, k, host):
        self.norms.extend(float(v) for v in host["grad_norms"])


def test_megastep_chunk_norms_are_the_per_step_norms():
    _, plain = _pair()
    nets = [MultiLayerNetwork(plain.conf, device="cpu").init(
        params=plain.params) for _ in range(2)]
    seen = [_Norms(), _ChunkNorms()]
    for net, listener in zip(nets, seen):
        net.scan_chunk = 1
        net.enable_step_telemetry()
        net.add_listener(listener)
    data = _batches(6)
    nets[0].fit(data)
    nets[1].fit(data, megastep=3)
    per_step = [float(v) for v in seen[0].norms]
    assert per_step == seen[1].norms and len(per_step) == 6
    plain.scan_chunk = 1
    plain.fit(data)  # telemetry off: the same trajectory
    for a, b in zip(_trees(plain), _trees(nets[1])):
        np.testing.assert_array_equal(a, b)


def test_trainer_step_returns_the_engine_s_norm():
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer

    _, a = _pair()
    b = MultiLayerNetwork(a.conf, device="cpu").init(params=a.params)
    a.scan_chunk = 1
    a.enable_step_telemetry()
    trainer = DistributedTrainer(b)
    trainer.enable_step_telemetry()
    for ds in _batches(3):
        a.fit(ds)
        trainer.fit_minibatch(ds)
        assert float(a._last_grad_norm) == float(b._last_grad_norm)
    trainer.enable_step_telemetry(False)
    assert not b._telemetry_grad_norm


def test_no_card_no_memory_gauges():
    reg = metrics.MetricsRegistry()
    assert runtime.device_memory_stats() == {}
    assert runtime.publish_device_memory(reg) == {}
    assert reg.get("jax_device_memory_bytes_in_use") is None


@pytest.mark.parametrize("enabled", [True, False])
def test_a_disabled_registry_publishes_nothing(enabled):
    _, net = _pair()
    reg = metrics.MetricsRegistry(enabled=enabled)
    net.add_listener(runtime.TelemetryListener(registry=reg))
    net.fit(_batches(2))
    assert net._telemetry_grad_norm is enabled
    assert (reg.get("training_steps_total")._default().value
            == (2 if enabled else 0))

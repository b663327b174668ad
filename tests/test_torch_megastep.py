"""``megastep``: K optimizer steps a chunk with one readback, on the CPU.

``fit(megastep=K)`` / ``set_transforms(megastep=K)`` changes how many
steps a dispatch covers (on the card one CUDA-graph replay a chunk; here
the same chunk function runs eagerly) and never what is trained. Held
bitwise against the port's own per-step loop, parameters, updater state
and layer state: both engines with a partial tail, several epochs and a
reset of the knob, ``grad_accum``, dropout (the chunk derives its keys
from a device tensor, the per-step loop on the host), Adam's
step-dependent bias correction, a bias learning rate and a learning-rate
schedule (read from the chunk's table), BatchNormalization's running
statistics, and a SKIP divergence guard with a poisoned minibatch
inside a chunk. Also: exactly one ``megastep_readback`` a chunk, the
refusals (truncated BPTT, recurrent models) running per step, and the
port's megastep against the JAX package's on ``tests/test_megastep.py``'s
models (``kernel_tols()``: the same math summed in other orders).
"""

import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.api import ListDataSetIterator as JList
from deeplearning4j_tpu.nn import core as jcore
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    InputType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    GravesLSTM,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience.guard import DivergenceGuard
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy


def _mlp_conf(updater="ADAM", lr=0.05, dropout=0.0, bias_lr=None,
              lr_policy="None", seed=7):
    return (NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
            .updater(updater).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh",
                              dropout=dropout, bias_learning_rate=bias_lr,
                              lr_policy=lr_policy, lr_policy_decay_rate=0.9))
            .layer(OutputLayer(n_out=3, dropout=dropout, drop_connect=True))
            .build())


def _mlp(**kw):
    return MultiLayerNetwork(_mlp_conf(**kw), device="cpu").init()


def _graph_conf(seed=9, lr=0.05, dropout=0.0):
    b = (NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
         .updater("ADAM").graph_builder().add_inputs("in"))
    b.add_layer("d0", DenseLayer(n_in=4, n_out=8, activation="tanh",
                                 dropout=dropout), "in")
    b.add_layer("out", OutputLayer(n_in=8, n_out=3), "d0")
    b.set_outputs("out")
    return b.build()


def _graph(**kw):
    return ComputationGraph(_graph_conf(**kw), device="cpu").init()


def _batches(rng, n, batch=8, width=4, classes=3):
    return [DataSet(rng.randn(batch, width).astype(np.float32),
                    np.eye(classes, dtype=np.float32)[
                        rng.randint(0, classes, batch)])
            for _ in range(n)]


def _trees(net):
    out = {}
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            out[f"p:{ln}/{pn}"] = t.detach().numpy().copy()
    for ln, lp in net.updater_state.items():
        for pn, tup in lp.items():
            for i, t in enumerate(tup):
                out[f"u:{ln}/{pn}/{i}"] = t.detach().numpy().copy()
    for ln, st in net.state.items():
        for k, t in st.items():
            out[f"s:{ln}/{k}"] = t.detach().numpy().copy()
    return out


def _assert_bitwise(ref, mega):
    a, b = _trees(ref), _trees(mega)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ref.iteration_count == mega.iteration_count


def _per_step(net, data, epochs=1):
    for _ in range(epochs):
        for ds in data:
            net.fit_minibatch(ds)
    return net


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def readbacks(monkeypatch):
    calls = []
    real = core.megastep_readback

    def counted(*a, **kw):
        calls.append(a[0].k)
        return real(*a, **kw)

    monkeypatch.setattr(core, "megastep_readback", counted)
    return calls


# -- bitwise against the per-step loop ---------------------------------------


@pytest.mark.parametrize("make", [_mlp, _graph], ids=["mlp", "graph"])
def test_megastep_bitwise_with_partial_tail(rng, make, readbacks):
    """K=3 over 10 minibatches: three chunks and a one-minibatch tail
    run per step; the mixed trajectory equals the per-step loop."""
    data = _batches(rng, 10)
    ref = _per_step(make(), data)
    mega = make()
    assert mega.set_transforms(megastep=3) is mega
    assert core.can_megastep(mega)
    mega.fit(ListDataSetIterator(data))
    _assert_bitwise(ref, mega)
    assert readbacks == [3, 3, 3]
    assert mega.score_value == pytest.approx(ref.score_value, abs=0)


def test_megastep_multi_epoch_and_knob_reset(rng, readbacks):
    data = _batches(rng, 6)
    ref = _per_step(_mlp(), data, epochs=3)
    mega = _mlp()
    mega.fit(ListDataSetIterator(data), epochs=2, megastep=2)
    assert mega.epoch_count == 2 and len(readbacks) == 6
    mega.fit(ListDataSetIterator(data), megastep=1)
    assert not core.can_megastep(mega) and len(readbacks) == 6
    _assert_bitwise(ref, mega)


def test_megastep_composes_with_grad_accum(rng):
    data = _batches(rng, 6)
    ref = _mlp()
    ref.fit(ListDataSetIterator(data), grad_accum=2)
    mega = _mlp()
    mega.fit(ListDataSetIterator(data), grad_accum=2, megastep=3)
    _assert_bitwise(ref, mega)


@pytest.mark.parametrize("make", [_mlp, _graph], ids=["mlp", "graph"])
def test_megastep_with_dropout_draws_the_per_step_masks(rng, make):
    """The chunk's keys come from a device tensor (``fold_in(key(seed),
    it0 + i)``), the per-step loop's from the host: the same masks."""
    data = _batches(rng, 8)
    ref = _per_step(make(dropout=0.5), data)
    mega = make(dropout=0.5)
    mega.fit(ListDataSetIterator(data), megastep=4)
    _assert_bitwise(ref, mega)
    # and the masks matter: without them the trajectory differs
    plain = _per_step(make(), data)
    assert not np.array_equal(_trees(plain)["p:" + next(iter(
        plain.params)) + "/W"], _trees(mega)["p:" + next(iter(
            mega.params)) + "/W"])


@pytest.mark.parametrize("kw", [dict(updater="NESTEROVS", lr=0.1),
                                dict(updater="SGD", bias_lr=0.3),
                                dict(updater="ADAM", lr_policy="Exponential"),
                                dict(updater="RMSPROP", lr=0.01)],
                         ids=["nesterovs", "bias_lr", "schedule", "rmsprop"])
def test_megastep_reads_its_rates_and_step_counts_bitwise(rng, kw):
    data = _batches(rng, 7)
    ref = _per_step(_mlp(**kw), data)
    mega = _mlp(**kw)
    mega.fit(ListDataSetIterator(data), megastep=3)
    _assert_bitwise(ref, mega)


def _bn_conv_conf():
    return (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.05)
            .updater("NESTEROVS").list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(SubsamplingLayer(pooling_type="MAX"))
            .layer(DenseLayer(n_out=8, activation="relu", dropout=0.3))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(8, 8, 2))
            .build())


def test_megastep_carries_conv_and_batchnorm_state_and_uint8_pixels(rng):
    data = [DataSet(rng.randint(0, 256, (6, 2, 8, 8)).astype(np.uint8),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, 6)])
            for _ in range(4)]
    ref = _per_step(MultiLayerNetwork(_bn_conv_conf(), device="cpu").init(),
                    data)
    mega = MultiLayerNetwork(_bn_conv_conf(), device="cpu").init()
    mega.fit(data, megastep=2)
    _assert_bitwise(ref, mega)


def _poisoned(ds):
    bad = ds.features.copy()
    bad[0, 0] = np.nan
    return DataSet(bad, ds.labels)


def test_megastep_skip_guard_parity(rng, readbacks):
    """A NaN step inside a chunk: the select on the device suppresses
    its update, the fan-out after the readback books the skip; the
    same trees and the same skipped step as the per-step guarded loop."""
    data = _batches(rng, 6)
    data[2] = _poisoned(data[2])
    ref = _mlp()
    ref.set_divergence_guard(DivergenceGuard(policy="skip"))
    _per_step(ref, data)
    mega = _mlp()
    mega.set_divergence_guard(DivergenceGuard(policy="skip"))
    mega.fit(ListDataSetIterator(data), megastep=3)
    assert readbacks == [3, 3]
    _assert_bitwise(ref, mega)
    assert mega.divergence_guard.skipped_steps == 1
    assert (mega.divergence_guard.skipped_batches
            == ref.divergence_guard.skipped_batches == [2])


def test_megastep_readback_holds_the_chunk_metrics(rng):
    data = _batches(rng, 3)
    ref = _mlp()
    scores = [float(ref.fit_minibatch(ds)) for ds in data]
    mega = _mlp()
    mega.set_divergence_guard(DivergenceGuard(policy="skip"))
    host = core.run_megastep_chunk(mega, mega._stack_chunk(data))
    np.testing.assert_array_equal(host["scores"], np.float32(scores))
    assert host["loss_sum"] == pytest.approx(sum(scores), rel=1e-6)
    assert host["examples"] == 24 and host["guard_trips"] == 0
    assert host["oks"].tolist() == [True] * 3


# -- what runs per step ---------------------------------------------------------


def test_megastep_refuses_tbptt_and_recurrent_models_to_per_step(rng,
                                                                  readbacks):
    conf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
            .updater("SGD").list()
            .layer(GravesLSTM(n_in=3, n_out=4, peephole=False))
            .layer(RnnOutputLayer(n_out=3))
            .build())
    data = [DataSet(rng.rand(2, 3, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 4))]
                    .transpose(0, 2, 1).copy()) for _ in range(4)]
    ref = _per_step(MultiLayerNetwork(conf, device="cpu").init(), data)
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.set_transforms(megastep=2)
    assert core.megastep_active(net) and not core.can_megastep(net)
    net.fit(data)
    _assert_bitwise(ref, net)
    tbptt = MultiLayerConfiguration.from_dict(
        dict(_mlp_conf().to_dict(), backprop_type="TruncatedBPTT"))
    tnet = MultiLayerNetwork(tbptt, device="cpu").init()
    tnet.set_transforms(megastep=2)
    assert not core.can_megastep(tnet)
    assert readbacks == []


def test_signature_change_flushes_the_block_per_step(rng, readbacks):
    """Minibatches of another shape cut the block: the short block runs
    per step (the trajectory is unchanged)."""
    data = _batches(rng, 2) + _batches(rng, 1, batch=5) + _batches(rng, 3)
    ref = _per_step(_mlp(), data)
    mega = _mlp()
    mega.fit(data, megastep=3)
    _assert_bitwise(ref, mega)
    assert readbacks == [3]


# -- against the JAX package's megastep --------------------------------------


def _jmlp():
    conf = (JNeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
            .updater("ADAM").list()
            .layer(JDense(n_in=4, n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3)).build())
    return JMultiLayerNetwork(conf).init()


def _jgraph():
    b = (JNeuralNetConfiguration.Builder().seed(9).learning_rate(0.05)
         .updater("ADAM").graph_builder().add_inputs("in"))
    b.add_layer("d0", JDense(n_in=4, n_out=8, activation="tanh"), "in")
    b.add_layer("out", JOutput(n_in=8, n_out=3), "d0")
    b.set_outputs("out")
    return JGraph(b.build()).init()


@pytest.mark.parametrize("engine", ["mlp", "graph"])
def test_port_megastep_matches_jax_megastep(rng, engine):
    jnet = _jmlp() if engine == "mlp" else _jgraph()
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    if engine == "mlp":
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            jnet.conf.to_dict()), device="cpu")
    else:
        net = ComputationGraph(ComputationGraphConfiguration.from_dict(
            jnet.conf.to_dict()), device="cpu")
    net.init(params=params_from_numpy(flat, "cpu"))
    data = _batches(rng, 7)
    jcore.set_transforms(jnet, megastep=3)
    jnet.fit(JList([JDataSet(features=d.features, labels=d.labels)
                    for d in data]))
    net.fit(data, megastep=3)
    rtol, atol = kernel_tols()
    for ln, lp in jnet.params.items():
        for pn, a in lp.items():
            np.testing.assert_allclose(net.params[ln][pn].numpy(),
                                       np.asarray(a), rtol=rtol, atol=atol,
                                       err_msg=f"{ln}/{pn}")
    assert net.iteration_count == jnet.iteration_count == 7
    np.testing.assert_allclose(net.score_value, float(jnet.score_value),
                               rtol=rtol, atol=atol)


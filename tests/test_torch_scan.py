"""The scan path on the CPU: ``scan_chunk`` minibatches a chunk of the
bare step (``core.fit_epoch_scan``), the device-cached epochs
(``core.fit_epochs_device_cached``) and the fused truncated-BPTT scan
(``MultiLayerNetwork._run_tbptt_stacked``), on both engines.

- The port's default ``scan_chunk = 16`` is bitwise its ``scan_chunk =
  1`` (the per-step loop): parameters, updater state, layer state
  (BatchNormalization's running statistics) and the iteration count,
  streamed and device-cached, and for the char-RNN the carry a
  minibatch ends with.
- Which path runs: the cached plan over several epochs of a list, the
  scan epoch over one epoch or an iterator, the stream when the data
  exceeds ``device_cache_bytes``; a guard, loss scaling or a listener
  without ``supports_batched_iterations`` forces the per-step loop, as in
  the JAX package; a ``ChunkedDataSet`` is one chunk.
- Against the JAX package's own defaults (its scan, cached and fused
  TBPTT paths, ``scan_chunk`` 16), on data with no exact-zero
  pre-activation, with NESTEROVS: ``kernel_tols()`` (the same sums in
  other orders).

Narrow models: a LeNet at 4 / 8 channels, a graph with a
BatchNormalization vertex, the char-RNN at vocab 12, hidden 16, TBPTT
5, T 20, batch 4.
"""

import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn import core as jcore
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import BatchNormalization as JBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.resilience.guard import DivergenceGuard
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

VOCAB, HIDDEN, TBPTT, T, BATCH = 12, 16, 5, 20, 4


def _jlenet(updater="NESTEROVS", lr=0.01):
    return (JNeuralNetConfiguration.Builder().seed(7).updater(updater)
            .learning_rate(lr).list()
            .layer(JConv(n_out=4, kernel_size=(5, 5), activation="relu"))
            .layer(JPool(pooling_type="MAX"))
            .layer(JConv(n_out=8, kernel_size=(5, 5), activation="relu"))
            .layer(JPool(pooling_type="MAX"))
            .layer(JDense(n_out=16, activation="relu"))
            .layer(JOutput(n_out=10, loss="MCXENT"))
            .set_input_type(JInputType.convolutional_flat(28, 28, 1))
            .build())


def _jgraph(updater="NESTEROVS", lr=0.05):
    b = (JNeuralNetConfiguration.Builder().seed(11).updater(updater)
         .learning_rate(lr).graph_builder().add_inputs("in"))
    b.add_layer("d0", JDense(n_in=6, n_out=8, activation="identity"), "in")
    b.add_layer("bn", JBN(n_out=8, activation="tanh"), "d0")
    b.add_layer("out", JOutput(n_in=8, n_out=3, loss="MCXENT"), "bn")
    b.set_outputs("out")
    return b.build()


def _jchar(peephole: bool, updater="NESTEROVS", lr=0.1):
    return (JNeuralNetConfiguration.Builder().seed(42).learning_rate(lr)
            .updater(updater).list()
            .layer(JGravesLSTM(n_in=VOCAB, n_out=HIDDEN, peephole=peephole))
            .layer(JGravesLSTM(n_in=HIDDEN, n_out=HIDDEN, peephole=peephole))
            .layer(JRnnOutput(n_out=VOCAB, loss="MCXENT"))
            .backprop_type("TruncatedBPTT").t_bptt_forward_length(TBPTT)
            .t_bptt_backward_length(TBPTT).build())


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _pair(jconf, graph=False):
    """The JAX network and the port's twin on its initial weights."""
    if graph:
        jnet = JGraph(jconf).init()
        conf = ComputationGraphConfiguration.from_dict(jconf.to_dict())
        net = ComputationGraph(conf, device="cpu")
    else:
        jnet = JMultiLayerNetwork(jconf).init()
        conf = MultiLayerConfiguration.from_dict(jconf.to_dict())
        net = MultiLayerNetwork(conf, device="cpu")
    return jnet, net.init(params=params_from_numpy(_flat(jnet.params), "cpu"))


def _port(jconf, graph=False):
    """The port's network of a JAX configuration, on its own seeded
    weights (no JAX network built)."""
    if graph:
        conf = ComputationGraphConfiguration.from_dict(jconf.to_dict())
        return ComputationGraph(conf, device="cpu").init()
    conf = MultiLayerConfiguration.from_dict(jconf.to_dict())
    return MultiLayerNetwork(conf, device="cpu").init()


def _twin(net, scan_chunk):
    """A second port network on ``net``'s weights, at ``scan_chunk``."""
    other = type(net)(net.conf, device="cpu").init(params=net.params)
    other.scan_chunk = scan_chunk
    return other


def _lenet_batches(n, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet((rng.rand(batch, 784) * 0.9 + 0.05).astype(np.float32),
                    np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)])
            for _ in range(n)]


def _graph_batches(n, batch=8, seed=1):
    rng = np.random.RandomState(seed)
    return [DataSet(rng.randn(batch, 6).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n)]


def _char_batches(n, seed=2):
    rng = np.random.RandomState(seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.randint(0, VOCAB, (BATCH, T + 1))
        out.append(DataSet(
            np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
            np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))))
    return out


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


def _assert_bitwise(ref, got):
    a, b = _trees(ref), _trees(got)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ref.iteration_count == got.iteration_count
    assert ref.epoch_count == got.epoch_count


@pytest.fixture
def paths(monkeypatch):
    """Counts of the scan chunks, the cached replays, the fused TBPTT
    chunks and the per-step steps the fits take."""
    n = {"chunk": 0, "cached": 0, "tbptt": 0, "step": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if name != "cached" or out:
                n[name] += 1
            return out
        return wrapped

    monkeypatch.setattr(core, "run_scan_chunk",
                        spy("chunk", core.run_scan_chunk))
    monkeypatch.setattr(core, "fit_epochs_device_cached",
                        spy("cached", core.fit_epochs_device_cached))
    monkeypatch.setattr(core, "run_step", spy("step", core.run_step))
    monkeypatch.setattr(
        MultiLayerNetwork, "_run_tbptt_stacked",
        spy("tbptt", MultiLayerNetwork._run_tbptt_stacked))
    return n


@pytest.mark.parametrize("engine,epochs,chunks", [
    ("multilayer", 1, 2), ("multilayer", 3, 6),
    ("graph", 1, 2), ("graph", 3, 6)])
def test_scan_is_bitwise_the_per_step_loop(paths, engine, epochs, chunks):
    """5 minibatches at scan_chunk 3: a chunk of 3 and one of 2 an epoch
    (the cached plan over several epochs, the scan epoch over one)."""
    if engine == "graph":
        net, data = _port(_jgraph(), graph=True), _graph_batches(5)
    else:
        net, data = _port(_jlenet()), _lenet_batches(5, batch=4)
    ref = _twin(net, 1)
    ref.fit(data, epochs=epochs)
    assert paths["chunk"] == 0 and paths["step"] == 5 * epochs
    net.scan_chunk = 3
    net.fit(data, epochs=epochs)
    assert paths["chunk"] == chunks
    assert paths["cached"] == (1 if epochs > 1 else 0)
    assert paths["step"] == 5 * epochs  # none more
    _assert_bitwise(ref, net)
    assert float(ref.score_value) == float(net.score_value)


def test_default_scan_chunk_is_jax_s_and_a_list_stays_cached(paths):
    net = _port(_jlenet())
    assert net.scan_chunk == 16
    assert net.device_cache_bytes == 4 << 30  # the CPU: JAX's fallback
    data = _lenet_batches(3, batch=4)
    ref = _twin(net, 1)
    ref.fit(ListDataSetIterator(data), epochs=2)
    net.fit(data, epochs=2)
    assert paths == {"chunk": 2, "cached": 1, "tbptt": 0, "step": 6}
    _assert_bitwise(ref, net)


def test_the_cached_plan_balances_its_chunks():
    """7 same-shaped minibatches at scan_chunk 3 make 3 + 2 + 2 (JAX's
    plan, as the streamed epoch, 3 + 3 + 1: one chunk size more to
    capture); a change of shapes cuts a run; a run of one is single."""
    items = [(4,)] * 7 + [(5,)] * 2 + [(6,)]
    plan = core.build_scan_plan(items, lambda i: i, list, 3)
    assert [len(x) if kind == "chunk" else 1 for kind, x, _ in plan] == [
        3, 2, 2, 2, 1]
    assert [kind for kind, _, _ in plan] == ["chunk"] * 4 + ["single"]


def test_an_iterator_streams_through_the_scan(paths):
    net, data = _port(_jgraph(), graph=True), _graph_batches(4)
    ref = _twin(net, 1)
    ref.fit(data, epochs=2)
    net.fit(ListDataSetIterator(data), epochs=2)
    assert paths["cached"] == 0 and paths["chunk"] == 2
    _assert_bitwise(ref, net)


def test_the_over_budget_plan_streams(paths):
    net, data = _port(_jgraph(), graph=True), _graph_batches(4)
    ref = _twin(net, 1)
    ref.fit(data, epochs=2)
    net.device_cache_bytes = sum(b.features.nbytes + b.labels.nbytes
                                 for b in data) - 1
    assert core.cached_epoch_plan(net, data, 2, lambda ds: (
        ds.features, ds.labels)) is None
    net.fit(data, epochs=2)
    assert paths["cached"] == 0 and paths["chunk"] == 2
    _assert_bitwise(ref, net)


class _Batched(CollectScoresIterationListener):
    supports_batched_iterations = True


@pytest.mark.parametrize("flavour", ["guard", "loss_scale", "listener"])
def test_ineligible_configurations_run_per_step(paths, flavour):
    """As in JAX (``_can_scan_steps``): a divergence guard, loss scaling
    and a listener without ``supports_batched_iterations`` each take the
    per-step loop, bitwise the scan_chunk 1 run's."""
    conf = (NeuralNetConfiguration.Builder().seed(3).updater("SGD")
            .learning_rate(0.1).compute_data_type(
                "float16" if flavour == "loss_scale" else None)
            .list().layer(DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3)).build())
    nets = [MultiLayerNetwork(conf, device="cpu").init() for _ in range(2)]
    nets[0].scan_chunk = 1
    for net in nets:
        if flavour == "guard":
            net.set_divergence_guard(DivergenceGuard("skip"))
        elif flavour == "loss_scale":
            net.set_transforms(loss_scale=True)
        else:
            net.add_listener(CollectScoresIterationListener())
        assert not net._can_scan_steps()
        net.fit(_graph_batches(4), epochs=2)
    assert paths["chunk"] == 0 and paths["cached"] == 0
    assert paths["step"] == 16
    _assert_bitwise(*nets)


def test_a_batched_listener_keeps_the_scan_and_sees_every_step(paths):
    net = _port(_jgraph(), graph=True)
    ref = _twin(net, 1)
    seen = [_Batched(), CollectScoresIterationListener()]
    ref.add_listener(seen[1])
    net.add_listener(seen[0])
    data = _graph_batches(4)
    ref.fit(data, epochs=2)
    net.fit(data, epochs=2)
    assert paths["chunk"] == 2
    _assert_bitwise(ref, net)
    assert seen[0].scores == seen[1].scores  # per step, its own score


@pytest.mark.parametrize("engine", ["multilayer", "graph"])
def test_a_chunked_dataset_is_one_scan_chunk(paths, engine):
    if engine == "graph":
        net, data = _port(_jgraph(), graph=True), _graph_batches(4)
    else:
        net, data = _port(_jlenet()), _lenet_batches(3, batch=4)
    ref = _twin(net, 1)
    ref.fit(data)
    chunk = ChunkedDataSet(np.stack([b.features for b in data]),
                           np.stack([b.labels for b in data]))
    net.fit([chunk])
    assert paths["chunk"] == 1
    _assert_bitwise(ref, net)


@pytest.mark.parametrize("peephole", [True, False])
@pytest.mark.parametrize("epochs", [1, 2])
def test_fused_tbptt_is_bitwise_the_per_chunk_loop(paths, peephole, epochs):
    """5 minibatches of 4 segments: per minibatch one fused chunk when
    streamed; cached over 2 epochs, chunks of up to scan_chunk 3
    minibatches (12 and 8 segments), their resets zeroing the carry at
    each minibatch's first segment. The carry the last minibatch ended
    with is the per-chunk loop's too."""
    net = _port(_jchar(peephole))
    data = _char_batches(5)
    ref = _twin(net, 1)
    ref.fit(data, epochs=epochs)
    assert paths["tbptt"] == 0 and paths["step"] == 20 * epochs
    net.scan_chunk = 3
    net.fit(data, epochs=epochs)
    assert paths["tbptt"] == (5 if epochs == 1 else 4)
    assert paths["cached"] == (1 if epochs > 1 else 0)
    _assert_bitwise(ref, net)
    assert all(st == {} for st in net.state.values())
    for name, carry in ref._tbptt_carry.items():
        assert set(carry) == {"h", "c"}
        for k, t in carry.items():
            assert torch.equal(net._tbptt_carry[name][k], t), (name, k)


def test_fused_tbptt_refusals_take_the_per_chunk_loop(paths):
    """A guard, or segments that do not tile the sequence, keep the
    per-chunk loop (JAX ``_can_fuse_tbptt``)."""
    net = _port(_jchar(False))
    guarded = _twin(net, 16)
    guarded.set_divergence_guard(DivergenceGuard("skip"))
    guarded.fit(_char_batches(2))
    ragged = _char_batches(1)[0]
    net.fit(DataSet(ragged.features[:, :, :17], ragged.labels[:, :, :17]))
    assert paths["tbptt"] == 0
    assert paths["step"] == 8 + 4


def test_grad_accum_runs_in_the_scan_chunk(paths):
    conf = (NeuralNetConfiguration.Builder().seed(5).updater("ADAM")
            .learning_rate(0.05).list()
            .layer(DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    ref = _twin(net, 1)
    data = _graph_batches(3)
    ref.fit(data, epochs=2, grad_accum=2)
    net.fit(data, epochs=2, grad_accum=2)
    assert paths["chunk"] == 2
    _assert_bitwise(ref, net)


def _close(got, ref, err_msg=""):
    rtol, atol = kernel_tols()
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _check_against_jax(net, jnet):
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        _close(net.params[ln][pn], ref, key)
    for ln, lp in jnet.updater_state.items():
        for pn, tup in lp.items():
            for i, ref in enumerate(tup):
                _close(net.updater_state[ln][pn][i], ref, f"{ln}/{pn}/{i}")
    assert net.iteration_count == jnet.iteration_count


@pytest.fixture
def jax_paths(monkeypatch):
    """Counts of the JAX package's scan chunks and cached fits."""
    n = {"chunk": 0, "cached": 0}
    real_chunk, real_cached = (jcore.run_scan_chunk,
                               jcore.fit_epochs_device_cached)

    def chunk(*a, **kw):
        n["chunk"] += 1
        return real_chunk(*a, **kw)

    def cached(*a, **kw):
        out = real_cached(*a, **kw)
        n["cached"] += bool(out)
        return out

    monkeypatch.setattr(jcore, "run_scan_chunk", chunk)
    monkeypatch.setattr(jcore, "fit_epochs_device_cached", cached)
    return n


@pytest.mark.parametrize("engine,epochs", [("multilayer", 2),
                                           ("graph", 2), ("graph", 1)])
def test_scan_and_cached_fits_match_jax(paths, jax_paths, engine, epochs):
    if engine == "graph":
        jnet, net = _pair(_jgraph(), graph=True)
        data = _graph_batches(5)
    else:
        jnet, net = _pair(_jlenet())
        data = _lenet_batches(4, batch=4)
    jnet.fit([JDataSet(b.features, b.labels) for b in data], epochs=epochs)
    net.fit(data, epochs=epochs)
    assert jax_paths["chunk"] == paths["chunk"] == epochs
    assert jax_paths["cached"] == paths["cached"] == (epochs > 1)
    _check_against_jax(net, jnet)
    _close(net.score_value, float(jnet.score_value))
    if engine == "graph":  # the BN vertex's running statistics
        for k, ref in jnet.state["bn"].items():
            _close(net.state["bn"][k], ref, k)


@pytest.mark.parametrize("peephole", [True, False])
def test_fused_tbptt_matches_jax(paths, peephole):
    """Both packages' cached fused-TBPTT plans: 3 minibatches a chunk (12
    segments), 2 epochs."""
    jnet, net = _pair(_jchar(peephole))
    data = _char_batches(3)
    jnet.fit([JDataSet(b.features, b.labels) for b in data], epochs=2)
    net.fit(data, epochs=2)
    assert paths["tbptt"] == 2 and paths["cached"] == 1
    _check_against_jax(net, jnet)
    _close(net.score_value, float(jnet.score_value))

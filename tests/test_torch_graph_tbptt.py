"""``ComputationGraph`` truncated BPTT and ``rnn_time_step`` of the port
against the JAX engine on the CPU (modelled on JAX's
``tests/test_graph.py`` ``test_graph_rnn_time_step_matches_full_forward``
and ``test_graph_tbptt_carries_state``), on weights carried across
through ``params_from_numpy``:

- ``rnn_time_step`` one step at a time, and in chunks, equal to JAX's
  and to the full forward; the 2-d / 3-d convention over two inputs;
  clearing the state; a bidirectional vertex refused;
- truncated BPTT: a sequence of 12 in segments of 4 (three steps, the
  carry handed on), with a features mask and with an input that has no
  time axis riding along, against JAX's ``_fit_tbptt``; mixed sequence
  lengths refused;
- the char-RNN built as a graph (GravesLSTM x 2, with and without
  peepholes, RMSPROP) against the port's ``MultiLayerNetwork``
  char-RNN on the same weights and data, and against JAX's graph.

Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5) for outputs
and scores; weights after a few steps at rtol 1e-3, atol 1e-5, as
``tests/test_torch_char_rnn.py`` holds the sequential char-RNN against
JAX (RMSPROP divides by a root of the gradient's square: an element at
the noise floor moves by up to lr).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import (
    DuplicateToTimeSeriesVertex as JDup,
)
from deeplearning4j_tpu.nn.conf.graph_conf import MergeVertex as JMerge
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import (
    GravesBidirectionalLSTM as JBiLSTM,
)
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutputLayer
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

W_RTOL, W_ATOL = 1e-3, 1e-5


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, ref, rtol=None, atol=None, err_msg=""):
    krtol, katol = kernel_tols()
    np.testing.assert_allclose(_np(got), np.asarray(ref),
                               rtol=krtol if rtol is None else rtol,
                               atol=katol if atol is None else atol,
                               err_msg=err_msg)


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _pair(jconf):
    jg = JGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    g = ComputationGraph(conf, device="cpu").init(
        params=params_from_numpy(_flat(jg.params), "cpu"))
    return jg, g


def _assert_params_close(g, jg):
    for key, ref in _flat(jg.params).items():
        ln, pn = key.rsplit("/", 1)
        _close(g.params[ln][pn], ref, W_RTOL, W_ATOL, key)


def lstm_graph(tbptt=False, peephole=True, n_in=3, hidden=5, n_out=2,
               seed=11, updater="SGD", lr=0.05):
    b = (JNNC.Builder().seed(seed).learning_rate(lr).updater(updater)
         .graph_builder().add_inputs("in")
         .add_layer("lstm", JGravesLSTM(n_in=n_in, n_out=hidden,
                                        activation="tanh",
                                        peephole=peephole), "in")
         .add_layer("out", JRnnOutputLayer(n_in=hidden, n_out=n_out),
                    "lstm")
         .set_outputs("out"))
    if tbptt:
        b.backprop_type("TruncatedBPTT")
        b.t_bptt_forward_length(4)
        b.t_bptt_backward_length(4)
    return b.build()


def two_input_graph(tbptt=True):
    """A sequence input and a per-example input duplicated along time
    (it rides along each segment whole)."""
    b = (JNNC.Builder().seed(12).learning_rate(0.05).updater("SGD")
         .graph_builder().add_inputs("seq", "static")
         .add_layer("emb", JDense(n_in=2, n_out=3, activation="tanh"),
                    "static")
         .add_vertex("dup", JDup(reference_input="seq"), "emb")
         .add_vertex("cat", JMerge(), "seq", "dup")
         .add_layer("lstm", JGravesLSTM(n_in=6, n_out=5,
                                        activation="tanh"), "cat")
         .add_layer("out", JRnnOutputLayer(n_in=5, n_out=2), "lstm")
         .set_outputs("out"))
    if tbptt:
        b.backprop_type("TruncatedBPTT")
        b.t_bptt_forward_length(4)
        b.t_bptt_backward_length(4)
    return b.build()


def _seq(rng, b=2, n=3, t=12, classes=2):
    x = rng.rand(b, n, t).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[
        rng.randint(0, classes, (b, t))].transpose(0, 2, 1)
    return x, np.ascontiguousarray(y)


# -- rnn_time_step ----------------------------------------------------------


@pytest.mark.parametrize("peephole", [True, False])
def test_rnn_time_step_matches_jax_and_the_full_forward(peephole):
    jg, g = _pair(lstm_graph(peephole=peephole))
    x = np.random.RandomState(0).rand(2, 3, 5).astype(np.float32)
    full = g.output(x)[0]
    _close(full, jg.output(x)[0])
    g.rnn_clear_previous_state()
    jg.rnn_clear_previous_state()
    steps = []
    for t in range(5):
        out = g.rnn_time_step(x[:, :, t])[0]
        assert out.shape == (2, 2)  # a 2-d input gives a 2-d output
        _close(out, jg.rnn_time_step(x[:, :, t])[0], err_msg=str(t))
        steps.append(out)
    _close(torch.stack(steps, dim=2), _np(full))
    assert g._stream_steps == 5
    assert set(g._rnn_state) == {"lstm"}
    # the carry changes the continuation; clearing resets it
    more = g.rnn_time_step(x[:, :, 0])[0]
    g.rnn_clear_previous_state()
    fresh = g.rnn_time_step(x[:, :, 0])[0]
    assert not torch.allclose(more, fresh)
    # a chunk continues the same stream
    g.rnn_clear_previous_state()
    head = g.rnn_time_step(x[:, :, :2])[0]
    tail = g.rnn_time_step(x[:, :, 2:])[0]
    _close(torch.cat([head, tail], dim=2), _np(full))


def test_rnn_time_step_mixed_2d_and_3d_inputs_match_jax():
    """Each 2-d input gets a time axis of its own; the outputs come back
    2-d only when every input arrived 2-d."""
    conf = (JNNC.Builder().seed(13).graph_builder().add_inputs("a", "b")
            .add_vertex("cat", JMerge(), "a", "b")
            .add_layer("lstm", JGravesLSTM(n_in=5, n_out=4,
                                           activation="tanh"), "cat")
            .add_layer("out", JRnnOutputLayer(n_in=4, n_out=2), "lstm")
            .set_outputs("out").build())
    jg, g = _pair(conf)
    rng = np.random.RandomState(1)
    a = rng.rand(2, 3, 3).astype(np.float32)
    b = rng.rand(2, 2, 3).astype(np.float32)
    out = g.rnn_time_step(a[:, :, 0], b[:, :, 0])[0]
    assert out.shape == (2, 2)
    _close(out, jg.rnn_time_step(a[:, :, 0], b[:, :, 0])[0])
    out = g.rnn_time_step(a[:, :, 1:2], b[:, :, 1])[0]
    assert out.shape == (2, 2, 1)
    _close(out, jg.rnn_time_step(a[:, :, 1:2], b[:, :, 1])[0])
    _close(g.rnn_time_step(a[:, :, 2], b[:, :, 2])[0],
           _np(g.output(a, b)[0])[:, :, 2])


def test_rnn_time_step_refuses_a_bidirectional_vertex():
    conf = (JNNC.Builder().seed(1).graph_builder().add_inputs("in")
            .add_layer("bi", JBiLSTM(n_in=3, n_out=4, activation="tanh"),
                       "in")
            .add_layer("out", JRnnOutputLayer(n_in=8, n_out=2), "bi")
            .set_outputs("out").build())
    _, g = _pair(conf)
    with pytest.raises(ValueError, match="rnn_time_step"):
        g.rnn_time_step(np.zeros((1, 3), np.float32))


# -- truncated BPTT ----------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_tbptt_segments_carry_state_and_match_jax(masked):
    jg, g = _pair(lstm_graph(tbptt=True))
    rng = np.random.RandomState(2)
    x, y = _seq(rng)
    fm = None
    if masked:
        fm = np.ones((2, 12), np.float32)
        fm[1, 9:] = 0.0
    mds = MultiDataSet([x], [y], features_masks=None if fm is None else [fm])
    jmds = JMultiDataSet(features=[x], labels=[y],
                         features_masks=None if fm is None else [fm])
    s = g.fit_minibatch(mds)
    js = jg.fit_minibatch(jmds)
    assert g.iteration_count == jg.iteration_count == 3
    _close(s, float(js), 1e-5, 0)
    _assert_params_close(g, jg)
    # the carry is dropped after the minibatch, as in the JAX engine
    assert g.state["lstm"] == {}
    # three carried segments differ from one whole-sequence step
    _, whole = _pair(lstm_graph(tbptt=False))
    whole.fit_minibatch(mds)
    assert not np.allclose(_np(g.params["lstm"]["W"]),
                           _np(whole.params["lstm"]["W"]))
    # and training lowers the score (fit over a list: the per-step loop)
    s0 = g.score(mds)
    g.fit([mds] * 5, epochs=2)
    jg.fit([jmds] * 5, epochs=2)
    assert g.iteration_count == jg.iteration_count == 33
    assert g.score(mds) < s0
    _assert_params_close(g, jg)


def test_tbptt_inputs_without_time_ride_along_and_match_jax():
    jg, g = _pair(two_input_graph())
    rng = np.random.RandomState(3)
    x, y = _seq(rng)
    static = rng.rand(2, 2).astype(np.float32)
    for _ in range(2):
        s = g.fit_minibatch(MultiDataSet([x, static], [y]))
        js = jg.fit_minibatch(JMultiDataSet(features=[x, static],
                                            labels=[y]))
        _close(s, float(js), 1e-5, 0)
    assert g.iteration_count == 6
    _assert_params_close(g, jg)


def test_tbptt_refuses_mixed_sequence_lengths():
    _, g = _pair(lstm_graph(tbptt=True))
    x, _ = _seq(np.random.RandomState(4))
    _, y = _seq(np.random.RandomState(4), t=10)
    with pytest.raises(ValueError, match="one sequence length"):
        g.fit_minibatch(MultiDataSet([x], [y]))


# -- the char-RNN as a graph --------------------------------------------------


def char_rnn_graph(vocab, hidden, peephole, tbptt):
    """The zoo's char-RNN (GravesLSTM x 2, RMSPROP 0.1) as a graph."""
    b = (NeuralNetConfiguration.Builder().seed(42).learning_rate(0.1)
         .updater("RMSPROP").graph_builder().add_inputs("in")
         .add_layer("l0", GravesLSTM(n_in=vocab, n_out=hidden,
                                     activation="tanh", peephole=peephole),
                    "in")
         .add_layer("l1", GravesLSTM(n_in=hidden, n_out=hidden,
                                     activation="tanh", peephole=peephole),
                    "l0")
         .add_layer("out", RnnOutputLayer(n_in=hidden, n_out=vocab,
                                          loss="MCXENT"), "l1")
         .set_outputs("out")
         .backprop_type("TruncatedBPTT").t_bptt_forward_length(tbptt)
         .t_bptt_backward_length(tbptt))
    return b.build()


def char_rnn_list(vocab, hidden, peephole, tbptt):
    b = (NeuralNetConfiguration.Builder().seed(42).learning_rate(0.1)
         .updater("RMSPROP").list())
    n_in = vocab
    for _ in range(2):
        b.layer(GravesLSTM(n_in=n_in, n_out=hidden, activation="tanh",
                           peephole=peephole))
        n_in = hidden
    return (b.layer(RnnOutputLayer(n_out=vocab, loss="MCXENT"))
            .backprop_type("TruncatedBPTT").t_bptt_forward_length(tbptt)
            .t_bptt_backward_length(tbptt).build())


@pytest.mark.parametrize("peephole", [True, False])
def test_char_rnn_graph_matches_the_multilayer_char_rnn_and_jax(peephole):
    vocab, hidden, tbptt, t = 7, 6, 5, 15
    g = ComputationGraph(char_rnn_graph(vocab, hidden, peephole, tbptt),
                         device="cpu").init()
    net = MultiLayerNetwork(char_rnn_list(vocab, hidden, peephole, tbptt),
                            device="cpu")
    net.init(params={str(i): g.params[n]
                     for i, n in enumerate(("l0", "l1", "out"))})
    jg = JGraph(JNNC_graph_from(g)).init()
    jg.params = {n: {k: jnp.asarray(_np(v)) for k, v in lp.items()}
                 for n, lp in g.params.items()}
    jg.updater_state = jg.updater_def.init(jg.params)
    rng = np.random.RandomState(5)
    for _ in range(3):
        ids = rng.randint(0, vocab, (4, t + 1))
        eye = np.eye(vocab, dtype=np.float32)
        x = np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1))
        y = np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))
        sg = g.fit_minibatch(MultiDataSet([x], [y]))
        sn = net.fit_minibatch(DataSet(x, y))
        sj = jg.fit_minibatch(JMultiDataSet(features=[x], labels=[y]))
        _close(sg, _np(sn))
        _close(sg, float(sj), 1e-5, 0)
    assert g.iteration_count == net.iteration_count == 9
    for i, n in enumerate(("l0", "l1", "out")):
        for k, v in g.params[n].items():
            _close(v, _np(net.params[str(i)][k]), err_msg=f"{n}/{k}")
    _assert_params_close(g, jg)
    # sampling: the graph's rnn_time_step is the network's
    g.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    for step in range(4):
        _close(g.rnn_time_step(x[:, :, step])[0],
               _np(net.rnn_time_step(x[:, :, step])), err_msg=str(step))


def JNNC_graph_from(g):
    """The JAX configuration of a port graph (its ``configuration.json``)."""
    from deeplearning4j_tpu.nn.conf.graph_conf import (
        ComputationGraphConfiguration as JConf,
    )

    return JConf.from_json(g.conf.to_json())

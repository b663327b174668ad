"""The char-RNN slice as a whole, against the JAX package on the CPU: a
narrow stacked GravesLSTM (``zoo.graves_lstm_char_rnn``'s layers at
vocab 11, hidden 8), with and without peepholes, its initial weights
carried from the JAX network into the port.

- ``output`` on the same weights;
- ``fit`` under truncated BPTT (segments of 15 steps, chunks of 5: three
  optimizer steps a minibatch) with RMSProp, two minibatches, plain and
  masked: scores, weights and the RMSProp state;
- ``rnn_time_step`` fed one step at a time against ``output``;
- checkpoint zips written by one package restore and resume in the
  other;
- the SURVEY.md corpus builder of ``chip_smoke.py``.

JAX runs its default CPU route (XLA scans); the port's CPU route is the
plain version of each LSTM kernel. Forward tolerances: ``kernel_tols()``
(f32: rtol 2e-4, atol 2e-5). RMSProp divides each gradient by its own
running RMS, ``lr * g / sqrt(0.05 g^2 + 1e-8)`` on the first step, so a
weight moves by about 4.5 lr whatever its gradient's size above ~5e-4,
and by up to 1e4 lr g below it: a gradient at the f32 noise floor (~1e-9,
its last bits set by the summation order) can move a weight by ~1e-5 lr
differently in the two packages, and six such steps compound it. So the
weights and the RMSProp state are held at rtol 1e-3, atol 1e-4 (lr 0.1),
the scores at rtol 1e-4.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    MultiLayerConfiguration as JMultiLayerConfiguration,
)
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu.zoo.models import (
    graves_lstm_char_rnn as jax_char_rnn,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    restore_model,
    write_model,
)
from deeplearning4j_tpu_torch.zoo import graves_lstm_char_rnn

VOCAB, HIDDEN, BATCH, SEG, TBPTT = 11, 8, 3, 15, 5
LR = 0.1
W_RTOL, W_ATOL = 1e-3, 1e-4


def _jconf(peephole: bool):
    """The zoo's char-RNN at narrow widths; without peepholes, the same
    layers with ``peephole=False``."""
    if peephole:
        return jax_char_rnn(vocab=VOCAB, hidden=HIDDEN, tbptt_length=TBPTT,
                            learning_rate=LR)
    return (
        JNeuralNetConfiguration.Builder().seed(42).learning_rate(LR)
        .updater("RMSPROP").list()
        .layer(JGravesLSTM(n_in=VOCAB, n_out=HIDDEN, peephole=False))
        .layer(JGravesLSTM(n_in=HIDDEN, n_out=HIDDEN, peephole=False))
        .layer(JRnnOutput(n_out=VOCAB, loss="MCXENT"))
        .backprop_type("TruncatedBPTT").t_bptt_forward_length(TBPTT)
        .t_bptt_backward_length(TBPTT)
        .build()
    )


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _flat_updater(state):
    return {f"{ln}/{pn}/{i}": np.asarray(a)
            for ln, lp in state.items() for pn, tup in lp.items()
            for i, a in enumerate(tup)}


def _pair(peephole: bool):
    """The JAX network (non-zero peepholes, so their terms train from
    the first step) and the port's twin on its weights."""
    jnet = JMultiLayerNetwork(_jconf(peephole)).init()
    rng = np.random.RandomState(0)
    for lp in jnet.params.values():
        for pn in ("pI", "pF", "pO"):
            if pn in lp:
                lp[pn] = lp[pn] + rng.randn(*lp[pn].shape).astype(
                    np.float32) * 0.3
    conf = MultiLayerConfiguration.from_dict(jnet.conf.to_dict())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _batch(seed, masked=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (BATCH, SEG + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    x = np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1))
    y = np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))
    mask = None
    if masked:
        mask = np.ones((BATCH, SEG), np.float32)
        mask[0, 11:] = 0.0   # the last chunk partly masked
        mask[2, 4:] = 0.0    # masked across a chunk boundary
    return x, y, mask


def _close(got, ref, rtol=None, atol=None, err_msg=""):
    krtol, katol = kernel_tols()
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref),
                               rtol=krtol if rtol is None else rtol,
                               atol=katol if atol is None else atol,
                               err_msg=err_msg)


def _check_trained(net, jnet):
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        _close(net.params[ln][pn], ref, W_RTOL, W_ATOL, key)
    for key, ref in _flat_updater(jnet.updater_state).items():
        ln, pn, i = key.rsplit("/", 2)
        _close(net.updater_state[ln][pn][int(i)], ref, W_RTOL, W_ATOL, key)


def test_zoo_builder_matches_jax():
    conf = graves_lstm_char_rnn(vocab=77, hidden=200, tbptt_length=50)
    jconf = jax_char_rnn(vocab=77, hidden=200, tbptt_length=50)
    assert conf.to_dict() == jconf.to_dict()
    assert all(l.peephole for l in conf.layers[:2])
    assert conf.backprop_type == "TruncatedBPTT"


@pytest.mark.parametrize("peephole", [True, False])
def test_output_matches_jax(peephole):
    jnet, net = _pair(peephole)
    x, _, mask = _batch(1, masked=True)
    dispatch.reset_launch_counts()
    _close(net.output(x), jnet.output(x))
    _close(net.output(x, features_mask=mask),
           jnet.output(x, features_mask=mask))
    assert sum(dispatch.launch_counts().values()) == 0  # the plain route


@pytest.mark.parametrize("peephole,masked", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_tbptt_fit_matches_jax(peephole, masked):
    jnet, net = _pair(peephole)
    for seed in (2, 3):
        x, y, mask = _batch(seed, masked)
        jnet.fit(JDataSet(x, y, features_mask=mask, labels_mask=mask))
        net.fit(DataSet(x, y, features_mask=mask, labels_mask=mask))
        _close(net.score_value, float(jnet.score_value), rtol=1e-4, atol=0)
    assert net.iteration_count == jnet.iteration_count == 6
    # the carry is dropped after each minibatch
    assert all(st == {} for st in net.state.values())
    _check_trained(net, jnet)
    x, _, _ = _batch(4)
    _close(net.output(x), jnet.output(x), 1e-3, 1e-4)


def test_standard_backprop_resets_the_carry_each_iteration():
    jnet, net = _pair(False)
    jconf = jnet.conf.to_dict()
    jconf["backprop_type"] = "Standard"
    jconf["iterations"] = 2
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jconf),
                            device="cpu").init(params=net.params)
    jnet = JMultiLayerNetwork(
        JMultiLayerConfiguration.from_dict(jconf)).init(params=jnet.params)
    x, y, mask = _batch(5, masked=True)
    jnet.fit(JDataSet(x, y, features_mask=mask))
    net.fit(DataSet(x, y, features_mask=mask))
    assert net.iteration_count == jnet.iteration_count == 2
    _close(net.score_value, float(jnet.score_value), rtol=1e-4, atol=0)
    _check_trained(net, jnet)


@pytest.mark.parametrize("peephole", [True, False])
def test_rnn_time_step_matches_output(peephole):
    jnet, net = _pair(peephole)
    x, _, _ = _batch(6)
    full = net.output(x)
    steps = torch.stack([net.rnn_time_step(x[:, :, t])
                         for t in range(SEG)], dim=2)
    _close(steps, full)
    jnet.rnn_clear_previous_state()
    _close(steps[:, :, :3], np.asarray(jnet.rnn_time_step(x[:, :, :3])))
    # clearing the state restarts the stream
    more = net.rnn_time_step(x[:, :, 0])
    net.rnn_clear_previous_state()
    fresh = net.rnn_time_step(x[:, :, 0])
    assert not torch.allclose(more, fresh)
    _close(fresh, full[:, :, 0])


def test_rnn_time_step_refuses_bidirectional():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        GravesBidirectionalLSTM,
        RnnOutputLayer,
    )

    conf = (NeuralNetConfiguration.Builder().list()
            .layer(GravesBidirectionalLSTM(n_in=3, n_out=4))
            .layer(RnnOutputLayer(n_out=2)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="rnn_time_step"):
        net.rnn_time_step(np.zeros((1, 3), np.float32))


@pytest.mark.parametrize("peephole", [True, False])
def test_checkpoints_cross_packages(peephole):
    jnet, net = _pair(peephole)
    x, y, _ = _batch(7)
    jnet.fit(JDataSet(x, y))
    net.fit(DataSet(x, y))
    x2, y2, _ = _batch(8)
    with tempfile.TemporaryDirectory() as d:
        p_zip, j_zip = Path(d) / "port.zip", Path(d) / "jax.zip"
        write_model(net, p_zip)
        jax_serializer.write_model(jnet, j_zip)
        from_port = jax_serializer.restore_model(str(p_zip))
        from_jax = restore_model(j_zip, device="cpu")
    assert from_port.iteration_count == from_jax.iteration_count == 3
    _close(np.asarray(from_port.output(x2)), net.output(x2).numpy())
    _close(from_jax.output(x2), np.asarray(jnet.output(x2)))
    for key, ref in _flat_updater(net.updater_state).items():
        _close(_flat_updater(from_port.updater_state)[key], ref, 0, 0, key)
    # each resumes where the other left off: the RMSProp state and the
    # iteration count came along
    from_port.fit(JDataSet(x2, y2))
    from_jax.fit(DataSet(x2, y2))
    jnet.fit(JDataSet(x2, y2))
    _check_trained(from_jax, jnet)
    for key, ref in _flat(from_port.params).items():
        ln, pn = key.rsplit("/", 1)
        _close(from_jax.params[ln][pn], ref, W_RTOL, W_ATOL, key)


def test_survey_corpus_builder():
    ids, alphabet = chip_smoke.survey_corpus()
    again, alphabet2 = chip_smoke.survey_corpus()
    assert np.array_equal(ids, again) and alphabet == alphabet2
    assert len(alphabet) == 76 and len(set(alphabet)) == 76
    assert ids.min() == 0 and ids.max() == 76
    text = (Path(chip_smoke.__file__).parent / "SURVEY.md").read_text(
        encoding="utf-8")
    assert len(ids) == len(text)
    assert all(ids[i] == alphabet.index(ch) if ch in alphabet else
               ids[i] == 76 for i, ch in enumerate(text[:500]))
    batches = chip_smoke.char_batches(ids, 4, 20, 2, seed=0)
    again = chip_smoke.char_batches(ids, 4, 20, 2, seed=0)
    assert len(batches) == 2
    for ds, ds2 in zip(batches, again):
        assert ds.features.shape == ds.labels.shape == (4, 77, 20)
        assert np.array_equal(ds.features, ds2.features)
        np.testing.assert_array_equal(ds.features.sum(axis=1), 1.0)
        # the labels are the next characters
        np.testing.assert_array_equal(ds.features[:, :, 1:],
                                      ds.labels[:, :, :-1])

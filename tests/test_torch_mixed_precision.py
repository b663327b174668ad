"""Half-precision training in the port against the JAX package, on the
CPU (the port's CPU route is each kernel's plain version: products of
the half values summed in f32, one final cast, as its kernels do).

- Pure bf16 (params, updater state and compute in bf16) NESTEROVS on a
  two-conv net, three steps: scores and weights.
- bf16 compute over f32 master weights (the transformer LM's
  ``compute_dtype="bfloat16"``), Adam, three steps of a 2-layer, d 32
  LM: scores, weights and Adam moments; the masters and moments stay
  f32 and the activations bf16, as in JAX.
- f16 dynamic loss scaling (``compute_dtype="float16"``): the
  ``(scale, good_steps, overflows)`` state equals JAX's exactly at every
  step through clean steps, forced overflows (whose updates are skipped
  bitwise), recovery, growth and its cap; the JAX package's
  ``tests/test_functional_core.py`` loss-scale tests ported, with JAX
  as the reference. Gradient accumulation keeps working under it, and
  so does the graph engine (a tiny ResNet with BatchNormalization).
- The layers hold f32 where JAX does: BatchNormalization's running
  statistics, LayerNorm's statistics, the updater state's dtypes, the
  score's dtype.

Weights come from the JAX package as numpy (``params_from_numpy``: bf16
leaves as their bit patterns); inputs from a numpy seed. Tolerances: a
bf16 step rounds its weights and activations once more than the other
package's sums in another order can agree on, so bf16 results are held
at ``kernel_tols``' bf16 branch: rtol 2e-2, atol 8e-3. Adam moves each
weight by about lr a step whatever its gradient's size, so under bf16
compute a gradient at the bf16 noise floor may move a master weight in
the other direction: three steps at lr 1e-3 stay inside atol 8e-3.
f16 weights are held at f16's eps (rtol 2e-3, atol 1e-3), but through
BatchNormalization, whose backward amplifies rounding, within half of
each weight's move (as the card's f32 ResNet-50 twin is held); the
loss-scale states exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn import core as jcore
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.zoo import resnet50 as jresnet50
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_lm
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

BF16_RTOL, BF16_ATOL = 2e-2, 8e-3
F16_RTOL, F16_ATOL = 2e-3, 1e-3


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _np32(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close_trees(port_tree, jax_tree, rtol, atol):
    for key, ref in _flat(jax_tree).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_allclose(_np32(port_tree[ln][pn]), _np32(ref),
                                   rtol=rtol, atol=atol, err_msg=key)


def _twin(jnet):
    """The port's network on the JAX network's configuration and
    weights."""
    conf = MultiLayerConfiguration.from_dict(jnet.conf.to_dict())
    return MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))


def two_conv_net(dtype="bfloat16", updater="NESTEROVS", lr=0.05):
    return (
        JNeuralNetConfiguration.Builder().seed(3).updater(updater)
        .learning_rate(lr).data_type(dtype)
        .list()
        .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JConv(n_out=6, kernel_size=(3, 3), activation="tanh"))
        .layer(JOutput(n_out=5, loss="MCXENT"))
        .set_input_type(JInputType.convolutional(12, 12, 2))
        .build()
    )


def _image_batch(seed, n=8):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, 2, 12, 12) * 0.9 + 0.05).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, n)]
    return x, y


def test_pure_bf16_nesterovs_two_conv_net_matches_jax():
    jnet = JMultiLayerNetwork(two_conv_net()).init()
    net = _twin(jnet)
    assert all(t.dtype == torch.bfloat16 for lp in net.params.values()
               for t in lp.values())
    js, ps = [], []
    for seed in (1, 2, 3):
        x, y = _image_batch(seed)
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
        js.append(float(jnet.score_value))
        ps.append(net.score_value)
    np.testing.assert_allclose(ps, js, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert ps[-1] != ps[0]  # it trained
    _close_trees(net.params, jnet.params, BF16_RTOL, BF16_ATOL)
    # the velocities stay bf16, as JAX keeps them
    for ln, lp in net.updater_state.items():
        for pn, (v,) in lp.items():
            assert v.dtype == torch.bfloat16
            assert jnet.updater_state[ln][pn][0].dtype == jnp.bfloat16
            np.testing.assert_allclose(
                _np32(v), _np32(jnet.updater_state[ln][pn][0]),
                rtol=BF16_RTOL, atol=BF16_ATOL, err_msg=f"{ln}/{pn}")


def test_updater_rules_take_jax_order_in_bf16():
    """A bf16 parameter's step: JAX multiplies by an f32 learning rate,
    so ``lr * grad`` and the step are f32 and the new parameter is
    rounded to bf16 once; the port does the same (a Python float would
    keep it bf16 and round twice)."""
    from deeplearning4j_tpu.nn import updaters as jupd
    from deeplearning4j_tpu_torch.nn import updaters as pupd

    rng = np.random.RandomState(4)
    p = (rng.randn(64) * 0.1).astype(np.float32)
    g = (rng.randn(64) * 0.01).astype(np.float32)
    v = (rng.randn(64) * 0.001).astype(np.float32)
    for name in ("SGD", "NESTEROVS", "ADAGRAD", "RMSPROP"):
        s_j = jupd.UpdaterSettings(updater=name)
        s_p = pupd.UpdaterSettings(updater=name)
        state = () if name == "SGD" else (v,)
        jstep, jst = jupd.apply_updater(
            s_j, jnp.asarray(g, jnp.bfloat16),
            tuple(jnp.asarray(a, jnp.bfloat16) for a in state),
            jnp.asarray(0.05, jnp.float32), jnp.asarray(1.0, jnp.float32))
        pstep, pst = pupd.apply_updater(
            s_p, torch.from_numpy(g).bfloat16(),
            tuple(torch.from_numpy(a).bfloat16() for a in state), 0.05, 1)
        assert pstep.dtype == torch.float32
        assert jstep.dtype == jnp.float32
        jp = (jnp.asarray(p, jnp.bfloat16) - jstep).astype(jnp.bfloat16)
        pp = (torch.from_numpy(p).bfloat16() - pstep).bfloat16()
        np.testing.assert_allclose(_np32(pp), _np32(jp), rtol=0,
                                   atol=float(np.abs(p).max()) * 2 ** -7,
                                   err_msg=name)


# -- bf16 compute over f32 master weights ------------------------------------

LM = dict(vocab=11, d_model=32, n_layers=2, n_heads=4)
T, BATCH = 16, 3


def _lm_batch(seed, vocab=11, t=T, batch=BATCH):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, t + 1))
    eye = np.eye(vocab, dtype=np.float32)
    x = np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1))
    y = np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))
    return x, y


def test_bf16_compute_adam_transformer_matches_jax():
    jnet = JMultiLayerNetwork(jax_lm(compute_dtype="bfloat16",
                                     learning_rate=1e-3, **LM)).init()
    net = _twin(jnet)
    js, ps = [], []
    for seed in (5, 6, 7):
        x, y = _lm_batch(seed)
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
        js.append(float(jnet.score_value))
        ps.append(net.score_value)
    np.testing.assert_allclose(ps, js, rtol=BF16_RTOL, atol=BF16_ATOL)
    # master weights and Adam moments f32 in both packages
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            assert t.dtype == torch.float32
            assert jnet.params[ln][pn].dtype == jnp.float32
            for m in net.updater_state[ln][pn]:
                assert m.dtype == torch.float32
    _close_trees(net.params, jnet.params, BF16_RTOL, BF16_ATOL)
    # the activations are bf16 in both
    x, _ = _lm_batch(8)
    out, jout = net.output(x), jnet.output(x)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np32(out), _np32(jout), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


# -- f16 dynamic loss scaling -------------------------------------------------


def _f16_pair(loss_scale=True, seed=5, grad_accum=None):
    """The JAX package's ``_f16_net`` (tests/test_functional_core.py)
    and its port twin on the same weights."""
    b = (JNeuralNetConfiguration.Builder().seed(seed)
         .learning_rate(0.05).data_type("float32")
         .compute_data_type("float16").list())
    b.layer(JDense(n_in=8, n_out=8, activation="tanh"))
    b.layer(JOutput(n_in=8, n_out=3))
    jnet = JMultiLayerNetwork(b.build()).init()
    net = _twin(jnet)
    if loss_scale:
        jnet.set_transforms(loss_scale=loss_scale)
        net.set_transforms(loss_scale=loss_scale)
    if grad_accum:
        jcore.set_grad_accum(jnet, grad_accum)
        core.set_grad_accum(net, grad_accum)
    return jnet, net


def _ls(state):
    return (float(state["scale"]), int(state["good_steps"]),
            int(state["overflows"]))


def _f16_data():
    r = np.random.RandomState(2)
    x = r.randn(4, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 4)]
    return x, y


def test_loss_scale_off_by_default_and_bf16_unaffected():
    jnet, net = _f16_pair(loss_scale=False)
    assert net._loss_scale_active is jnet._loss_scale_active is False
    b = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
         .compute_data_type("bfloat16").loss_scale(True).list())
    b.layer(DenseLayer(n_in=4, n_out=4))
    b.layer(OutputLayer(n_in=4, n_out=2))
    bnet = MultiLayerNetwork(b.build(), device="cpu").init()
    # the knob is set but the compute dtype is bf16: scaling never engages
    assert bnet.loss_scale == core.DEFAULT_LOSS_SCALE
    assert bnet._loss_scale_active is False
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    bnet.fit(DataSet(x, np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]))
    assert bnet._loss_scale_state is None


@pytest.mark.parametrize("grad_accum", [None, 2])
def test_loss_scale_dynamics_match_jax(grad_accum):
    """Clean steps count up; a non-finite gradient skips the update
    (parameters and updater state bitwise unchanged), halves the scale
    and counts the overflow; clean steps resume on the halved scale. The
    state equals JAX's at every step; the weights agree to f16."""
    jnet, net = _f16_pair(grad_accum=grad_accum)
    x, y = _f16_data()
    batches = [x, x, x, x * 1e30, x, x * 1e30, x * 1e30, x]
    for i, xb in enumerate(batches):
        before = ({(ln, pn): t.clone() for ln, lp in net.params.items()
                   for pn, t in lp.items()},
                  [t.clone() for lp in net.updater_state.values()
                   for tup in lp.values() for t in tup])
        jnet.fit_minibatch(JDataSet(features=xb, labels=y))
        net.fit_minibatch(DataSet(features=xb, labels=y))
        assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state), i
        if not np.isfinite(xb).all() or np.abs(xb).max() > 1e20:
            # the overflow step changed nothing
            for (ln, pn), t in before[0].items():
                assert torch.equal(net.params[ln][pn], t), (i, ln, pn)
            after = [t for lp in net.updater_state.values()
                     for tup in lp.values() for t in tup]
            assert all(torch.equal(a, b) for a, b in zip(after, before[1]))
        _close_trees(net.params, jnet.params, F16_RTOL, F16_ATOL)
    assert _ls(net._loss_scale_state) == (core.DEFAULT_LOSS_SCALE / 8, 1, 3)
    assert np.isfinite(_np32(net.score_value))


def test_loss_scale_growth_and_cap_match_jax():
    """LOSS_SCALE_GROWTH_INTERVAL clean steps double the scale and
    restart the count, in both packages; at MAX_LOSS_SCALE the state
    after the step (there: an overflow of the scaled f16 loss, halving)
    is JAX's too."""
    assert (core.DEFAULT_LOSS_SCALE, core.LOSS_SCALE_GROWTH_INTERVAL,
            core.MAX_LOSS_SCALE) == (jcore.DEFAULT_LOSS_SCALE,
                                     jcore.LOSS_SCALE_GROWTH_INTERVAL,
                                     jcore.MAX_LOSS_SCALE)
    x, y = _f16_data()
    for start in (4.0, core.MAX_LOSS_SCALE):
        jnet, net = _f16_pair(loss_scale=start)
        jst = jcore.loss_scale_state(start)
        jst["good_steps"] = jnp.asarray(
            jcore.LOSS_SCALE_GROWTH_INTERVAL - 1, jnp.int32)
        jnet._loss_scale_state = jst
        pst = core.loss_scale_state(start)
        pst["good_steps"] = torch.tensor(
            core.LOSS_SCALE_GROWTH_INTERVAL - 1, dtype=torch.int32)
        net._loss_scale_state = pst
        jnet.fit_minibatch(JDataSet(features=x, labels=y))
        net.fit_minibatch(DataSet(features=x, labels=y))
        assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)
        if start == 4.0:
            assert _ls(net._loss_scale_state) == (8.0, 0, 0)
        _close_trees(net.params, jnet.params, F16_RTOL, F16_ATOL)


def test_loss_scale_floor_and_transform_reset():
    """Overflows never take the scale below 1; ``set_transforms`` with a
    new scale drops the state, as JAX does."""
    jnet, net = _f16_pair(loss_scale=2.0)
    x, y = _f16_data()
    for _ in range(3):
        jnet.fit_minibatch(JDataSet(features=x * 1e30, labels=y))
        net.fit_minibatch(DataSet(features=x * 1e30, labels=y))
        assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state)
    assert _ls(net._loss_scale_state) == (1.0, 0, 3)
    net.set_transforms(loss_scale=64.0)
    jnet.set_transforms(loss_scale=64.0)
    assert net._loss_scale_state is None is jnet._loss_scale_state
    net.fit_minibatch(DataSet(features=x, labels=y))
    jnet.fit_minibatch(JDataSet(features=x, labels=y))
    assert _ls(net._loss_scale_state) == _ls(jnet._loss_scale_state) == (
        64.0, 1, 0)


def test_f16_graph_loss_scale_matches_jax():
    """The graph engine in f16 compute with loss scaling from a scale
    that overflows at first (a tiny ResNet, f32 masters, NESTEROVS):
    the loss-scale states equal JAX's at every step; the weights agree
    within half their move, the BN statistics to bf16's tolerance (see
    below)."""
    kw = dict(TINY_RESNET, learning_rate=0.01, compute_dtype="float16",
              loss_scale=2.0 ** 20)
    jg = JGraph(jresnet50(**kw)).init()
    init = _flat(jg.params)
    g = ComputationGraph(ComputationGraphConfiguration.from_dict(
        jg.conf.to_dict()), device="cpu").init(
            params=params_from_numpy(init, "cpu"))
    g.set_transforms(loss_scale=jg.loss_scale)
    assert g._loss_scale_active and jg._loss_scale_active
    rng = np.random.RandomState(12)
    seq = []
    for _ in range(12):
        x = rng.rand(4, 1, 8, 8).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
        jg.fit(JDataSet(x, y))
        g.fit(DataSet(x, y))
        seq.append(_ls(g._loss_scale_state))
        assert seq[-1] == _ls(jg._loss_scale_state)
    assert seq[0][2] == 1 and seq[-1][1] >= 1, seq
    # BN's backward cancels most of a channel's gradient, so f16 rounding
    # in the forward reaches the updates amplified (the card-vs-CPU f32
    # ResNet-50 twin shows up to 27 % of a move, chip_smoke's
    # check_twin_step): each weight within half its move in JAX's run
    # plus f16's eps (measured: up to 26 % of a move at the stem); the
    # running statistics, sums over those weights' outputs, at bf16's
    # tolerance (measured: 1.8 %)
    for key, ref in _flat(jg.params).items():
        ln, pn = key.rsplit("/", 1)
        move = np.abs(_np32(ref) - _np32(init[key])).max()
        diff = np.abs(_np32(g.params[ln][pn]) - _np32(ref)).max()
        assert diff <= 0.5 * move + F16_ATOL, (key, diff, move)
    for ln, st in jg.state.items():
        for k, ref in st.items():
            np.testing.assert_allclose(_np32(g.state[ln][k]), _np32(ref),
                                       rtol=BF16_RTOL, atol=BF16_ATOL)


def test_f16_transformer_loss_scale_matches_jax():
    """The LM in f16 compute with a scale set so that the first steps
    overflow (as the card's ``[f16-loss-scale]`` phase): the state
    sequence equals JAX's, and the weights agree to f16."""
    jnet = JMultiLayerNetwork(jax_lm(compute_dtype="float16",
                                     learning_rate=1e-3,
                                     loss_scale=2.0 ** 24, **LM)).init()
    net = _twin(jnet)
    # the transform hints are not serialized: set on the twin as on JAX's
    assert net.loss_scale is None
    net.set_transforms(loss_scale=jnet.loss_scale)
    assert net.loss_scale == jnet.loss_scale == 2.0 ** 24
    seq, jseq = [], []
    for seed in range(12):
        x, y = _lm_batch(10 + seed)
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
        seq.append(_ls(net._loss_scale_state))
        jseq.append(_ls(jnet._loss_scale_state))
    assert seq == jseq, (seq, jseq)
    assert seq[0][2] >= 1 and seq[-1][1] >= 1, seq  # overflowed, then clean
    # Adam at lr 1e-3: a gradient at f16's noise floor may step a weight
    # the other way in each clean step (as under bf16 compute above)
    _close_trees(net.params, jnet.params, BF16_RTOL, BF16_ATOL)


# -- f32 where JAX keeps f32 -------------------------------------------------

TINY_RESNET = dict(height=8, width=8, channels=1, n_classes=3,
                   cifar_stem=True, depths=(1, 1), base_width=4)


def test_batchnorm_statistics_and_score_stay_f32_as_in_jax():
    """A pure-bf16 tiny ResNet: BatchNormalization's running statistics
    stay f32, the velocities bf16, the score's dtype is JAX's; one
    NESTEROVS step agrees with JAX's."""
    jg = JGraph(jresnet50(learning_rate=0.01, dtype="bfloat16",
                          **TINY_RESNET)).init()
    g = ComputationGraph(ComputationGraphConfiguration.from_dict(
        jg.conf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jg.params), "cpu"))
    rng = np.random.RandomState(9)
    x = rng.rand(4, 1, 8, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    jg.fit(JDataSet(x, y))
    g.fit(DataSet(x, y))
    for ln, st in jg.state.items():
        for k, ref in st.items():
            got = g.state[ln][k]
            assert str(got.dtype).split(".")[-1] == str(ref.dtype), (ln, k)
            np.testing.assert_allclose(_np32(got), _np32(ref),
                                       rtol=BF16_RTOL, atol=BF16_ATOL)
    for ln, lp in jg.updater_state.items():
        for pn, tup in lp.items():
            for a, b in zip(g.updater_state[ln][pn], tup):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
    assert str(g._last_score.dtype).split(".")[-1] == str(
        jnp.asarray(jg._last_score).dtype)
    np.testing.assert_allclose(g.score_value, float(jg.score_value),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    _close_trees(g.params, jg.params, BF16_RTOL, BF16_ATOL)


def test_layernorm_statistics_stay_f32_under_bf16_compute():
    """LayerNorm under bf16 compute: the port's block output equals
    JAX's to bf16 rounding, and the normalisation of a row with a large
    offset (where bf16 statistics would lose it) holds."""
    from deeplearning4j_tpu.nn.layers import (
        LayerNormalization as JLayerNormalization,
    )
    from deeplearning4j_tpu_torch.nn.layers import LayerNormalization

    rng = np.random.RandomState(11)
    x = (rng.randn(4, 16, 5) * 0.5 + 30.0).astype(np.float32)
    jl = JLayerNormalization(n_out=16)
    pl = LayerNormalization(n_out=16)
    jp = {"gamma": jnp.ones((16,), jnp.bfloat16),
          "beta": jnp.zeros((16,), jnp.bfloat16)}
    pp = {"gamma": torch.ones(16, dtype=torch.bfloat16),
          "beta": torch.zeros(16, dtype=torch.bfloat16)}
    jy, _ = jl.apply(jp, jnp.asarray(x, jnp.bfloat16), {}, train=True)
    py, _ = pl.apply(pp, torch.from_numpy(x).bfloat16(), {}, train=True)
    assert py.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np32(py), _np32(jy), rtol=BF16_RTOL,
                               atol=BF16_ATOL)

"""The port's recurrent layers (``nn/layers/recurrent.py``) and the
recurrent preprocessors against the JAX package, on the CPU, with the
JAX layer's initial weights carried into the port.

JAX runs its default CPU route (the XLA scan) or, where a case says so,
``DL4J_TPU_PALLAS=1`` with its Pallas kernels interpreted; the port's
CPU route is each kernel's plain version. Tolerances: ``kernel_tols()``
(f32: rtol 2e-4, atol 2e-5), the same arithmetic with sums in other
orders over 6 steps, on O(1) values; gradients likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.nn import activations as jax_act
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    MultiLayerConfiguration as JMultiLayerConfiguration,
)
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import (
    GravesBidirectionalLSTM as JBidirectional,
)
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.layers.recurrent import _lstm_scan as jax_scan
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.ops import dispatch as jax_dispatch
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.conf import (
    FeedForwardToRnnPreProcessor,
    InputType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    RnnToFeedForwardPreProcessor,
    ShapeContext,
)
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    RnnOutputLayer,
    layer_from_json,
    layer_to_json,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import _lstm_scan
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

B, N_IN, N, T = 3, 5, 8, 6


def _close(got, ref, err_msg=""):
    rtol, atol = kernel_tols()
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_params(jlayer, seed=0, peephole_scale=0.3):
    """The JAX layer's initial weights, with non-zero peepholes (they
    start at zero) so that their terms are exercised."""
    p = dict(jlayer.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 100)
    for k in list(p):
        if k[:2] in ("pI", "pF", "pO"):
            p[k] = jnp.asarray(rng.randn(*p[k].shape) * peephole_scale,
                               jnp.float32)
    return p


def _inputs(seed=1, masked=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N_IN, T).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 4:] = 0.0
        mask[2, 2:] = 0.0
    return x, mask


@pytest.fixture
def pallas(monkeypatch):
    """Switch the JAX package to its Pallas kernels (interpreted on the
    CPU) for one test."""
    def set_mode(flag: str):
        monkeypatch.setenv("DL4J_TPU_PALLAS", flag)
        jax_dispatch.reset_for_tests()
    return set_mode


@pytest.mark.parametrize("peephole,masked,jax_kernels", [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, False), (False, False, True), (True, False, True)])
def test_graves_lstm_matches_jax(pallas, peephole, masked, jax_kernels):
    pallas("1" if jax_kernels else "0")
    jlayer = JGravesLSTM(n_in=N_IN, n_out=N, peephole=peephole)
    layer = GravesLSTM(n_in=N_IN, n_out=N, peephole=peephole)
    jp = _jax_params(jlayer)
    x, mask = _inputs(masked=masked)
    rng = np.random.RandomState(2)
    st = {"h": rng.randn(B, N).astype(np.float32) * 0.5,
          "c": rng.randn(B, N).astype(np.float32) * 0.5}
    for state in ({}, st):
        jy, jst = jlayer.apply(jp, jnp.asarray(x), {k: jnp.asarray(v)
                                                    for k, v in state.items()},
                               train=False,
                               mask=None if mask is None else jnp.asarray(mask))
        y, pst = layer.apply(_torch(jp), torch.from_numpy(x), _torch(state),
                             mask=None if mask is None
                             else torch.from_numpy(mask))
        _close(y, jy, "y")
        _close(pst["h"], jst["h"], "h")
        _close(pst["c"], jst["c"], "c")


@pytest.mark.parametrize("peephole,masked", [(True, False), (False, False),
                                             (False, True)])
def test_graves_lstm_gradients_match_jax(peephole, masked):
    jlayer = JGravesLSTM(n_in=N_IN, n_out=N, peephole=peephole)
    layer = GravesLSTM(n_in=N_IN, n_out=N, peephole=peephole)
    jp = _jax_params(jlayer, seed=3)
    x, mask = _inputs(seed=4, masked=masked)
    w = np.random.RandomState(5).randn(B, N, T).astype(np.float32)

    def jloss(p, x):
        y, st = jlayer.apply(p, x, {}, train=True,
                             mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * w) + jnp.sum(st["h"] ** 2)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    p = {k: v.requires_grad_(True) for k, v in _torch(jp).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = layer.apply(p, xt, {}, train=True,
                       mask=None if mask is None else torch.from_numpy(mask))
    # the layer hands its carry on detached, so the loss on hT goes
    # through the scan's last output instead (the same value)
    hT = _lstm_scan(p, xt, torch.zeros(B, N), torch.zeros(B, N),
                    None if mask is None else torch.from_numpy(mask),
                    "sigmoid", "tanh", peephole)[1][0]
    ((y * torch.from_numpy(w)).sum() + (hT ** 2).sum()).backward()
    for k, g in jg_p.items():
        _close(p[k].grad, g, k)
    _close(xt.grad, jg_x, "dx")


def test_other_activations_take_the_plain_scan():
    jlayer = JGravesLSTM(n_in=N_IN, n_out=N, activation="softsign",
                         gate_activation="hardsigmoid")
    layer = GravesLSTM(n_in=N_IN, n_out=N, activation="softsign",
                       gate_activation="hardsigmoid")
    jp = _jax_params(jlayer, seed=6)
    x, mask = _inputs(seed=7, masked=True)
    jy, jst = jlayer.apply(jp, jnp.asarray(x), {}, mask=jnp.asarray(mask))
    y, st = layer.apply(_torch(jp), torch.from_numpy(x), {},
                        mask=torch.from_numpy(mask))
    _close(y, jy)
    _close(st["c"], jst["c"])


@pytest.mark.parametrize("peephole,masked", [(True, True), (False, False)])
def test_reverse_scan_matches_jax(peephole, masked):
    jlayer = JGravesLSTM(n_in=N_IN, n_out=N, peephole=peephole)
    jp = _jax_params(jlayer, seed=8)
    x, mask = _inputs(seed=9, masked=masked)
    z = np.zeros((B, N), np.float32)
    jy, (jh, jc) = jax_scan(jp, jnp.asarray(x), jnp.asarray(z),
                            jnp.asarray(z),
                            None if mask is None else jnp.asarray(mask),
                            jax_act.get("sigmoid"), jax_act.get("tanh"),
                            peephole, reverse=True)
    y, (h, c) = _lstm_scan(_torch(jp), torch.from_numpy(x),
                           torch.from_numpy(z), torch.from_numpy(z),
                           None if mask is None else torch.from_numpy(mask),
                           "sigmoid", "tanh", peephole, reverse=True)
    _close(y, jy)
    _close(h, jh)
    _close(c, jc)


@pytest.mark.parametrize("mode", ["add", "concat", "average", "mul"])
def test_bidirectional_matches_jax(mode):
    jlayer = JBidirectional(n_in=N_IN, n_out=N, mode=mode)
    layer = GravesBidirectionalLSTM(n_in=N_IN, n_out=N, mode=mode)
    jp = _jax_params(jlayer, seed=10)
    x, mask = _inputs(seed=11, masked=True)
    jy, _ = jlayer.apply(jp, jnp.asarray(x), {}, mask=jnp.asarray(mask))
    p = {k: v.requires_grad_(True) for k, v in _torch(jp).items()}
    y, st = layer.apply(p, torch.from_numpy(x), {}, train=True,
                        mask=torch.from_numpy(mask))
    assert st == {}
    _close(y, jy)
    assert layer.output_type(InputType.recurrent(N_IN)).size == (
        2 * N if mode == "concat" else N)
    assert not layer.can_stream() and not layer.is_recurrent()
    # the gradient of every parameter, both directions
    w = np.random.RandomState(12).randn(*jy.shape).astype(np.float32)
    jg = jax.grad(lambda q: jnp.sum(jlayer.apply(
        q, jnp.asarray(x), {}, train=True, mask=jnp.asarray(mask))[0] * w))(jp)
    (y * torch.from_numpy(w)).sum().backward()
    for k, g in jg.items():
        _close(p[k].grad, g, k)


def test_rnn_output_layer_matches_jax():
    jlayer = JRnnOutput(n_in=N, n_out=4, loss="MCXENT")
    layer = RnnOutputLayer(n_in=N, n_out=4, loss="MCXENT")
    jp = jlayer.init_params(jax.random.PRNGKey(13))
    rng = np.random.RandomState(14)
    x = rng.randn(B, N, T).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (B, T))]
    labels = labels.transpose(0, 2, 1)
    mask = np.ones((B, T), np.float32)
    mask[1, 3:] = 0.0
    jy, _ = jlayer.apply(jp, jnp.asarray(x), {})
    y, _ = layer.apply(_torch(jp), torch.from_numpy(x), {})
    _close(y, jy)
    _close(layer.pre_output(_torch(jp), torch.from_numpy(x)),
           jlayer.pre_output(jp, jnp.asarray(x)))
    jscore = jlayer.compute_score(jp, jnp.asarray(x), jnp.asarray(labels),
                                  jnp.asarray(mask))
    score = layer.compute_score(_torch(jp), torch.from_numpy(x),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask))
    _close(score, jscore)
    assert layer.has_loss() and layer.input_kind() == "recurrent"
    assert losses.per_row_scores("MCXENT", torch.from_numpy(labels),
                                 layer.pre_output(_torch(jp),
                                                  torch.from_numpy(x)),
                                 "softmax").shape == (B * T,)


def _mixed_jconf():
    """GravesLSTM -> Dense -> RnnOutputLayer on a recurrent input: the
    builder inserts RnnToFeedForward before the dense layer and
    FeedForwardToRnn after it."""
    return (
        JNeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
        .updater("RMSPROP").list()
        .layer(JGravesLSTM(n_out=N))
        .layer(JDense(n_out=6, activation="tanh"))
        .layer(JRnnOutput(n_out=4, loss="MCXENT"))
        .set_input_type(JInputType.recurrent(N_IN))
        .build()
    )


def test_preprocessor_insertion_matches_jax():
    jconf = _mixed_jconf()
    conf = (
        NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
        .updater("RMSPROP").list()
        .layer(GravesLSTM(n_out=N))
        .layer(DenseLayer(n_out=6, activation="tanh"))
        .layer(RnnOutputLayer(n_out=4, loss="MCXENT"))
        .set_input_type(InputType.recurrent(N_IN))
        .build()
    )
    assert conf.to_dict() == jconf.to_dict()
    assert isinstance(conf.preprocessors[1], RnnToFeedForwardPreProcessor)
    assert isinstance(conf.preprocessors[2], FeedForwardToRnnPreProcessor)
    assert [l.n_in for l in conf.layers] == [N_IN, N, 6]
    jnet = JMultiLayerNetwork(jconf).init()
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(flat, "cpu"))
    x, mask = _inputs(seed=15, masked=True)
    _close(net.output(x, features_mask=mask),
           jnet.output(x, features_mask=mask))
    # the adapters themselves: one row per (example, timestep)
    ctx = ShapeContext(batch=B, time=T)
    rows = RnnToFeedForwardPreProcessor().preprocess(torch.from_numpy(x), ctx)
    assert torch.equal(rows[1], torch.from_numpy(x[0, :, 1]))
    back = FeedForwardToRnnPreProcessor().preprocess(rows, ctx)
    assert torch.equal(back, torch.from_numpy(x))


def test_config_json_crosses_packages():
    jconf = _mixed_jconf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_dict() == jconf.to_dict()
    assert JMultiLayerConfiguration.from_json(conf.to_json()) == jconf
    for jl in (JGravesLSTM(n_in=3, n_out=4, peephole=False),
               JBidirectional(n_in=3, n_out=4, mode="concat"),
               JRnnOutput(n_in=4, n_out=2, loss="MSE",
                          activation="identity")):
        from deeplearning4j_tpu.nn.layers.base import (
            layer_to_json as jax_layer_to_json,
        )
        d = jax_layer_to_json(jl)
        assert layer_to_json(layer_from_json(d)) == d

"""The port's input preprocessors against the JAX package on the CPU:
each of the ten adapters' forward and gradient on the same inputs, the
``configuration.json`` round trip of every one (the composable one
nested) in both directions, the shape inference that puts a
``CnnToRnnPreProcessor`` between a convolutional and a recurrent layer,
and a conv -> LSTM network (two LeNet-style conv stages over the frames
of a sequence, ``CnnToRnn``, GravesLSTM, then ``RnnToFeedForward`` into
a softmax) trained a few steps against JAX on weights carried across.

Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5); the
reshapes are exact and held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.multi_layer import (
    MultiLayerConfiguration as JMultiLayerConfiguration,
)
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import (
    InputType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    GravesLSTM,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

B, T = 3, 4


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


# (name, constructor arguments, input shape); the context is batch B,
# time T
CASES = [
    ("CnnToFeedForwardPreProcessor", dict(height=4, width=5, channels=2),
     (B, 2, 4, 5)),
    ("FeedForwardToCnnPreProcessor", dict(height=4, width=5, channels=2),
     (B, 40)),
    ("RnnToFeedForwardPreProcessor", {}, (B, 6, T)),
    ("FeedForwardToRnnPreProcessor", {}, (B * T, 6)),
    ("CnnToRnnPreProcessor", dict(height=3, width=2, channels=2),
     (B * T, 2, 3, 2)),
    ("RnnToCnnPreProcessor", dict(height=3, width=2, channels=2),
     (B, 12, T)),
    ("ReshapePreProcessor", dict(shape=(3, 4)), (B, 12)),
    ("ZeroMeanPrePreProcessor", {}, (5, 7)),
    ("UnitVarianceProcessor", {}, (5, 7)),
]


def _composable(mod):
    return mod.ComposableInputPreProcessor(processors=(
        mod.ZeroMeanPrePreProcessor(), mod.UnitVarianceProcessor(),
        mod.ReshapePreProcessor(shape=(7, 1))))


def _pair_of(name, kw):
    if name == "ComposableInputPreProcessor":
        return _composable(pre), _composable(jpre)
    return getattr(pre, name)(**kw), getattr(jpre, name)(**kw)


@pytest.mark.parametrize(
    "name,kw,shape",
    CASES + [("ComposableInputPreProcessor", {}, (5, 7))],
    ids=[c[0] for c in CASES] + ["ComposableInputPreProcessor"])
def test_forward_and_gradient_match_jax(name, kw, shape):
    p, jp = _pair_of(name, kw)
    rng = np.random.RandomState(len(name))
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    ctx, jctx = (pre.ShapeContext(batch=B, time=T),
                 jpre.ShapeContext(batch=B, time=T))
    got = p.preprocess(torch.from_numpy(x), ctx)
    want = jp.preprocess(jnp.asarray(x), jctx)
    assert tuple(got.shape) == tuple(want.shape)
    if name in ("ZeroMeanPrePreProcessor", "UnitVarianceProcessor",
                "ComposableInputPreProcessor"):
        _close(got, want)
    else:  # a reshape / transpose: exact
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    w = rng.randn(*want.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (p.preprocess(xt, ctx) * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jp.preprocess(a, jctx) * w))(
        jnp.asarray(x))
    _close(xt.grad, jg)


@pytest.mark.parametrize("name", [c[0] for c in CASES]
                         + ["ComposableInputPreProcessor"])
def test_json_round_trips_both_ways(name):
    kw = next((c[1] for c in CASES if c[0] == name), {})
    p, jp = _pair_of(name, kw)
    assert p.to_json() == jp.to_json()
    assert pre.InputPreProcessor.from_json(jp.to_json()) == p
    assert jpre.InputPreProcessor.from_json(p.to_json()) == jp
    assert name in pre.PREPROCESSOR_REGISTRY


def test_every_jax_preprocessor_is_registered():
    assert set(jpre.PREPROCESSOR_REGISTRY) == set(pre.PREPROCESSOR_REGISTRY)


# -- the conv -> LSTM network -------------------------------------------------


def jax_conv_lstm(h=8, w=8, lr=0.01):
    """Frames [b, h*w, t] -> RnnToCnn -> conv 3x3 -> 4 relu, max pool ->
    (CnnToRnn, inferred) GravesLSTM 6 -> (RnnToFeedForward, inferred)
    softmax 3, as the chip's conv-LSTM runs LeNet-5's stages."""
    return (JNNC.Builder().seed(7).learning_rate(lr).updater("ADAM")
            .list()
            .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(JPool(pooling_type="MAX"))
            .layer(JGravesLSTM(n_out=6, activation="tanh"))
            .layer(JOutputLayer(n_out=3, loss="MCXENT"))
            .input_pre_processor(0, jpre.RnnToCnnPreProcessor(
                height=h, width=w, channels=1))
            .set_input_type(JInputType.recurrent(h * w, T))
            .build())


def test_shape_inference_inserts_cnn_to_rnn_like_jax():
    jconf = jax_conv_lstm()
    conf = (NeuralNetConfiguration.Builder().seed(7).learning_rate(0.01)
            .updater("ADAM").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="MAX"))
            .layer(GravesLSTM(n_out=6, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="MCXENT"))
            .input_pre_processor(0, pre.RnnToCnnPreProcessor(
                height=8, width=8, channels=1))
            .set_input_type(InputType.recurrent(64, T))
            .build())
    assert conf.to_dict() == jconf.to_dict()
    assert type(conf.preprocessors[2]) is pre.CnnToRnnPreProcessor
    assert conf.preprocessors[2] == pre.CnnToRnnPreProcessor(3, 3, 4)
    assert type(conf.preprocessors[3]) is pre.RnnToFeedForwardPreProcessor
    assert conf.layers[2].n_in == 36
    assert MultiLayerConfiguration.from_json(jconf.to_json()) == conf
    assert JMultiLayerConfiguration.from_json(conf.to_json()).to_dict() \
        == jconf.to_dict()
    # a convolutional input meeting a dense layer still flattens
    conf2 = (NeuralNetConfiguration.Builder().list()
             .layer(DenseLayer(n_out=5)).layer(OutputLayer(n_out=2))
             .set_input_type(InputType.convolutional(3, 3, 2)).build())
    assert type(conf2.preprocessors[0]) is pre.CnnToFeedForwardPreProcessor


def _frames(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, 64, T).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, B * T)]
    return x, y


def test_conv_lstm_network_matches_jax():
    jnet = JMultiLayerNetwork(jax_conv_lstm()).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    x, y = _frames(1)
    out = net.output(x)
    assert tuple(out.shape) == (B * T, 3)
    _close(out, jnet.output(x))
    _close(net.score(DataSet(x, y)), jnet.score(JDataSet(x, y)), 1e-5, 0)
    for seed in (2, 3, 4):
        x, y = _frames(seed)
        net.fit(DataSet(x, y))
        jnet.fit(JDataSet(x, y))
        _close(net.score_value, float(jnet.score_value), 1e-5, 0)
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        _close(net.params[ln][pn], ref, 1e-3, 1e-5, key)

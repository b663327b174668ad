"""Dropout and drop-connect in the port against the JAX package, on the
CPU.

- ``nn/random.py`` against ``jax.random`` (threefry2x32, partitionable):
  keys, ``fold_in``, ``bits``, ``uniform`` and ``bernoulli`` bitwise,
  from scalars to draws of more than 2**20 elements, and a row slice
  drawn at an ``offset`` bitwise equal to those rows of the global draw;
- each layer's ``maybe_dropout`` / ``maybe_drop_connect`` bitwise equal
  to the JAX layer's on the same key: Dense, Conv, GravesLSTM (``W``
  only), GravesBidirectionalLSTM (``WF`` and ``WB``), RnnOutputLayer and
  DropoutLayer;
- ``LossLayer`` and ``DropoutLayer``: configuration JSON both ways, the
  score, and three SGD steps of a net that holds both;
- three-step trajectories with the JAX package's masks: a LeNet with
  drop-connect and dropout on its head, and a GravesLSTM under
  truncated BPTT with dropout and drop-connect (the AlexNet-shaped one
  is in ``test_torch_multilayer.py``, the graph in
  ``test_torch_graph.py``);
- data parallelism: two gloo ranks with dropout draw each its rows of
  the global mask, so the world of two trains as one process does.

Masks are integer arithmetic and the inverted scaling one f32 division
in both packages: those are held bitwise. Trajectories are the same
math summed in other orders: ``kernel_tols()`` (f32: rtol 2e-4, atol
2e-5). The data has no exact zeros, so relu's gradient at z == 0 (0.5
in the port, 0 on JAX's XLA route) is never taken.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    MultiLayerConfiguration as JMultiLayerConfiguration,
)
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GravesBidirectionalLSTM as JBiLSTM
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.layers.base import layer_to_json as jlayer_to_json
from deeplearning4j_tpu.nn.layers.feedforward import DropoutLayer as JDropout
from deeplearning4j_tpu.nn.layers.feedforward import LossLayer as JLossLayer
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import random
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    LAYER_REGISTRY,
    DenseLayer,
    DropoutLayer,
    LossLayer,
    layer_from_json,
    layer_to_json,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

SEEDS = [0, 42, 2 ** 31 - 1]


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# -- the generator ------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_are_jax_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    assert random.host_key(seed) == tuple(int(w) for w in np.asarray(jk))
    assert random.key(seed).tolist() == list(random.host_key(seed))
    for data in (0, 1, 7, 0x7C, 123456789, 2 ** 32 - 1):
        want = tuple(int(w) for w in np.asarray(jax.random.fold_in(jk, data)))
        assert random.fold_in(random.host_key(seed), data) == want
        # the device form, with the data as a tensor (a chunk's it0 + i)
        got = random.fold_in(random.key(seed), torch.tensor(data))
        assert tuple(got.tolist()) == want
    # two levels, as the engines derive a layer's key from the step's
    k2 = jax.random.fold_in(jax.random.fold_in(jk, 5), 3)
    assert random.fold_in(random.fold_in(random.key(seed), 5), 3).tolist() \
        == [int(w) for w in np.asarray(k2)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (7,), (64, 300), (3, 5, 7, 9),
                                   (1100, 1000)])
def test_bits_uniform_bernoulli_are_jax_bitwise(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    k = random.fold_in(random.key(seed), 11)
    np.testing.assert_array_equal(
        random.bits(k, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    np.testing.assert_array_equal(random.uniform(k, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    for p in (0.5, 0.8):
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        np.testing.assert_array_equal(random.bernoulli(k, p, shape).numpy(),
                                      want)
        # the host form of the key draws the same
        hk = tuple(int(w) for w in k.tolist())
        np.testing.assert_array_equal(
            random.bernoulli(hk, p, shape).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_an_offset_draws_the_rows_of_the_global_mask(seed):
    jk = jax.random.PRNGKey(seed)
    glob = np.asarray(jax.random.bernoulli(jk, 0.5, (8, 6, 5)))
    k = random.key(seed)
    for r0, rows in ((0, 3), (3, 2), (5, 3)):
        got = random.bernoulli(k, 0.5, (rows, 6, 5), offset=r0 * 30)
        np.testing.assert_array_equal(got.numpy(), glob[r0:r0 + rows])
        # the window of a data-parallel rank, also after a flatten of
        # time into the rows ([b, f, t] -> [b*t, f], batch outermost)
        with random.row_window(r0, rows):
            assert random.row_offset((rows, 6, 5)) == r0 * 30
            assert random.row_offset((rows * 5, 6)) == r0 * 30
    assert random.row_offset((2, 3)) == 0


# -- the layer methods -------------------------------------------------------


def _layer_cases():
    rng = np.random.RandomState(3)
    x2 = rng.rand(6, 10).astype(np.float32)
    x4 = rng.rand(3, 2, 7, 7).astype(np.float32)
    x3 = rng.rand(4, 5, 6).astype(np.float32)
    return [
        ("dense", JDense(n_in=10, n_out=4, dropout=0.4), x2, ("W",)),
        ("conv", JConv(n_in=2, n_out=3, kernel_size=(3, 3), dropout=0.3),
         x4, ("W",)),
        ("lstm", JGravesLSTM(n_in=5, n_out=4, dropout=0.5), x3, ("W",)),
        ("bilstm", JBiLSTM(n_in=5, n_out=4, dropout=0.5), x3, ("WF", "WB")),
        ("rnn_out", JRnnOutput(n_in=5, n_out=3, dropout=0.25), x3, ("W",)),
        ("dropout_layer", JDropout(dropout=0.6), x4, ()),
    ]


@pytest.mark.parametrize("case", _layer_cases(), ids=lambda c: c[0])
def test_layer_masks_are_jax_bitwise(case):
    _, jlayer, x, wkeys = case
    layer = layer_from_json(jlayer_to_json(jlayer))
    assert type(layer).__name__ == type(jlayer).__name__
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 4), 2)
    k = random.fold_in(random.fold_in(random.host_key(9), 4), 2)
    got = layer.maybe_dropout(torch.from_numpy(x), train=True, rng=k)
    want = jlayer.maybe_dropout(jnp.asarray(x), train=True, rng=jk)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (_np(got) == 0).any() and (_np(got) != 0).any()
    # off outside training and without a key
    for train, key in ((False, k), (True, None)):
        np.testing.assert_array_equal(_np(layer.maybe_dropout(
            torch.from_numpy(x), train=train, rng=key)), x)
    if not wkeys:
        return
    # drop-connect: the weights masked, the input left alone
    jdc = dataclasses.replace(jlayer, drop_connect=True)
    dc = layer_from_json(jlayer_to_json(jdc))
    jparams = jdc.init_params(jax.random.PRNGKey(1))
    params = {pn: torch.from_numpy(np.array(a)) for pn, a in jparams.items()}
    got = dc.maybe_drop_connect(params, train=True, rng=k, keys=wkeys)
    want = jdc.maybe_drop_connect(jparams, train=True, rng=jk, keys=wkeys)
    for pn in params:
        np.testing.assert_array_equal(_np(got[pn]), np.asarray(want[pn]),
                                      err_msg=pn)
    for pn in wkeys:
        assert (_np(got[pn]) == 0).any()
    np.testing.assert_array_equal(
        _np(dc.maybe_dropout(torch.from_numpy(x), train=True, rng=k)), x)


def test_layer_apply_draws_the_jax_masks():
    """The layers' own ``apply`` with a key equals the JAX layer's,
    dropout and drop-connect in place (GravesLSTM routes ``W`` only)."""
    rng = np.random.RandomState(4)
    x = rng.rand(4, 5, 6).astype(np.float32)
    jk = jax.random.PRNGKey(21)
    k = random.host_key(21)
    rtol, atol = kernel_tols()
    for jlayer in (JGravesLSTM(n_in=5, n_out=4, dropout=0.5, peephole=False),
                   JGravesLSTM(n_in=5, n_out=4, dropout=0.5,
                               drop_connect=True, peephole=False),
                   JBiLSTM(n_in=5, n_out=4, dropout=0.5, drop_connect=True,
                           peephole=False),
                   JRnnOutput(n_in=5, n_out=3, dropout=0.5,
                              drop_connect=True)):
        layer = layer_from_json(jlayer_to_json(jlayer))
        jp = jlayer.init_params(jax.random.PRNGKey(2))
        p = {pn: torch.from_numpy(np.array(a)) for pn, a in jp.items()}
        want, _ = jlayer.apply(jp, jnp.asarray(x), {}, train=True, rng=jk)
        got, _ = layer.apply(p, torch.from_numpy(x), {}, train=True, rng=k)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                                   atol=atol, err_msg=type(layer).__name__)


# -- LossLayer and DropoutLayer ------------------------------------------------


def _loss_net_conf(loss="MCXENT", activation="softmax"):
    return (
        JNeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
        .updater("SGD").list()
        .layer(JDense(n_in=6, n_out=8, activation="tanh"))
        .layer(JDropout(dropout=0.5))
        .layer(JDense(n_out=3, activation="identity"))
        .layer(JLossLayer(loss=loss, activation=activation))
        .set_input_type(JInputType.feed_forward(6))
        .build())


def test_loss_and_dropout_layers_are_registered_and_cross_packages():
    assert {"LossLayer", "DropoutLayer"} <= set(LAYER_REGISTRY)
    jconf = _loss_net_conf()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert isinstance(conf.layers[1], DropoutLayer)
    assert isinstance(conf.layers[3], LossLayer)
    assert conf.layers[3].loss == "MCXENT"
    back = JMultiLayerConfiguration.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    for layer in (LossLayer(loss="MSE"), DropoutLayer(dropout=0.3)):
        assert layer_from_json(layer_to_json(layer)) == layer


def _pair(jconf):
    jnet = JMultiLayerNetwork(jconf).init()
    flat = {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init(
            params=params_from_numpy(flat, "cpu"))
    return jnet, net


def _check_params(net, jnet):
    rtol, atol = kernel_tols()
    for ln, lp in jnet.params.items():
        for pn, a in lp.items():
            np.testing.assert_allclose(_np(net.params[ln][pn]), np.asarray(a),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{ln}/{pn}")


def _fit_both(jnet, net, batches):
    js, ps = [], []
    for x, y in batches:
        jnet.fit(JDataSet(x, y))
        js.append(float(jnet.score_value))
        net.fit(DataSet(x, y))
        ps.append(net.score_value)
    return np.array(js), np.array(ps)


@pytest.mark.parametrize("loss,activation", [("MCXENT", "softmax"),
                                             ("MSE", "identity")])
def test_loss_layer_scores_and_trains_as_jax(loss, activation):
    jnet, net = _pair(_loss_net_conf(loss, activation))
    rng = np.random.RandomState(5)
    rtol, atol = kernel_tols()
    x = (rng.rand(9, 6) + 0.05).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 9)]
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x)),
                               rtol=rtol, atol=atol)
    batches = [((rng.rand(9, 6) + 0.05).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.randint(0, 3, 9)])
               for _ in range(3)]
    js, ps = _fit_both(jnet, net, batches)
    np.testing.assert_allclose(ps, js, rtol=rtol, atol=atol)
    _check_params(net, jnet)
    # the training forward drops half of the first layer's units
    acts = net.feed_forward(x, train=True)
    jacts = jnet.feed_forward(x, train=True)
    np.testing.assert_array_equal(_np(acts[1]) == 0,
                                  np.asarray(jacts[1]) == 0)
    np.testing.assert_allclose(_np(net.output(x, train=True)),
                               np.asarray(jnet.output(x, train=True)),
                               rtol=rtol, atol=atol)


# -- trajectories ------------------------------------------------------------


def _dc_lenet():
    """A narrow LeNet with drop-connect on its second conv and its dense
    layer and input dropout on its softmax head (the pre-output sees the
    mask of the head's apply)."""
    return (
        JNeuralNetConfiguration.Builder().seed(7).updater("SGD")
        .learning_rate(0.1).list()
        .layer(JConv(n_out=4, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JConv(n_out=6, kernel_size=(5, 5), activation="relu",
                     dropout=0.3, drop_connect=True))
        .layer(JPool(pooling_type="MAX"))
        .layer(JDense(n_out=32, activation="relu", dropout=0.5,
                      drop_connect=True))
        .layer(JOutput(n_out=10, loss="MCXENT", dropout=0.2))
        .set_input_type(JInputType.convolutional_flat(28, 28, 1))
        .build())


def test_drop_connect_lenet_three_steps_match_jax():
    jnet, net = _pair(_dc_lenet())
    rng = np.random.RandomState(6)
    batches = [((rng.rand(8, 784) * 0.9 + 0.05).astype(np.float32),
                np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
               for _ in range(3)]
    rtol, atol = kernel_tols()
    js, ps = _fit_both(jnet, net, batches)
    np.testing.assert_allclose(ps, js, rtol=rtol, atol=atol)
    _check_params(net, jnet)


def _lstm_tbptt_conf():
    return (
        JNeuralNetConfiguration.Builder().seed(42).learning_rate(0.1)
        .updater("SGD").list()
        .layer(JGravesLSTM(n_in=11, n_out=8, peephole=False, dropout=0.3))
        .layer(JGravesLSTM(n_in=8, n_out=8, peephole=False, dropout=0.4,
                           drop_connect=True))
        .layer(JRnnOutput(n_out=11, loss="MCXENT", dropout=0.2))
        .backprop_type("TruncatedBPTT").t_bptt_forward_length(5)
        .t_bptt_backward_length(5)
        .build())


def test_lstm_with_dropout_under_tbptt_matches_jax():
    """Each TBPTT chunk is one iteration and draws from its own key,
    ``fold_in(PRNGKey(seed), iteration)``: three chunks a minibatch."""
    jnet, net = _pair(_lstm_tbptt_conf())
    rng = np.random.RandomState(8)
    x = np.eye(11, dtype=np.float32)[rng.randint(0, 11, (3, 15))]
    x = np.transpose(x, (0, 2, 1)).copy()
    y = np.eye(11, dtype=np.float32)[rng.randint(0, 11, (3, 15))]
    y = np.transpose(y, (0, 2, 1)).copy()
    rtol, atol = kernel_tols()
    js, ps = _fit_both(jnet, net, [(x, y)])
    assert net.iteration_count == jnet.iteration_count == 3
    np.testing.assert_allclose(ps, js, rtol=rtol, atol=atol)
    _check_params(net, jnet)


# -- data parallelism --------------------------------------------------------


def test_two_gloo_ranks_with_dropout_train_as_one_process(tmp_path):
    from test_torch_parallel import (
        _assert_close_trees,
        _assert_replicas_equal,
        _flat,
        _params,
        _single_fit,
        blob_data,
        run_ranks,
    )

    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer

    conf = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.2)
            .updater("SGD").list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(DenseLayer(n_out=16, activation="tanh", dropout=0.5))
            .layer(OutputLayer(n_out=3, dropout=0.3, drop_connect=True))
            .build())
    x, y = blob_data(np.random.RandomState(2), n=32)
    res = run_ranks(tmp_path, 2, conf, {"x0": x, "y0": y}, steps=3)
    _assert_replicas_equal(res)
    single, scores = _single_fit(conf, DataSet(x, y), 3)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(res[0]["scores"], scores, rtol=rtol,
                               atol=atol)
    _assert_close_trees(_params(res[0]), _flat(single.params), rtol, atol)


def test_parallel_wrapper_replicas_draw_the_jax_masks():
    """Replica i draws from ``fold_in(step key, i)``, as the JAX
    ParallelWrapper's: four replicas with dropout, averaged every 2
    rounds, follow the JAX package's trajectory."""
    from deeplearning4j_tpu.datasets.api import ListDataSetIterator as JList
    from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
    from test_torch_parallel import blob_data

    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    jconf = (JNeuralNetConfiguration.Builder().seed(3).learning_rate(0.2)
             .updater("SGD").list()
             .layer(JDense(n_in=6, n_out=16, activation="tanh"))
             .layer(JDense(n_out=16, activation="tanh", dropout=0.5))
             .layer(JOutput(n_out=3, dropout=0.3)).build())
    jnet, net = _pair(jconf)
    x, y = blob_data(np.random.RandomState(4), n=64)
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    pw = ParallelWrapper(net, workers=4, averaging_frequency=2)
    jpw = JWrapper(jnet, workers=4, averaging_frequency=2,
                   prefetch_buffer=0)
    for _ in range(3):
        pw.fit(ListDataSetIterator([DataSet(a, b) for a, b in batches]))
        jpw.fit(JList([JDataSet(features=a, labels=b) for a, b in batches]))
    _check_params(net, jnet)

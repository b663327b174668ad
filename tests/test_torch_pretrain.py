"""Layer-wise pretraining in the port against the JAX package, on the CPU.

- ``nn/random.py``'s ``split``, tensor-``p`` ``bernoulli`` and ranged
  ``uniform`` bitwise against ``jax.random``; ``normal`` within 1e-5
  absolute plus 1e-5 relative (``torch.erfinv`` is not XLA's
  polynomial; the uniform under it is bitwise);
- ``AutoEncoder``, ``RBM`` (every visible / hidden unit pair, CD-1 and
  CD-2) and ``VariationalAutoencoder`` (each reconstruction distribution,
  Composite included, one and two samples): ``pretrain_loss`` and its
  gradient on JAX's parameters, input and key;
- the VAE's ``reconstruction_probability``, ``generate_at_mean_given_z``
  and ``generate_random_given_z``; the RBM's ``free_energy`` and
  ``reconstruction_error``;
- ``MultiLayerNetwork.pretrain`` then ``fit`` on JAX
  ``tests/test_pretrain.py:289``'s stacked AutoEncoder net, per step;
  ``ComputationGraph.pretrain`` with a VAE vertex; ``backprop=False``;
- the configuration JSON (both packages) and the checkpoint zip of every
  new layer and distribution.

Tolerance ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5): the same math
summed in other orders; noise that goes through ``normal`` is held to
``NORMAL_TOLS`` where it passes straight into a value (the RBM's
Gaussian units, the VAE's samples).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import RBM as JRBM
from deeplearning4j_tpu.nn.layers import AutoEncoder as JAutoEncoder
from deeplearning4j_tpu.nn.layers import (
    BernoulliReconstructionDistribution as JBernoulli,
)
from deeplearning4j_tpu.nn.layers import (
    CompositeReconstructionDistribution as JComposite,
)
from deeplearning4j_tpu.nn.layers import (
    ExponentialReconstructionDistribution as JExponential,
)
from deeplearning4j_tpu.nn.layers import (
    GaussianReconstructionDistribution as JGaussian,
)
from deeplearning4j_tpu.nn.layers import LossFunctionWrapper as JLossWrapper
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import VariationalAutoencoder as JVAE
from deeplearning4j_tpu.nn.layers import layer_from_json as jlayer_from_json
from deeplearning4j_tpu.nn.layers import layer_to_json as jlayer_to_json
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import random
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    LAYER_REGISTRY,
    layer_from_json,
    layer_to_json,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    restore_model,
    write_model,
)

NORMAL_TOLS = (1e-5, 1e-5)
SEEDS = [0, 42, 2 ** 31 - 1]


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _port(jlayer):
    """The port's layer of a JAX layer, through the configuration JSON."""
    return layer_from_json(jlayer_to_json(jlayer))


def _keys(seed, data=3):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), data),
            random.fold_in(random.key(seed), data))


def _loss_and_grads(jlayer, jparams, x, jkey, tkey):
    """``pretrain_loss`` and its gradient in both packages."""
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlayer.pretrain_loss(p, jnp.asarray(x), jkey))(jparams)
    layer = _port(jlayer)
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in jparams.items()}
    loss = layer.pretrain_loss(leaves, torch.from_numpy(x), tkey)
    loss.backward()
    return (float(jloss), float(loss.detach()),
            {k: (np.asarray(jgrads[k]), _np(leaves[k].grad))
             for k in jparams})


def _assert_grads(grads, tols):
    rtol, atol = tols
    for name, (want, got) in grads.items():
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)


def _binary(seed, n, d):
    return (np.random.RandomState(seed).rand(n, d) > 0.5).astype(np.float32)


# -- the generator ------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bernoulli_uniform_bitwise_normal_close(seed):
    jk, k = _keys(seed)
    want = np.asarray(jax.random.split(jk, 5))
    assert [tuple(t.tolist()) for t in random.split(k, 5)] == [
        tuple(int(w) for w in row) for row in want]
    hk = tuple(int(w) for w in k.tolist())
    assert random.split(hk, 3) == [tuple(int(w) for w in row)
                                   for row in want[:3]]
    p = np.random.RandomState(seed).rand(64, 300).astype(np.float32)
    np.testing.assert_array_equal(
        random.bernoulli(k, torch.from_numpy(p)).numpy(),
        np.asarray(jax.random.bernoulli(jk, jnp.asarray(p))))
    for lo, hi in ((1e-7, 1.0), (-3.0, 2.5)):
        np.testing.assert_array_equal(
            random.uniform(k, (300, 200), minval=lo, maxval=hi).numpy(),
            np.asarray(jax.random.uniform(jk, (300, 200), minval=lo,
                                          maxval=hi)))
    got = random.normal(k, (500, 400)).numpy()
    want = np.asarray(jax.random.normal(jk, (500, 400)))
    np.testing.assert_allclose(got, want, rtol=NORMAL_TOLS[0],
                               atol=NORMAL_TOLS[1])
    assert (got == want).mean() > 0.2  # most samples are bitwise


# -- AutoEncoder --------------------------------------------------------------


@pytest.mark.parametrize("corruption,loss,act", [
    (0.3, "XENT", "sigmoid"), (0.0, "XENT", "sigmoid"),
    (0.5, "MSE", "tanh")])
def test_autoencoder_pretrain_loss_and_gradient(corruption, loss, act):
    jlayer = JAutoEncoder(n_in=12, n_out=7, corruption_level=corruption,
                          loss=loss, activation=act)
    jparams = jlayer.init_params(jax.random.PRNGKey(1))
    x = _binary(2, 16, 12)
    jkey, tkey = _keys(5)
    jl, tl, grads = _loss_and_grads(jlayer, jparams, x, jkey, tkey)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    _assert_grads(grads, kernel_tols())
    # the supervised forward is the encoder
    got, _ = _port(jlayer).apply(
        {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()},
        torch.from_numpy(x), {})
    want, _ = jlayer.apply(jparams, jnp.asarray(x), {})
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- RBM ----------------------------------------------------------------------


@pytest.mark.parametrize("visible,hidden", [
    ("BINARY", "BINARY"), ("BINARY", "RECTIFIED"), ("GAUSSIAN", "BINARY"),
    ("GAUSSIAN", "RECTIFIED")])
@pytest.mark.parametrize("k", [1, 2])
def test_rbm_pretrain_loss_and_gradient(visible, hidden, k):
    jlayer = JRBM(n_in=10, n_out=6, visible_unit=visible, hidden_unit=hidden,
                  k=k)
    jparams = jlayer.init_params(jax.random.PRNGKey(3))
    x = (_binary(4, 24, 10) if visible == "BINARY" else
         np.random.RandomState(4).randn(24, 10).astype(np.float32))
    jkey, tkey = _keys(7, data=k)
    jl, tl, grads = _loss_and_grads(jlayer, jparams, x, jkey, tkey)
    # the loss's value is the reconstruction error (no draw); the
    # gradient reads the chain's samples, through normal where a unit
    # is Gaussian or rectified
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    drawn_normal = visible == "GAUSSIAN" or hidden == "RECTIFIED"
    _assert_grads(grads, NORMAL_TOLS if drawn_normal else kernel_tols())
    # the chain's end, sample for sample
    layer = _port(jlayer)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jparams.items()}
    got = layer.gibbs_chain(tp, torch.from_numpy(x), tkey)
    want = jlayer.gibbs_chain(jparams, jnp.asarray(x), jkey)
    if drawn_normal:
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   rtol=NORMAL_TOLS[0], atol=NORMAL_TOLS[1])
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_allclose(
        float(layer.reconstruction_error(tp, torch.from_numpy(x))),
        float(jlayer.reconstruction_error(jparams, jnp.asarray(x))),
        rtol=rtol, atol=atol)
    if hidden == "BINARY":
        np.testing.assert_allclose(
            _np(layer.free_energy(tp, torch.from_numpy(x))),
            np.asarray(jlayer.free_energy(jparams, jnp.asarray(x))),
            rtol=rtol, atol=atol)
    else:
        with pytest.raises(ValueError, match="BINARY hidden"):
            layer.free_energy(tp, torch.from_numpy(x))


def test_rbm_refuses_units_it_does_not_carry():
    for kw in ({"visible_unit": "SOFTMAX"}, {"hidden_unit": "SOFTMAX"}):
        with pytest.raises(ValueError, match="Unsupported"):
            _port(JRBM(n_in=4, n_out=4, **kw)).init_params(torch.Generator())


# -- the VAE ------------------------------------------------------------------


DISTRIBUTIONS = {
    "bernoulli": JBernoulli(),
    "bernoulli_tanh": JBernoulli(activation="tanh"),
    "gaussian": JGaussian(activation="tanh"),
    "exponential": JExponential(),
    "loss_wrapper": JLossWrapper(loss="MSE", activation="sigmoid"),
    "composite": JComposite(components=(
        (3, JBernoulli()), (2, JGaussian()), (3, JExponential()))),
}


def _vae(dist, num_samples=1, **kw):
    return JVAE(n_in=8, n_out=3, encoder_layer_sizes=(7, 5),
                decoder_layer_sizes=(6,), activation="tanh",
                reconstruction_distribution=dist, num_samples=num_samples,
                **kw)


def _vae_data(dist_name, seed=9):
    r = np.random.RandomState(seed)
    if dist_name in ("bernoulli", "bernoulli_tanh", "loss_wrapper"):
        return (r.rand(16, 8) > 0.5).astype(np.float32)
    return r.rand(16, 8).astype(np.float32) + 0.05


@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
@pytest.mark.parametrize("num_samples", [None, 1, 2])
def test_vae_pretrain_loss_and_gradient(dist, num_samples):
    jlayer = _vae(DISTRIBUTIONS[dist], num_samples or 1)
    jparams = jlayer.init_params(jax.random.PRNGKey(11))
    x = _vae_data(dist)
    if num_samples is None:  # no key: the posterior's mean
        jkey = tkey = None
    else:
        jkey, tkey = _keys(13)
    jl, tl, grads = _loss_and_grads(jlayer, jparams, x, jkey, tkey)
    tols = kernel_tols() if num_samples is None else NORMAL_TOLS
    np.testing.assert_allclose(tl, jl, rtol=tols[0], atol=tols[1])
    _assert_grads(grads, tols)


@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_vae_generation_and_reconstruction_probability(dist):
    jlayer = _vae(DISTRIBUTIONS[dist], num_samples=2)
    layer = _port(jlayer)
    jparams = jlayer.init_params(jax.random.PRNGKey(17))
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jparams.items()}
    x = _vae_data(dist, seed=19)
    jkey, tkey = _keys(23)
    np.testing.assert_allclose(
        _np(layer.reconstruction_probability(tp, torch.from_numpy(x), tkey,
                                             num_samples=3)),
        np.asarray(jlayer.reconstruction_probability(
            jparams, jnp.asarray(x), jkey, num_samples=3)),
        rtol=NORMAL_TOLS[0], atol=NORMAL_TOLS[1])
    z = np.random.RandomState(29).randn(5, 3).astype(np.float32)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(
        _np(layer.generate_at_mean_given_z(tp, torch.from_numpy(z))),
        np.asarray(jlayer.generate_at_mean_given_z(jparams, jnp.asarray(z))),
        rtol=rtol, atol=atol)
    got = _np(layer.generate_random_given_z(tp, torch.from_numpy(z), tkey))
    want = np.asarray(jlayer.generate_random_given_z(jparams, jnp.asarray(z),
                                                     jkey))
    np.testing.assert_allclose(got, want, rtol=NORMAL_TOLS[0],
                               atol=NORMAL_TOLS[1])
    assert layer.regularizable_params() == jlayer.regularizable_params()
    # the supervised forward is the posterior's mean
    got, _ = layer.apply(tp, torch.from_numpy(x), {})
    want, _ = jlayer.apply(jparams, jnp.asarray(x), {})
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- serialization ------------------------------------------------------------


NEW_LAYERS = [
    JAutoEncoder(n_in=6, n_out=4, corruption_level=0.25, loss="MSE"),
    JRBM(n_in=6, n_out=4, visible_unit="GAUSSIAN", hidden_unit="RECTIFIED",
         k=3),
] + [_vae(d, num_samples=2, pzx_activation="tanh")
     for _, d in sorted(DISTRIBUTIONS.items())]


@pytest.mark.parametrize("jlayer", NEW_LAYERS, ids=[
    f"{type(layer).__name__}{i}" for i, layer in enumerate(NEW_LAYERS)])
def test_layer_json_round_trips_both_ways(jlayer):
    d = jlayer_to_json(jlayer)
    layer = layer_from_json(d)
    assert type(layer).__name__ in LAYER_REGISTRY
    assert layer_to_json(layer) == d
    assert jlayer_from_json(layer_to_json(layer)) == jlayer
    assert layer_from_json(layer_to_json(layer)) == layer


# -- the engines --------------------------------------------------------------


def _stacked_conf():
    """JAX ``tests/test_pretrain.py:289``'s net."""
    return (JNeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
            .list()
            .layer(JAutoEncoder(n_in=10, n_out=8, corruption_level=0.2,
                                activation="sigmoid"))
            .layer(JAutoEncoder(n_out=6, corruption_level=0.2,
                                activation="sigmoid"))
            .layer(JOutput(n_out=2, loss="MCXENT"))
            .pretrain(True)
            .build())


def _carried(jnet):
    return params_from_numpy(
        {f"{ln}/{pn}": np.asarray(a) for ln, lp in jnet.params.items()
         for pn, a in lp.items()}, "cpu")


def _assert_same_params(jnet, net, tols=None):
    rtol, atol = tols or kernel_tols()
    for ln, lp in jnet.params.items():
        for pn, a in lp.items():
            np.testing.assert_allclose(_np(net.params[ln][pn]),
                                       np.asarray(a), rtol=rtol, atol=atol,
                                       err_msg=f"{ln}/{pn}")


def _stacked_data(n=48):
    r = np.random.RandomState(31)
    x = (r.rand(n, 10) > 0.5).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[r.randint(0, 2, n)]
    return x, y


def test_multilayer_pretrain_then_fit_matches_jax_per_step():
    jconf = _stacked_conf()
    jnet = JMultiLayerNetwork(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.pretrain and conf.layers[1].n_in == 8
    net = MultiLayerNetwork(conf, device="cpu").init(params=_carried(jnet))
    x, y = _stacked_data()
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 48, 16)]
    # pretraining alone: each AutoEncoder against its JAX twin
    jnet.pretrain([JDataSet(features=a, labels=b) for a, b in batches],
                  epochs=2)
    net.pretrain([DataSet(features=a, labels=b) for a, b in batches],
                 epochs=2)
    assert net._pretrain_done
    np.testing.assert_allclose(net.score_value, float(jnet._last_score),
                               *kernel_tols())
    _assert_same_params(jnet, net)
    # fit pretrains no more, then backprops each minibatch
    for a, b in batches:
        jnet.fit(JDataSet(features=a, labels=b))
        net.fit(DataSet(features=a, labels=b))
        np.testing.assert_allclose(net.score_value,
                                   float(jnet.score_value), *kernel_tols())
        _assert_same_params(jnet, net)
    assert net.iteration_count == jnet.iteration_count == 3
    # a fresh init pretrains again
    net.init()
    assert not net._pretrain_done


def test_fit_pretrains_first_and_stops_without_backprop():
    """``fit`` of a ``pretrain(True)`` conf pretrains once (a fresh JAX
    net's fit, the same layer keys), then backprops; with
    ``backprop(False)`` it stops after pretraining."""
    x, y = _stacked_data(32)
    for backprop in (True, False):
        jconf = dataclasses.replace(_stacked_conf(), backprop=backprop)
        jnet = JMultiLayerNetwork(jconf).init()
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(jconf.to_json()),
            device="cpu").init(params=_carried(jnet))
        jnet.fit(JDataSet(features=x, labels=y))
        net.fit(DataSet(features=x, labels=y))
        assert net._pretrain_done
        assert net.iteration_count == jnet.iteration_count == int(backprop)
        _assert_same_params(jnet, net)


def _vae_graph_conf():
    return (JNeuralNetConfiguration.Builder().seed(3).learning_rate(0.05)
            .updater("ADAM")
            .graph_builder()
            .add_inputs("in")
            .add_layer("vae", _vae(JGaussian(), num_samples=2), "in")
            .add_layer("out", JOutput(n_in=3, n_out=2, loss="MCXENT"), "vae")
            .set_outputs("out")
            .pretrain(True)
            .build())


def test_graph_pretrain_with_a_vae_vertex_matches_jax():
    jconf = _vae_graph_conf()
    jg = JGraph(jconf).init()
    g = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init(params=_carried(jg))
    r = np.random.RandomState(37)
    x = r.rand(24, 8).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[r.randint(0, 2, 24)]
    jg.pretrain([JDataSet(features=x[:12], labels=y[:12]),
                 JDataSet(features=x[12:], labels=y[12:])], epochs=2)
    g.pretrain([DataSet(features=x[:12], labels=y[:12]),
                DataSet(features=x[12:], labels=y[12:])], epochs=2)
    assert g._pretrain_done
    np.testing.assert_allclose(g.score_value, float(jg._last_score),
                               *NORMAL_TOLS)
    _assert_same_params(jg, g, NORMAL_TOLS)
    # then one backprop step each, the output vertex's weights untouched
    # by pretraining
    jg.fit(JDataSet(features=x, labels=y))
    g.fit(DataSet(features=x, labels=y))
    np.testing.assert_allclose(g.score_value, float(jg.score_value),
                               *NORMAL_TOLS)
    _assert_same_params(jg, g, NORMAL_TOLS)


def test_checkpoint_zip_carries_the_new_layers_both_ways(tmp_path):
    jconf = (JNeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
             .list()
             .layer(JRBM(n_in=8, n_out=6, hidden_unit="RECTIFIED"))
             .layer(JAutoEncoder(n_out=8))
             .layer(_vae(DISTRIBUTIONS["composite"]))
             .layer(JOutput(n_out=2, loss="MCXENT"))
             .build())
    jnet = JMultiLayerNetwork(jconf).init()
    jax_serializer.write_model(jnet, str(tmp_path / "jax.zip"))
    net = restore_model(tmp_path / "jax.zip", device="cpu")
    assert [type(layer).__name__ for layer in net.conf.layers] == [
        "RBM", "AutoEncoder", "VariationalAutoencoder", "OutputLayer"]
    _assert_same_params(jnet, net, (0.0, 0.0))
    x = np.random.RandomState(41).rand(4, 8).astype(np.float32)
    np.testing.assert_allclose(_np(net.output(x)),
                               np.asarray(jnet.output(x)), *kernel_tols())
    write_model(net, tmp_path / "port.zip")
    back = jax_serializer.restore_model(str(tmp_path / "port.zip"))
    assert back.conf.to_json() == jconf.to_json()
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               np.asarray(jnet.output(x)), *kernel_tols())

"""BatchNormalization, the eval conv -> BN fold and LRN in the port,
against the JAX package, on the CPU.

BN is held against JAX's ``apply`` in training (batch statistics, and
the running state it returns) and at inference (running statistics),
on CNN and FF activations, with and without ``lock_gamma_beta``; a
MultiLayer Conv(identity) -> BN(relu) network fits two NESTEROVS steps
along JAX's trajectory, running statistics included, and its
``layerState.npz`` round-trips between the packages. At inference the
port folds the pair into one ``conv_block`` call with the BN affine in
its epilogue, exactly where the JAX package's peephole does: its output
equals the unfused walk and JAX's fold (the JAX Pallas route,
``DL4J_TPU_PALLAS=1``, interpreted), and it does not engage in training
or behind a conv with an activation.

Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5), the same
math summed in other orders (the fold moves the BN affine into the
conv's epilogue, one rounding less).
"""

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
from deeplearning4j_tpu.nn.layers import BatchNormalization as JBatchNorm
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import (
    LocalResponseNormalization as JLRN,
)
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.ops import dispatch as jax_dispatch
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    LocalResponseNormalization,
    layer_from_json,
)
from deeplearning4j_tpu_torch.nn.layers import convolution
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    params_to_numpy,
    restore_model,
    write_model,
)


def _np(t):
    return t.detach().cpu().numpy()


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _bn_operands(kind, lock, seed=0):
    rng = np.random.RandomState(seed)
    shape = (6, 5, 4, 3) if kind == "cnn" else (7, 5)
    x = (rng.randn(*shape) * 2.0 + 0.7).astype(np.float32)
    params = {} if lock else {
        "gamma": (rng.rand(5) + 0.5).astype(np.float32),
        "beta": rng.randn(5).astype(np.float32)}
    state = {"mean": rng.randn(5).astype(np.float32) * 0.3,
             "var": (rng.rand(5) + 0.5).astype(np.float32)}
    return x, params, state


@pytest.mark.parametrize("lock", [False, True], ids=["affine", "locked"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["cnn", "ff"])
def test_batchnorm_matches_jax(kind, train, lock):
    x, params, state = _bn_operands(kind, lock)
    kw = dict(n_out=5, decay=0.8, eps=1e-3, lock_gamma_beta=lock,
              activation="tanh")
    jbn, bn = JBatchNorm(**kw), BatchNormalization(**kw)
    want, jstate = jbn.apply({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in state.items()},
                             train=train)
    got, pstate = bn.apply({k: torch.from_numpy(v) for k, v in
                            params.items()}, torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in
                            state.items()}, train=train)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(pstate[k]), np.asarray(jstate[k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    if not train:
        assert pstate is not None and all(
            torch.equal(pstate[k], torch.from_numpy(state[k]))
            for k in state)


def test_batchnorm_layer_config_and_params_match_jax():
    for kw in (dict(), dict(lock_gamma_beta=True, decay=0.5, eps=1e-4,
                            gamma_init=2.0, beta_init=-1.0)):
        j = JBatchNorm(n_out=3, **kw)
        p = layer_from_json(_layer_json(j))
        assert p == BatchNormalization(n_out=3, **kw)
        want = j.init_params(None)
        got = p.init_params(torch.Generator())
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
        for k, v in p.init_state().items():
            np.testing.assert_array_equal(_np(v),
                                          np.asarray(j.init_state()[k]))
    assert BatchNormalization(n_out=3).regularizable_params() == ()


def _layer_json(layer):
    from deeplearning4j_tpu.nn.layers.base import layer_to_json

    return layer_to_json(layer)


def test_batchnorm_half_precision_trains_on_one_pass_statistics():
    x, params, state = _bn_operands("cnn", False, seed=5)
    bn = BatchNormalization(n_out=5)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    y16, s16 = bn.apply(tp, torch.from_numpy(x).bfloat16(), ts, train=True)
    y32, s32 = bn.apply(tp, torch.from_numpy(x), ts, train=True)
    assert y16.dtype == torch.bfloat16 and s16["mean"].dtype == torch.float32
    torch.testing.assert_close(y16.float(), y32, rtol=2e-2, atol=3e-2)
    for k in ("mean", "var"):
        torch.testing.assert_close(s16[k], s32[k], rtol=1e-2, atol=1e-2)


# -- networks -----------------------------------------------------------------

def conv_bn_net(conv_activation="identity", lock=False, bn_activation="relu"):
    """Conv 3x3 pad 1 (4 -> 6 channels) -> BN -> max pool -> softmax 5
    on [b, 4, 6, 6]."""
    return (
        JNeuralNetConfiguration.Builder().seed(3).updater("NESTEROVS")
        .learning_rate(0.05)
        .list()
        .layer(JConv(n_out=6, kernel_size=(3, 3), padding=(1, 1),
                     activation=conv_activation))
        .layer(JBatchNorm(activation=bn_activation, lock_gamma_beta=lock))
        .layer(JPool(pooling_type="MAX"))
        .layer(JOutput(n_out=5, loss="MCXENT"))
        .set_input_type(JInputType.convolutional(6, 6, 4))
        .build())


def _pair(jconf):
    jnet = JMultiLayerNetwork(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init(
            params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def _batch(rng, b=8):
    x = (rng.rand(b, 4, 6, 6) * 0.9 + 0.05).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, b)]
    return x, y


def _set_running_stats(jnet, net, name, rng):
    mean = rng.randn(6).astype(np.float32) * 0.2
    var = (rng.rand(6) + 0.5).astype(np.float32)
    jnet.state[name] = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
    net.state[name] = {"mean": torch.from_numpy(mean.copy()),
                       "var": torch.from_numpy(var.copy())}


@pytest.mark.parametrize("lock", [False, True], ids=["affine", "locked"])
def test_conv_bn_network_fits_along_jax_with_running_statistics(lock):
    jnet, net = _pair(conv_bn_net(lock=lock))
    if lock:
        assert net.params["1"] == {} and "1" not in _flat(jnet.params)
    rng = np.random.RandomState(7)
    rtol, atol = kernel_tols()
    for _ in range(2):
        x, y = _batch(rng)
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.score_value,
                                   float(jnet.score_value), rtol=rtol,
                                   atol=atol)
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_allclose(_np(net.params[ln][pn]), ref, rtol=rtol,
                                   atol=atol, err_msg=key)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(net.state["1"][k]),
                                   np.asarray(jnet.state["1"][k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert not torch.equal(net.state["1"]["var"], torch.ones(6))


def test_layer_state_round_trips_through_checkpoints(tmp_path):
    jnet, net = _pair(conv_bn_net())
    rng = np.random.RandomState(8)
    net.fit(DataSet(*_batch(rng)))
    path = tmp_path / "port.zip"
    write_model(net, path)
    back = restore_model(path, device="cpu")
    jres = jax_serializer.restore_model(str(path))
    for key, ref in params_to_numpy(net.state).items():
        ln, k = key.rsplit("/", 1)
        np.testing.assert_array_equal(_np(back.state[ln][k]), ref)
        np.testing.assert_array_equal(np.asarray(jres.state[ln][k]), ref)
    # and the JAX package's zip into the port
    jnet.fit(JDataSet(*_batch(rng)))
    jpath = tmp_path / "jax.zip"
    jax_serializer.write_model(jnet, str(jpath))
    got = restore_model(jpath, device="cpu")
    for k in ("mean", "var"):
        np.testing.assert_array_equal(_np(got.state["1"][k]),
                                      np.asarray(jnet.state["1"][k]))


# -- the eval conv -> BN fold -------------------------------------------------

@pytest.fixture
def conv_calls(monkeypatch):
    """Every ``conv_block`` call of the layers, with whether it carried a
    BN scale (the fold)."""
    calls = []
    real = convolution.conv_block

    def spy(x, w, bias=None, bn_scale=None, bn_shift=None, **kw):
        calls.append(bn_scale is not None)
        return real(x, w, bias, bn_scale, bn_shift, **kw)

    monkeypatch.setattr(convolution, "conv_block", spy)
    return calls


def _unfused_output(net, x):
    """The layer-by-layer walk of ``net`` at inference, no fold."""
    h = torch.from_numpy(x)
    for name, layer in zip(net.layer_names, net.conf.layers):
        if name in ("3",):
            return torch.softmax(layer.pre_output(
                net.params[name], h.reshape(h.shape[0], -1)), dim=1)
        h, _ = layer.apply(net.params[name], h, net.state[name])
    raise AssertionError("no output layer")


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS", "1")
    jax_dispatch.reset_for_tests()
    yield
    monkeypatch.delenv("DL4J_TPU_PALLAS")
    jax_dispatch.reset_for_tests()


@pytest.fixture
def jax_folds(monkeypatch):
    """Whether each of JAX's peephole calls folded (traced once per
    compiled forward)."""
    from deeplearning4j_tpu.nn.layers import convolution as jconvolution

    folds = []
    real = jconvolution.maybe_fused_conv_bn

    def spy(*args):
        out = real(*args)
        folds.append(out is not None)
        return out

    monkeypatch.setattr(jconvolution, "maybe_fused_conv_bn", spy)
    return folds


@pytest.mark.parametrize("bn_activation", ["relu", "tanh"])
def test_conv_bn_fold_equals_the_unfused_walk_and_jax(conv_calls,
                                                      pallas_route,
                                                      jax_folds,
                                                      bn_activation):
    jnet, net = _pair(conv_bn_net(bn_activation=bn_activation))
    rng = np.random.RandomState(9)
    _set_running_stats(jnet, net, "1", rng)
    x, y = _batch(rng, b=5)
    got = net.output(x)
    assert conv_calls == [True]  # one conv launch, the BN in its epilogue
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(_np(got), _np(_unfused_output(net, x)),
                               rtol=rtol, atol=atol)
    want = jnet.output(x)
    assert jax_folds == [True]  # JAX's peephole engaged too
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)
    # the score reads the same folded forward
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=rtol,
                               atol=atol)


def test_conv_bn_fold_matches_jax_xla_route():
    jnet, net = _pair(conv_bn_net())
    rng = np.random.RandomState(10)
    _set_running_stats(jnet, net, "1", rng)
    x, _ = _batch(rng, b=4)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x)),
                               rtol=rtol, atol=atol)


def test_conv_bn_fold_does_not_engage_in_training(conv_calls):
    _, net = _pair(conv_bn_net())
    rng = np.random.RandomState(11)
    x, y = _batch(rng)
    net.fit(DataSet(x, y))
    assert conv_calls == [False]
    conv_calls.clear()
    y_train = net.output(x, train=True)
    assert conv_calls == [False]
    assert tuple(y_train.shape) == (8, 5)


def test_conv_bn_fold_does_not_engage_behind_an_activation(conv_calls):
    jnet, net = _pair(conv_bn_net(conv_activation="relu"))
    rng = np.random.RandomState(12)
    _set_running_stats(jnet, net, "1", rng)
    x, _ = _batch(rng, b=4)
    got = net.output(x)
    assert conv_calls == [False]
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(_np(got), np.asarray(jnet.output(x)),
                               rtol=rtol, atol=atol)


def test_maybe_fused_conv_bn_refuses_what_does_not_fold():
    conf = MultiLayerConfiguration.from_dict(conv_bn_net().to_dict())
    conv, bn = conf.layers[0], conf.layers[1]
    gen = torch.Generator().manual_seed(0)
    cp, bp = conv.init_params(gen), bn.init_params(gen)
    st = bn.init_state()
    x = torch.rand(2, 4, 6, 6)
    assert convolution.maybe_fused_conv_bn(conv, bn, cp, bp, st, x) \
        is not None
    assert convolution.maybe_fused_conv_bn(conv, bn, cp, bp, {}, x) is None
    assert convolution.maybe_fused_conv_bn(
        conv, conf.layers[2], cp, {}, {}, x) is None
    softmax_bn = BatchNormalization(n_out=6, activation="softmax")
    assert convolution.maybe_fused_conv_bn(conv, softmax_bn, cp, bp, st,
                                           x) is None
    wide_bn = BatchNormalization(n_out=7)
    assert convolution.maybe_fused_conv_bn(conv, wide_bn, cp, bp, st,
                                           x) is None


def test_sequential_forward_folds_only_at_inference(conv_calls):
    _, net = _pair(conv_bn_net())
    x = torch.rand(3, 4, 6, 6)
    for train, want in ((False, [True]), (True, [False])):
        conv_calls.clear()
        with torch.no_grad():
            core.sequential_forward(net.conf, net.layer_names, net.params,
                                    net.state, x, train=train)
        assert conv_calls == want


# -- LRN ----------------------------------------------------------------------

@pytest.mark.parametrize("n,k,alpha,beta", [(5, 2.0, 1e-4, 0.75),
                                            (4, 1.0, 0.5, 0.6),
                                            (1, 2.0, 1e-2, 0.75)])
def test_lrn_matches_jax(n, k, alpha, beta):
    rng = np.random.RandomState(13)
    x = (rng.randn(2, 7, 3, 4) * 3.0).astype(np.float32)
    kw = dict(n=n, k=k, alpha=alpha, beta=beta)
    want, _ = JLRN(**kw).apply({}, jnp.asarray(x), {})
    got, _ = LocalResponseNormalization(**kw).apply({}, torch.from_numpy(x),
                                                    {})
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)
    assert (layer_from_json(_layer_json(JLRN(**kw)))
            == LocalResponseNormalization(**kw))

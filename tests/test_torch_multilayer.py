"""The port's network stack against the JAX package, on the CPU.

Narrow LeNet- and AlexNet-shaped networks are built and saved by the
JAX package (``write_model``), loaded by the port (its zip reader, and
``params_from_numpy`` on the JAX parameters), and ``output`` /
``output_padded`` are compared on the same numpy inputs. Configuration
JSON, layers, activations and pooling are held against their JAX
counterparts the same way. Tolerance: ``kernel_tols()`` (f32: rtol
2e-4, atol 2e-5) — the same math, summed in other orders.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.nn import activations as jax_activations
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu.ops import dispatch as jax_dispatch
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import SubsamplingLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    restore_model,
    write_model,
)
from deeplearning4j_tpu_torch.zoo import models as port_zoo


def narrow_lenet(dense_activation="relu"):
    """LeNet-5's layer sequence at 4/6 channels and a dense 32."""
    return (
        JNeuralNetConfiguration.Builder().seed(7).updater("ADAM")
        .list()
        .layer(JConv(n_out=4, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JConv(n_out=6, kernel_size=(5, 5), activation="relu"))
        .layer(JPool(pooling_type="MAX"))
        .layer(JDense(n_out=32, activation=dense_activation))
        .layer(JOutput(n_out=10, loss="MCXENT"))
        .set_input_type(JInputType.convolutional_flat(28, 28, 1))
        .build()
    )


def narrow_alexnet():
    """AlexNet's geometry (11x11/s4/p2, 5x5/p2, three 3x3/p1, 3x3/s2
    pools) on a 67x67x3 input at 8/16/16/16/8 channels, dense 32."""
    b = (JNeuralNetConfiguration.Builder().seed(11).updater("NESTEROVS")
         .list()
         .layer(JConv(n_out=8, kernel_size=(11, 11), stride=(4, 4),
                      padding=(2, 2), activation="relu"))
         .layer(JPool(pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2)))
         .layer(JConv(n_out=16, kernel_size=(5, 5), padding=(2, 2),
                      activation="relu"))
         .layer(JPool(pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2))))
    for n_out in (16, 16, 8):
        b = b.layer(JConv(n_out=n_out, kernel_size=(3, 3), padding=(1, 1),
                          activation="relu"))
    return (
        b.layer(JPool(pooling_type="MAX", kernel_size=(3, 3), stride=(2, 2)))
        .layer(JDense(n_out=32, activation="relu", dropout=0.5))
        .layer(JDense(n_out=32, activation="relu", dropout=0.5))
        .layer(JOutput(n_out=10, loss="MCXENT"))
        .set_input_type(JInputType.convolutional(67, 67, 3))
        .build()
    )


def _inputs(conf, n, seed=0):
    it = conf.input_type
    rng = np.random.RandomState(seed)
    if it.kind == "convolutional":
        return rng.rand(n, it.channels, it.height, it.width).astype(
            np.float32)
    return rng.rand(n, it.flat_size()).astype(np.float32)


def _flat_params(jnet):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in jnet.params.items() for pn, a in lp.items()}


@pytest.fixture(params=["lenet", "alexnet"])
def saved(request, tmp_path):
    conf = narrow_lenet() if request.param == "lenet" else narrow_alexnet()
    jnet = JMultiLayerNetwork(conf).init()
    path = tmp_path / f"{request.param}.zip"
    jax_serializer.write_model(jnet, str(path))
    return jnet, path


def test_checkpoint_from_jax_serves_the_same_output(saved):
    jnet, path = saved
    net = restore_model(str(path), device="cpu")
    x = _inputs(jnet.conf, 5)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)),
                               rtol=rtol, atol=atol)


def test_params_from_numpy_carries_jax_weights(saved):
    jnet, _ = saved
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init(
        params=params_from_numpy(_flat_params(jnet), "cpu"))
    x = _inputs(jnet.conf, 3, seed=1)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_valid,bucket", [(1, 1), (3, 4), (5, 8)])
def test_output_padded_matches_jax(saved, n_valid, bucket):
    jnet, path = saved
    net = restore_model(str(path), device="cpu")
    x = _inputs(jnet.conf, bucket, seed=2)
    x[n_valid:] = 0.0
    got = net.output_padded(x, n_valid).numpy()
    assert got.shape[0] == n_valid
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(
        got, np.asarray(jnet.output_padded(x, n_valid)),
        rtol=rtol, atol=atol)
    np.testing.assert_array_equal(got, net.output(x).numpy()[:n_valid])


def test_output_padded_rejects_bad_row_counts(saved):
    jnet, path = saved
    net = restore_model(str(path), device="cpu")
    x = _inputs(jnet.conf, 2)
    for bad in (0, 3):
        with pytest.raises(ValueError, match="n_valid"):
            net.output_padded(x, bad)


def test_lenet_matches_jax_pallas_kernel_route(tmp_path, monkeypatch):
    """The JAX LeNet with its Pallas kernels forced on (interpreted on
    the CPU), against the port on the same weights."""
    jnet = JMultiLayerNetwork(narrow_lenet()).init()
    x = _inputs(jnet.conf, 4, seed=3)
    monkeypatch.setenv("DL4J_TPU_PALLAS", "1")
    jax_dispatch.reset_for_tests()
    ref = np.asarray(jnet.output(x))
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_dict(jnet.conf.to_dict()),
        device="cpu").init(params=params_from_numpy(_flat_params(jnet),
                                                    "cpu"))
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(net.output(x).numpy(), ref, rtol=rtol,
                               atol=atol)


def test_dense_without_epilogue_takes_plain_path():
    """A sigmoid dense layer is no kernel epilogue: plain addmm + act."""
    jnet = JMultiLayerNetwork(narrow_lenet("sigmoid")).init()
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init(params=params_from_numpy(_flat_params(jnet),
                                                    "cpu"))
    x = _inputs(jnet.conf, 2)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)),
                               rtol=rtol, atol=atol)
    assert dispatch.launch_counts() == {
        "conv_block": 0, "conv_bwd_data": 0, "conv_bwd_w": 0,
        "matmul_block": 0}


def test_checkpoint_from_port_restores_in_jax(tmp_path):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_dict(narrow_lenet().to_dict()),
        device="cpu").init()
    path = tmp_path / "port.zip"
    write_model(net, path)
    jnet = jax_serializer.restore_model(str(path), load_updater=False)
    x = _inputs(net.conf, 3)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("build", ["narrow_lenet", "narrow_alexnet"])
def test_configuration_json_round_trips(build):
    jconf = globals()[build]()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert conf.to_dict() == jconf.to_dict()
    again = MultiLayerConfiguration.from_json(conf.to_json())
    assert again == conf


@pytest.mark.parametrize("name", ["lenet", "alexnet"])
def test_zoo_builders_match_jax(name):
    port = getattr(port_zoo, name)().to_dict()
    ref = json.loads(json.dumps(getattr(jax_zoo, name)().to_dict()))
    assert port == ref


def test_init_draws_every_param_with_jax_shapes():
    jconf = narrow_alexnet()
    jnet = JMultiLayerNetwork(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu").init()
    shapes = {k: tuple(v.shape) for k, v in _flat_params(jnet).items()}
    got = {f"{ln}/{pn}": tuple(t.shape)
           for ln, lp in net.params.items() for pn, t in lp.items()}
    assert got == shapes
    w = net.params["0"]["W"]
    fan_in, fan_out = 3 * 11 * 11, 8 * 11 * 11
    assert abs(float(w.std()) - np.sqrt(2.0 / (fan_in + fan_out))) < 5e-3


def test_init_rejects_missing_layer_params():
    conf = MultiLayerConfiguration.from_dict(narrow_lenet().to_dict())
    with pytest.raises(ValueError, match="no params for layer '0'"):
        MultiLayerNetwork(conf, device="cpu").init(params={})


@pytest.mark.parametrize("name", jax_activations.names())
def test_activation_matches_jax(name):
    x = np.linspace(-4.0, 4.0, 41, dtype=np.float32).reshape(1, 41)
    got = activations.get(name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_activations.get(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_activation_names_are_the_same_23():
    assert activations.names() == jax_activations.names()
    assert len(activations.names()) == 23


@pytest.mark.parametrize("pooling_type", ["MAX", "AVG", "SUM"])
@pytest.mark.parametrize("kernel,stride,padding", [
    ((2, 2), (2, 2), (0, 0)),
    ((3, 3), (2, 2), (1, 1)),
    ((3, 2), (1, 2), (1, 0)),
])
def test_pooling_matches_jax(pooling_type, kernel, stride, padding):
    x = np.random.RandomState(4).randn(2, 3, 9, 8).astype(np.float32)
    kw = dict(pooling_type=pooling_type, kernel_size=kernel, stride=stride,
              padding=padding)
    got, _ = SubsamplingLayer(**kw).apply({}, torch.from_numpy(x), {})
    ref, _ = JPool(**kw).apply({}, jnp.asarray(x), {})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_port_import_keeps_jax_on_cpu():
    # both packages share this process; JAX stays on the CPU backend
    assert jax.default_backend() == "cpu"

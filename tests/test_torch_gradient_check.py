"""The port's f64 gradient check (``nn/gradient_check.py``) on the CPU.

- ``check_gradients`` passes, as the JAX package's does on the same
  configuration and weights, on an MLP (with L1/L2, and with dropout and
  drop-connect under a fixed key), a small CNN, a GravesLSTM, a
  VariationalAutoencoder, an AutoEncoder and an RBM under an output
  layer: central differences in f64 (eps 1e-6) against autograd through
  the kernels' plain versions and their hand-written backwards
  (maxRelError 1e-3, minAbsError 1e-8, the reference's);
- it fails on a planted wrong gradient (the dense layer's weight
  gradient scaled by 1.01), so the check can fail;
- it runs where it is told: without a card ``device="cuda"`` raises,
  and it never falls back to the CPU on its own; ``f64_mode`` restores
  torch's default dtype.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import (
    NeuralNetConfiguration as JNeuralNetConfiguration,
)
from deeplearning4j_tpu.nn.gradient_check import (
    check_gradients as jcheck_gradients,
)
from deeplearning4j_tpu.nn.layers import RBM as JRBM
from deeplearning4j_tpu.nn.layers import AutoEncoder as JAutoEncoder
from deeplearning4j_tpu.nn.layers import (
    ConvolutionLayer as JConv,
)
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import (
    GaussianReconstructionDistribution as JGaussian,
)
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.layers import VariationalAutoencoder as JVAE
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork,
)
from deeplearning4j_tpu_torch.nn import random
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.gradient_check import (
    check_gradients,
    f64_mode,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy


def _builder(**kw):
    b = JNeuralNetConfiguration.Builder().seed(12345)
    if kw.get("drop"):
        b = b.use_drop_connect(True).dropout(0.5)
    return b.list()


def _mlp(act="tanh", l1=0.0, l2=0.0, drop=False):
    return (_builder(drop=drop)
            .layer(JDense(n_in=4, n_out=5, activation=act, l1=l1, l2=l2))
            .layer(JOutput(n_out=3, loss="MCXENT", l1=l1, l2=l2))
            .build())


def _cnn():
    return (_builder()
            .layer(JConv(n_out=3, kernel_size=(3, 3), activation="relu"))
            .layer(JPool(pooling_type="MAX", kernel_size=(2, 2),
                         stride=(2, 2)))
            .layer(JOutput(n_out=3, loss="MCXENT"))
            .set_input_type(JInputType.convolutional(6, 6, 1))
            .build())


def _lstm():
    return (_builder()
            .layer(JGravesLSTM(n_in=3, n_out=4, activation="tanh"))
            .layer(JRnnOutput(n_out=2, loss="MCXENT"))
            .build())


def _vae():
    return (_builder()
            .layer(JVAE(n_in=4, n_out=3, encoder_layer_sizes=(5,),
                        decoder_layer_sizes=(5,), activation="tanh",
                        reconstruction_distribution=JGaussian()))
            .layer(JOutput(n_out=3, loss="MCXENT"))
            .build())


def _pretrain_stack(layer):
    return (_builder().layer(layer)
            .layer(JOutput(n_out=3, loss="MCXENT")).build())


def _data(kind, seed=0):
    r = np.random.RandomState(seed)
    if kind == "cnn":
        x = r.randn(4, 1, 6, 6)
    elif kind == "lstm":
        x = r.randn(3, 3, 5)
        return x, np.eye(2)[r.randint(0, 2, (3, 5))].transpose(0, 2, 1)
    else:
        x = r.randn(8, 4)
    return x, np.eye(3)[r.randint(0, 3, x.shape[0])]


CASES = {
    "mlp_tanh": (lambda: _mlp("tanh"), "mlp", {}),
    "mlp_relu": (lambda: _mlp("relu"), "mlp", {}),
    "mlp_l1_l2": (lambda: _mlp("tanh", 0.01, 0.02), "mlp", {}),
    "mlp_dropout_drop_connect": (lambda: _mlp("tanh", drop=True), "mlp",
                                 {"train": True}),
    "cnn": (_cnn, "cnn", {}),
    "lstm": (_lstm, "lstm", {"max_per_param": 12}),
    "vae": (_vae, "mlp", {}),
    "autoencoder": (lambda: _pretrain_stack(
        JAutoEncoder(n_in=4, n_out=5, activation="sigmoid")), "mlp", {}),
    "rbm": (lambda: _pretrain_stack(JRBM(n_in=4, n_out=5)), "mlp", {}),
}


def _pair(jconf):
    jnet = JMultiLayerNetwork(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init(params=params_from_numpy(
            {f"{ln}/{pn}": np.asarray(a) for ln, lp in jnet.params.items()
             for pn, a in lp.items()}, "cpu"))
    return jnet, net


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_gradients_passes_as_jaxs_does(case):
    build, kind, kw = CASES[case]
    jnet, net = _pair(build())
    x, y = _data(kind)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("train"):  # one frozen mask for every evaluation
        jkw["rng_key"] = jax.random.PRNGKey(7)
        tkw["rng_key"] = random.host_key(7)
    assert jcheck_gradients(jnet, x, y, **jkw)
    assert check_gradients(net, x, y, print_results=True, **tkw)
    # the model itself is untouched: f32 on its device
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for lp in net.params.values() for t in lp.values())


def test_check_gradients_fails_on_a_planted_wrong_gradient(monkeypatch,
                                                          capsys):
    import importlib

    mb = importlib.import_module("deeplearning4j_tpu_torch.ops.matmul_block")
    right = mb._MatmulBlockFn.backward

    def wrong(ctx, g):
        dx, dw, *rest = right(ctx, g)
        return (dx, None if dw is None else dw * 1.01, *rest)

    _, net = _pair(_mlp("relu"))
    x, y = _data("mlp")
    assert check_gradients(net, x, y)
    monkeypatch.setattr(mb._MatmulBlockFn, "backward", staticmethod(wrong))
    assert not check_gradients(net, x, y, print_results=True)
    # only the dense layer's W fails: its bias and the output layer pass
    fails = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("FAIL")]
    assert len(fails) == 20  # every element of W [4, 5]
    assert all(line.startswith("FAIL 0.W[") for line in fails)


def test_check_gradients_runs_where_it_is_told():
    _, net = _pair(_mlp())
    x, y = _data("mlp")
    before = torch.get_default_dtype()
    with f64_mode("cpu") as dev:
        assert dev == torch.device("cpu")
        assert torch.get_default_dtype() == torch.float64
    assert torch.get_default_dtype() == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check_gradients(net, x, y, device="cuda")
    assert torch.get_default_dtype() == before

"""The whole-net transforms in the port (``nn/core.py``
``set_transforms``, the Builder's ``scan_layers`` / ``remat`` /
``loss_scale``), on the CPU.

JAX's contract (its ``nn/core.py`` ``set_transforms``): a transform
changes how a step runs, never the math, so the trajectory is the same
with it on or off. Here that is held bitwise: three steps of a conv net
with BatchNormalization (the sequential engine), a tiny ResNet (the
graph engine) and a 2-layer transformer LM, with ``remat`` ``none``,
``full`` and ``dots_saveable`` and ``scan_layers`` off and on, give the
same scores, weights, updater state and layer state, bit for bit. Remat
does run: under ``full`` the backward recomputes each layer's forward
(the conv forward's plain version is called once more a conv). The
hints stay out of ``configuration.json``, ``megastep`` takes K >= 1
(tests/test_torch_megastep.py holds its chunks), and ``dots_saveable``
recomputes as ``full`` (the port's kernels are no ATen operators that a
selective checkpoint policy could keep).
"""

import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import (
    InputType,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo import resnet50, transformer_lm

SETTINGS = [dict(remat="none", scan_layers=False),
            dict(remat="full", scan_layers=False),
            dict(remat="dots_saveable", scan_layers=False),
            dict(remat="none", scan_layers=True),
            dict(remat="full", scan_layers=True)]


def conv_bn_net(**hints):
    b = (NeuralNetConfiguration.Builder().seed(4).updater("NESTEROVS")
         .learning_rate(0.05))
    for k, v in hints.items():
        getattr(b, k)(v)
    return (b.list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(SubsamplingLayer(pooling_type="MAX"))
            .layer(ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                    activation="tanh"))
            .layer(DenseLayer(n_out=12, activation="relu"))
            .layer(OutputLayer(n_out=3, loss="MCXENT"))
            .set_input_type(InputType.convolutional(10, 10, 2))
            .build())


def _batches(n, shape, classes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shape).astype(np.float32),
             np.eye(classes, dtype=np.float32)[rng.randint(0, classes,
                                                           shape[0])])
            for _ in range(n)]


def _lm_batches(n, vocab=9, t=8, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (batch, t + 1))
        out.append((np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
                    np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))))
    return out


def _trees(model):
    out = {}
    for name, tree in (("p", model.params), ("s", model.state),
                       ("u", model.updater_state)):
        for ln, lp in tree.items():
            for k, v in lp.items():
                for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                    out[f"{name}:{ln}/{k}/{i}"] = t.detach().clone()
    return out


def _trajectory(make, batches, wrap, settings, via_builder):
    """Scores and final trees of 3 steps of ``make(**hints)`` with the
    transforms given to the Builder or set at run time."""
    hints = dict(settings)
    model = make(**hints) if via_builder else make()
    if not via_builder:
        model.set_transforms(**hints)
    assert model.remat == hints["remat"]
    assert model.scan_layers == hints["scan_layers"]
    scores = []
    for x, y in batches:
        model.fit(wrap(x, y))
        scores.append(model._last_score.clone())
    return scores, _trees(model)


def _assert_same(a, b):
    (sa, ta), (sb, tb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _graph(remat="none", scan_layers=False):
    """The tiny ResNet with ``remat`` through the zoo's Builder (whose
    signature has no ``scan_layers``: that one is set at run time)."""
    g = ComputationGraph(resnet50(
        height=8, width=8, channels=1, n_classes=3, cifar_stem=True,
        depths=(1, 1), base_width=4, learning_rate=0.01, remat=remat),
        device="cpu").init()
    return g.set_transforms(scan_layers=scan_layers)


CASES = {
    "multilayer": (
        lambda **h: MultiLayerNetwork(conv_bn_net(**h), device="cpu").init(),
        lambda: _batches(3, (4, 2, 10, 10), 3, 1),
        lambda x, y: DataSet(x, y)),
    "graph": (
        _graph,
        lambda: _batches(3, (4, 1, 8, 8), 3, 2),
        lambda x, y: MultiDataSet([x], [y])),
    "transformer": (
        lambda **h: MultiLayerNetwork(transformer_lm(
            vocab=9, d_model=16, n_layers=2, n_heads=2, learning_rate=1e-3,
            **h), device="cpu").init(),
        lambda: _lm_batches(3),
        lambda x, y: DataSet(x, y)),
}


@pytest.mark.parametrize("settings", SETTINGS[1:],
                         ids=lambda s: f"{s['remat']}-scan{s['scan_layers']}")
@pytest.mark.parametrize("engine", sorted(CASES))
def test_transforms_leave_the_trajectory_bitwise(engine, settings):
    """The transforms from the Builder and set at run time: both the
    trajectory without them, bit for bit."""
    make, batches, wrap = CASES[engine]
    data = batches()
    plain = _trajectory(make, data, wrap, SETTINGS[0], via_builder=False)
    for via_builder in (True, False):
        _assert_same(plain, _trajectory(make, data, wrap, settings,
                                        via_builder))


def test_remat_recomputes_the_forward_in_the_backward(monkeypatch):
    """Under ``full`` (and ``dots_saveable``) each conv's plain forward
    runs once more a step (its recompute in the backward, besides the
    conv's own f32 recompute); under ``none`` it does not."""
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    calls = []
    inner = cb._plain_forward

    def counting(*args):
        calls.append(args[-2])
        return inner(*args)

    monkeypatch.setattr(cb, "_plain_forward", counting)
    (x, y), = _batches(1, (4, 2, 10, 10), 3, 5)
    counts = {}
    for policy in ("none", "full", "dots_saveable"):
        net = MultiLayerNetwork(conv_bn_net(remat=policy), device="cpu")
        net.init()
        calls.clear()
        net.fit(DataSet(x, y))
        counts[policy] = len(calls)
    # two convs: forward + f32 recompute each; remat adds one forward each
    assert counts == {"none": 4, "full": 6, "dots_saveable": 6}


def test_transform_hints_and_their_limits():
    conf = conv_bn_net(remat="full", scan_layers=True, loss_scale=512.0)
    assert (conf.remat, conf.scan_layers, conf.loss_scale) == (
        "full", True, 512.0)
    d = conf.to_dict()
    for key in ("remat", "scan_layers", "loss_scale"):
        assert key not in d
    net = MultiLayerNetwork(conf, device="cpu")
    assert (net.remat, net.scan_layers, net.loss_scale) == (
        "full", True, 512.0)
    assert net.set_transforms(megastep=1) is net
    assert net.set_transforms(megastep=4).megastep == 4
    with pytest.raises(ValueError, match="megastep"):
        net.set_transforms(megastep=0)
    with pytest.raises(ValueError, match="remat policy"):
        net.set_transforms(remat="some")
    net.set_transforms(loss_scale=True)
    assert net.loss_scale == core.DEFAULT_LOSS_SCALE
    net.set_transforms(loss_scale=0)
    assert net.loss_scale is None
    g = ComputationGraph(resnet50(height=8, width=8, channels=1,
                                  n_classes=3, cifar_stem=True,
                                  depths=(1, 1), base_width=4,
                                  remat="dots_saveable", loss_scale=True),
                         device="cpu")
    assert g.remat == "dots_saveable"
    assert g.loss_scale == core.DEFAULT_LOSS_SCALE
    assert g._loss_scale_active is False  # f32 compute

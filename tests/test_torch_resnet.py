"""The port's ResNet-50 slice against the JAX package, on the CPU:
``ActivationLayer``, the zoo's ``resnet50`` (its configuration at the
published widths, and two small variants: the CIFAR stem at 8 x 8 and
the 7 x 7 stride-2 stem with its max pool at 32 x 32) through
``output``, ``score`` and three NESTEROVS steps on carried weights, the
checkpoint zip both ways, uint8 features cast on the device, and the
kernel routes pinned at the 23 conv shapes of a batch-128 step.

Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5), the same
math summed in other orders; the activation layer, the configurations
and the checkpoint's arrays are held exactly. The inputs have no exact
zeros in front of a relu (its gradient at 0 differs between the port's
kernel route and JAX's XLA route; ResNet's relus follow BN, whose
output is almost surely nonzero).
"""

import importlib
import json

import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import ActivationLayer as JActivation
from deeplearning4j_tpu.nn.layers.base import layer_from_json as jlayer_from_json
from deeplearning4j_tpu.nn.layers.base import layer_to_json as jlayer_to_json
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    layer_from_json,
    layer_to_json,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_numpy,
    restore_computation_graph,
    write_model,
)
from deeplearning4j_tpu_torch.zoo import resnet50

import chip_smoke

CIFAR_TINY = dict(height=8, width=8, channels=1, n_classes=3,
                  cifar_stem=True, depths=(1, 1), base_width=4)
STEM_TINY = dict(height=32, width=32, channels=3, n_classes=5,
                 depths=(1, 1), base_width=4)


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "identity"])
@pytest.mark.parametrize("shape", [(3, 4, 5, 5), (6, 7)])
def test_activation_layer_matches_jax(act, shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    got, st = ActivationLayer(activation=act).apply({}, torch.from_numpy(x),
                                                    {})
    want, _ = JActivation(activation=act).apply({}, x, {})
    assert st == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    d = layer_to_json(ActivationLayer(activation=act))
    assert d == jlayer_to_json(JActivation(activation=act))
    assert layer_from_json(d) == ActivationLayer(activation=act)
    assert jlayer_from_json(d) == JActivation(activation=act)


@pytest.mark.parametrize("kw", [{}, CIFAR_TINY, STEM_TINY,
                                dict(learning_rate=0.01, updater="ADAM",
                                     seed=3)],
                         ids=["published", "cifar_tiny", "stem_tiny",
                              "custom"])
def test_resnet50_configuration_matches_jax(kw):
    conf, jconf = resnet50(**kw), jax_zoo.resnet50(**kw)
    assert conf.to_dict() == jconf.to_dict()
    assert conf.topological_order() == jconf.topological_order()
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert back.to_dict() == conf.to_dict()
    if not kw:
        convs = [n for n in conf.topological_order()
                 if type(conf.vertices[n].layer()).__name__
                 == "ConvolutionLayer"]
        assert len(convs) == 53


def test_resnet50_published_widths_count_the_parameters():
    net = ComputationGraph(resnet50(), device="cpu").init()
    assert net.num_params() == 25_583_592


def test_resnet50_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="divisible by 32"):
        resnet50(height=100, width=100)
    # the transform hints are carried now; an unknown policy raises
    assert resnet50(remat="full").remat == "full"
    assert resnet50(loss_scale=True).loss_scale is True
    with pytest.raises(ValueError, match="remat policy"):
        resnet50(remat="everything")


def _batch(rng, kw, n):
    x = (rng.rand(n, kw["channels"], kw["height"], kw["width"]) * 0.9
         + 0.05).astype(np.float32)
    y = np.eye(kw["n_classes"], dtype=np.float32)[
        rng.randint(0, kw["n_classes"], n)]
    return x, y


@pytest.mark.parametrize("kw", [CIFAR_TINY, STEM_TINY],
                         ids=["cifar_tiny", "stem_tiny"])
def test_tiny_resnet_output_score_and_three_steps_match_jax(kw):
    jnet = JGraph(jax_zoo.resnet50(learning_rate=0.05, **kw)).init()
    net = ComputationGraph(resnet50(learning_rate=0.05, **kw),
                           device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    rng = np.random.RandomState(1)
    rtol, atol = kernel_tols()
    x, _ = _batch(rng, kw, 4)
    np.testing.assert_allclose(net.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0]), rtol=rtol,
                               atol=atol)
    for _ in range(3):
        x, y = _batch(rng, kw, 6)
        np.testing.assert_allclose(net.score(DataSet(x, y)),
                                   jnet.score(JDataSet(x, y)), rtol=rtol,
                                   atol=atol)
        net.fit(DataSet(x, y))
        jnet.fit(JDataSet(x, y))
        np.testing.assert_allclose(net.score_value,
                                   float(jnet.score_value), rtol=rtol,
                                   atol=atol)
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_allclose(net.params[ln][pn].numpy(), ref,
                                   rtol=rtol, atol=atol, err_msg=key)
    for ln, st in jnet.state.items():
        for k, ref in st.items():
            np.testing.assert_allclose(net.state[ln][k].numpy(),
                                       np.asarray(ref), rtol=rtol,
                                       atol=atol, err_msg=f"{ln}/{k}")


def test_resnet_checkpoint_moves_both_ways(tmp_path):
    """A trained tiny ResNet's zip (configuration, coefficients, the
    Nesterov velocities, BN's running statistics) from the port restores
    in the JAX package and back, every array exact."""
    net = ComputationGraph(resnet50(**STEM_TINY), device="cpu").init()
    rng = np.random.RandomState(2)
    net.fit(DataSet(*_batch(rng, STEM_TINY, 4)))
    path = tmp_path / "port.zip"
    write_model(net, path)
    jres = jax_serializer.restore_computation_graph(str(path))
    assert (json.loads(jres.conf.to_json())
            == json.loads(net.conf.to_json()))
    for key, ref in _flat(net.params).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_array_equal(np.asarray(jres.params[ln][pn]), ref)
    for ln, st in net.state.items():
        for k, ref in st.items():
            np.testing.assert_array_equal(np.asarray(jres.state[ln][k]),
                                          ref.numpy())
    back = tmp_path / "jax.zip"
    jax_serializer.write_model(jres, str(back))
    again = restore_computation_graph(str(back), device="cpu")
    for ln, lp in net.params.items():
        for pn, t in lp.items():
            assert torch.equal(again.params[ln][pn], t)
            for a, b in zip(again.updater_state[ln][pn],
                            net.updater_state[ln][pn]):
                assert torch.equal(a, b)
    for ln, st in net.state.items():
        for k, t in st.items():
            assert torch.equal(again.state[ln][k], t)


def test_uint8_features_cross_at_native_width_and_train_the_same(
        monkeypatch):
    """uint8 pixels move to the device as uint8 and are cast there: the
    trajectory equals the same values given in f32."""
    rng = np.random.RandomState(3)
    pixels = rng.randint(1, 256, (4, 3, 32, 32)).astype(np.uint8)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 4)]
    moved = []
    real_to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        moved.append((self.dtype, kwargs.get("dtype")))
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    t = core.to_device(pixels, "cpu", torch.float32)
    monkeypatch.undo()
    assert moved[0] == (torch.uint8, None)  # the move, at uint8
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), pixels.astype(np.float32))
    a = ComputationGraph(resnet50(learning_rate=0.05, **STEM_TINY),
                         device="cpu").init()
    b = ComputationGraph(a.conf, device="cpu").init(
        params={ln: dict(lp) for ln, lp in a.params.items()})
    for _ in range(2):
        a.fit(DataSet(pixels, y))
        b.fit(DataSet(pixels.astype(np.float32), y))
        assert a.score_value == b.score_value
    for ln, lp in a.params.items():
        for pn, t in lp.items():
            assert torch.equal(t, b.params[ln][pn])


# The kernel route of each distinct conv of ResNet-50's training step at
# 224 x 224, batch 128: (forward tile, dx route, dW route), fitted to
# scripts/torch_route_ab.py --sweep --only resnet50 (PERF.md); the stem
# takes no dx (its input is the data)
RESNET_ROUTES = {
    "stem": ("wide 32x256", None, "gemm"),
    "s0b0_c1": ("wide 32x256", "gemm", "gemm"),
    "s0b0_proj": ("wide 96x128", "gemm", "gemm"),
    "s0b0_c2": ("wide 32x256", "gemm", "gemm"),
    "s0b1_c1": ("wide 32x256", "gemm", "gemm"),
    "s1b0_c1": ("wide 128x128", "gemm", "gemm"),
    "s1b0_proj": ("wide 128x128", "gemm", "gemm"),
    "s1b0_c2": ("wide 128x128", "gemm", "gemm"),
    "s1b0_c3": ("wide 128x128", "gemm", "gemm"),
    "s1b1_c1": ("wide 128x128", "gemm", "gemm"),
    "s1b1_c2": ("wide 128x128", "gemm", "gemm"),
    "s2b0_c1": ("wide 128x128", "gemm", "gemm"),
    "s2b0_proj": ("wide 128x128", "gemm", "gemm"),
    "s2b0_c2": ("wide 128x128", "gemm", "gemm"),
    "s2b0_c3": ("wide 128x128", "gemm", "gemm"),
    "s2b1_c1": ("wide 128x128", "resident g16", "gemm"),
    "s2b1_c2": ("wide 128x128", "gemm", "gemm"),
    "s3b0_c1": ("wide 128x128", "gemm", "gemm"),
    "s3b0_proj": ("wide 128x128", "gemm", "gemm"),
    "s3b0_c2": ("wide 128x128", "resident g4", "gemm"),
    "s3b0_c3": ("wide 128x128", "gemm", "gemm"),
    "s3b1_c1": ("wide 128x128", "resident g32", "gemm"),
    "s3b1_c2": ("wide 128x128", "resident g4", "gemm"),
}


def _route_label(cb, kind, geo):
    args = (*geo["x"], geo["w"][0], *geo["w"][2:], tuple(geo["stride"]),
            tuple(geo["padding"]))
    if kind == "conv_block":
        r = cb.conv_block_route(*args)
        return f"wide {r.tile_o}x{r.tile_px}" if r.route == "wide" \
            else r.route
    if kind == "conv_bwd_data":
        r = cb.conv_bwd_data_route(*args)
        return f"resident g{r.group}" if r.route == "resident" else r.route
    return cb.conv_bwd_w_route(*args).route


def test_resnet50_step_shapes_and_routes_are_pinned():
    """23 distinct convs, 53 a forward; a step launches the forward
    twice (the f32 recompute), dW of every conv and dx of all but the
    stem: 106 + 52 + 53. Each shape takes the route fitted to it."""
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    shapes = chip_smoke.resnet_shapes()
    fwd = [s for s in shapes if s[1] == "conv_block"]
    assert len(fwd) == 23 and sum(len(s[3]) for s in fwd) == 53
    per_kind = {}
    for name, kind, geo, names in shapes:
        per_kind[kind] = per_kind.get(kind, 0) + len(names)
    assert per_kind == {"conv_block": 53, "conv_bwd_data": 52,
                        "conv_bwd_w": 53}
    got = {}
    for name, kind, geo, _ in shapes:
        got.setdefault(name, [None, None, None])[
            ("conv_block", "conv_bwd_data", "conv_bwd_w").index(kind)] = \
            _route_label(cb, kind, geo)
    assert {k: tuple(v) for k, v in got.items()} == RESNET_ROUTES

"""The port's GoogLeNet (``zoo.googlenet``) against the JAX package on the
CPU: its configuration at the published widths and at 64 x 64 (as JAX's
``tests/test_zoo.py`` builds it), the parameter count, ``output``,
``score`` and two NESTEROVS steps on the same weights (dropout 0.4 on the
output layer: the JAX package's masks, bit for bit), and the kernel
routes of every conv shape of a 224 x 224, batch-128 step pinned
(forward, backward-data, backward-weights), as
``tests/test_torch_resnet.py`` pins ResNet-50's.

Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5) on outputs
and scores; each weight after the steps within a tenth of its
parameter's largest move (57 convs deep: a pre-activation within
rounding of a relu's kink moves the gradients upstream of it). The
pixels are uniform in (0, 1): no relu sees an exact zero (its gradient
there differs between the port's kernel route and JAX's XLA route).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.datasets.api import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.datasets import MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.zoo import googlenet

import chip_smoke

# the kernel route of each conv vertex's forward, backward-data (None:
# the stem's input is the data) and backward-weights at batch 128, 224 x
# 224 (vertices with the same shape as an earlier one are that one's)
GOOGLENET_ROUTES = {
    "stem1": ("wide 32x256", None, "gemm"),
    "stem2r": ("wide 32x256", "gemm", "gemm"),
    "stem2": ("wide 96x128", "gemm", "gemm"),
    "inc3a_b1": ("wide 32x256", "gemm", "gemm"),
    "inc3a_b3r": ("wide 96x128", "gemm", "gemm"),
    "inc3a_b5r": ("wide 32x256", "resident g32", "image_resident"),
    "inc3a_b3": ("wide 128x128", "gemm", "gemm"),
    "inc3a_b5": ("wide 32x256", "resident g16", "image_resident"),
    "inc3a_pp": ("wide 32x256", "resident g32", "gemm"),
    "inc3b_b1": ("wide 128x128", "gemm", "gemm"),
    "inc3b_b5r": ("wide 32x256", "resident g32", "gemm"),
    "inc3b_b3": ("wide 96x256", "gemm", "gemm"),
    "inc3b_b5": ("wide 96x256", "gemm", "gemm"),
    "inc3b_pp": ("wide 32x256", "gemm", "gemm"),
    "inc4a_b1": ("wide 96x128", "resident g32", "gemm"),
    "inc4a_b3r": ("wide 96x128", "resident g32", "gemm"),
    "inc4a_b5r": ("wide 32x256", "resident g32", "image_resident"),
    "inc4a_b3": ("wide 128x128", "resident g8", "gemm"),
    "inc4a_b5": ("wide 32x256", "resident g16", "image_resident"),
    "inc4a_pp": ("wide 32x256", "resident g32", "gemm"),
    "inc4b_b1": ("wide 32x256", "resident g32", "gemm"),
    "inc4b_b3r": ("wide 128x128", "resident g32", "gemm"),
    "inc4b_b5r": ("wide 32x256", "resident g32", "image_resident"),
    "inc4b_b3": ("wide 128x128", "resident g4", "gemm"),
    "inc4b_b5": ("wide 32x256", "resident g24", "image_resident"),
    "inc4b_pp": ("wide 32x256", "resident g32", "gemm"),
    "inc4c_b1": ("wide 128x128", "resident g32", "gemm"),
    "inc4c_b3": ("wide 128x128", "gemm", "gemm"),
    "inc4d_b3r": ("wide 32x256", "resident g32", "gemm"),
    "inc4d_b5r": ("wide 32x256", "resident g32", "image_resident"),
    "inc4d_b3": ("wide 96x256", "gemm", "gemm"),
    "inc4d_b5": ("wide 32x256", "resident g16", "image_resident"),
    "inc4e_b1": ("wide 128x128", "resident g16", "gemm"),
    "inc4e_b3r": ("wide 32x256", "resident g32", "gemm"),
    "inc4e_b5r": ("wide 32x256", "resident g32", "image_resident"),
    "inc4e_b3": ("wide 96x256", "gemm", "gemm"),
    "inc4e_b5": ("wide 128x128", "resident g8", "image_resident"),
    "inc4e_pp": ("wide 128x128", "resident g32", "gemm"),
    "inc5a_b1": ("wide 128x128", "resident g32", "gemm"),
    "inc5a_b3r": ("wide 32x256", "resident g32", "gemm"),
    "inc5a_b5r": ("direct", "resident g32", "image_resident"),
    "inc5a_b3": ("wide 32x256", "resident g12", "gemm"),
    "inc5a_b5": ("wide 32x256", "resident g4", "image_resident"),
    "inc5a_pp": ("wide 32x256", "resident g32", "gemm"),
    "inc5b_b1": ("wide 96x256", "resident g32", "gemm"),
    "inc5b_b3r": ("wide 96x128", "resident g32", "gemm"),
    "inc5b_b5r": ("direct", "resident g32", "image_resident"),
    "inc5b_b3": ("wide 96x256", "resident g8", "gemm"),
    "inc5b_b5": ("wide 32x256", "resident g4", "image_resident"),
}


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


def _close(got, ref, rtol=None, atol=None, err_msg=""):
    krtol, katol = kernel_tols()
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref),
                               rtol=krtol if rtol is None else rtol,
                               atol=katol if atol is None else atol,
                               err_msg=err_msg)


@pytest.mark.parametrize("kw", [{}, dict(height=64, width=64,
                                         n_classes=10)])
def test_googlenet_configuration_matches_jax(kw):
    conf = googlenet(**kw)
    jconf = jax_zoo.googlenet(**kw)
    assert conf.to_dict() == jconf.to_dict()
    assert ComputationGraphConfiguration.from_json(
        jconf.to_json()).to_dict() == conf.to_dict()


def test_googlenet_counts_the_jax_parameters():
    """The published widths: every parameter's shape the JAX package's
    (its init traced abstractly), ~7M in all."""
    net = ComputationGraph(googlenet(), device="cpu").init()
    jshapes = jax.eval_shape(lambda: JGraph(jax_zoo.googlenet()).init()
                             .params)
    assert {ln: {pn: tuple(t.shape) for pn, t in lp.items()}
            for ln, lp in net.params.items()} == {
        ln: {pn: tuple(a.shape) for pn, a in lp.items()}
        for ln, lp in jshapes.items()}
    n = net.num_params()
    assert n == 6998552 and 5e6 < n < 8e6
    with pytest.raises(ValueError, match="divisible by 32"):
        googlenet(height=100, width=100)


def test_googlenet_64_matches_jax():
    """output, score and two NESTEROVS steps (dropout 0.4 on the output
    layer) on the same weights, at 64 x 64 and 10 classes: the port's
    initial weights carried into the JAX graph."""
    net = ComputationGraph(googlenet(height=64, width=64, n_classes=10),
                           device="cpu").init()
    init = {ln: {pn: t.numpy().copy() for pn, t in lp.items()}
            for ln, lp in net.params.items()}
    jnet = JGraph(jax_zoo.googlenet(height=64, width=64,
                                    n_classes=10)).init(params={
        ln: {pn: jnp.asarray(a) for pn, a in lp.items()}
        for ln, lp in init.items()})
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 64, 64).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 2)]
    _close(net.output(x)[0], jnet.output(x)[0])
    mds, jmds = MultiDataSet([x], [y]), JMultiDataSet(features=[x],
                                                      labels=[y])
    _close(net.score(mds), float(jnet.score(jmds)), 1e-5, 0)
    for _ in range(2):
        s = net.fit_minibatch(mds)
        js = jnet.fit_minibatch(jmds)
        _close(s, float(js), 1e-5, 0)
    # each parameter within a tenth of its largest move in the two
    # steps: a pre-activation within rounding of a relu's kink takes
    # another side in the two packages and moves the gradients upstream
    # of it (the largest share seen: 0.063, at inc3b_b3/W)
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        move = np.abs(ref - init[ln][pn]).max()
        diff = np.abs(net.params[ln][pn].numpy() - ref).max()
        assert diff <= 0.1 * move + 1e-7, (key, diff, move)


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


def test_googlenet_step_shapes_and_routes_are_pinned():
    """57 convs, 49 distinct shapes; a step launches the forward twice
    (the f32 recompute), dW of every conv and dx of all but the stem:
    114 + 56 + 57. Each shape's route pinned (the card holds each
    against its plain version: ``chip_smoke.py``'s ``googlenet.``
    records)."""
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    shapes = chip_smoke.googlenet_shapes()
    fwd = [s for s in shapes if s[1] == "conv_block"]
    assert len(fwd) == 49 and sum(len(s[3]) for s in fwd) == 57
    per_kind = {}
    for name, kind, geo, names in shapes:
        per_kind[kind] = per_kind.get(kind, 0) + len(names)
        assert geo["x"][0] == chip_smoke.GOOGLENET_BATCH == 128
    assert per_kind == {"conv_block": 57, "conv_bwd_data": 56,
                        "conv_bwd_w": 57}
    got = {}
    for name, kind, geo, _ in shapes:
        got.setdefault(name, [None, None, None])[
            ("conv_block", "conv_bwd_data", "conv_bwd_w").index(kind)] = \
            _route_label(cb, kind, geo)
    assert {k: tuple(v) for k, v in got.items()} == GOOGLENET_ROUTES

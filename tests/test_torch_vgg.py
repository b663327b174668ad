"""The port's VGG-16 slice against the JAX package, on the CPU: the zoo
configuration, the full-width network's forward on carried weights, and
the synthetic CIFAR-10 iterator.

Tolerances: ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5) on the
softmax output, on the activations after the last pool and the second
dense layer (relative to their largest entry), and on the score and
every weight after three NESTEROVS steps, the same math summed in other
orders over 13 convs; the data iterator is held bit for bit. The
training data has no exact zeros (relu's gradient at z == 0 differs
between the port's kernel route and JAX's XLA route).
"""

import warnings

import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets.cifar import (
    CifarDataSetIterator as JCifarDataSetIterator,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.zoo import models as jax_zoo
from deeplearning4j_tpu_torch.datasets import CifarDataSetIterator, DataSet
from deeplearning4j_tpu_torch.datasets import cifar
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy
from deeplearning4j_tpu_torch.zoo import vgg16


def _flat(tree):
    return {f"{ln}/{pn}": np.asarray(a)
            for ln, lp in tree.items() for pn, a in lp.items()}


@pytest.mark.parametrize("kw", [{}, dict(height=64, width=48, n_classes=7,
                                         dense_width=64, learning_rate=0.1,
                                         updater="ADAM", seed=3)],
                         ids=["defaults", "custom"])
def test_vgg16_configuration_matches_jax(kw):
    conf, jconf = vgg16(**kw), jax_zoo.vgg16(**kw)
    assert conf.to_dict() == jconf.to_dict()
    assert conf.topological_order() == jconf.topological_order()
    convs = [n for n in conf.topological_order() if n.startswith("conv")]
    assert len(convs) == 13
    fc0 = conf.vertices["fc0"]
    assert fc0.preprocessor is not None and fc0.layer_conf.n_in == (
        512 * (kw.get("height", 32) // 32) * (kw.get("width", 32) // 32))


@pytest.fixture(scope="module")
def vgg_pair():
    jnet = JGraph(jax_zoo.vgg16()).init()
    net = ComputationGraph(vgg16(), device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    return jnet, net


def test_vgg16_num_params_match_jax(vgg_pair):
    jnet, net = vgg_pair
    assert net.num_params() == jnet.num_params() == 15_245_130
    fresh = ComputationGraph(vgg16(), device="cpu").init()
    assert {k: v.shape for k, v in _flat(fresh.params).items()} == {
        k: v.shape for k, v in _flat(jnet.params).items()}


def test_vgg16_full_width_output_matches_jax(vgg_pair):
    jnet, net = vgg_pair
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    rtol, atol = kernel_tols()
    acts = net.feed_forward(x)
    jacts = jnet.feed_forward(x)
    for name in ("conv0", "pool1", "pool4", "fc1", "out"):
        got = acts[name].numpy()
        want = np.asarray(jacts[name])
        # held relative to the activation's own scale
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                                   atol=atol, err_msg=name)
    out = net.output(x)[0].numpy()
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)[0]),
                               rtol=rtol, atol=atol)
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-6)


def test_vgg16_score_and_three_nesterovs_steps_match_jax(vgg_pair):
    jnet = vgg_pair[0].copy()
    net = ComputationGraph(vgg16(), device="cpu").init(
        params=params_from_numpy(_flat(jnet.params), "cpu"))
    rng = np.random.RandomState(2)
    rtol, atol = kernel_tols()
    for _ in range(3):
        x = (rng.rand(4, 3, 32, 32) * 0.9 + 0.05).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)]
        np.testing.assert_allclose(net.score(DataSet(x, y)),
                                   jnet.score(JDataSet(x, y)), rtol=rtol,
                                   atol=atol)
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.score_value,
                                   float(jnet.score_value), rtol=rtol,
                                   atol=atol)
    for key, ref in _flat(jnet.params).items():
        ln, pn = key.rsplit("/", 1)
        np.testing.assert_allclose(net.params[ln][pn].numpy(), ref,
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("train,shuffle,flat", [(True, True, False),
                                                (False, False, True)])
def test_synthetic_cifar_batches_match_jax(train, shuffle, flat):
    kw = dict(num_examples=70, train=train, seed=9, shuffle=shuffle,
              flat=flat, allow_synthetic=True, data_dir="/nonexistent")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        it = CifarDataSetIterator(32, **kw)
        jit = JCifarDataSetIterator(32, **kw)
    assert it.synthetic and jit.synthetic
    assert it.total_examples() == jit.total_examples() == 70
    got, want = list(it), list(jit)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.features, np.asarray(b.features))
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
        assert a.features.dtype == np.float32
    assert got[0].features.shape == ((32, 3072) if flat else
                                     (32, 3, 32, 32))


def test_cifar_needs_an_opt_in_without_data(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_ALLOW_SYNTHETIC", raising=False)
    with pytest.raises(FileNotFoundError, match="CIFAR-10"):
        CifarDataSetIterator(8, data_dir="/nonexistent")


def test_cifar_binary_batches_are_read(tmp_path):
    """The binary distribution, when present, is read before any
    synthetic data: one label byte and 3072 RGB bytes a record."""
    rng = np.random.RandomState(1)
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    images = rng.randint(0, 256, (5, 4, 3072)).astype(np.uint8)
    labels = rng.randint(0, 10, (5, 4)).astype(np.uint8)
    for i in range(5):
        rec = np.concatenate([labels[i][:, None], images[i]], axis=1)
        (d / f"data_batch_{i + 1}.bin").write_bytes(rec.tobytes())
    it = CifarDataSetIterator(20, data_dir=str(tmp_path), shuffle=False)
    assert not it.synthetic and it.total_examples() == 20
    ds = it.next()
    np.testing.assert_array_equal(
        ds.features.reshape(20, -1),
        images.reshape(20, -1).astype(np.float32) / np.float32(255.0))
    np.testing.assert_array_equal(ds.labels.argmax(1), labels.reshape(-1))
    (d / "data_batch_1.bin").write_bytes(b"\0" * 3074)
    with pytest.raises(ValueError, match="3073"):
        cifar.read_bin(str(d / "data_batch_1.bin"))


# (vertex, x shape, w shape, forward route and tile, dx route and channel
# group, dW route): the kernel routes of VGG-16's convs at batch 128, as
# scripts/torch_route_ab.py --sweep measured them on the card (PERF.md).
# The forward takes 128 x 128 tiles at the 8 x 8 convs (one block an SM
# on a grid short of a round) and the direct tile at 2 x 2; dx stays on
# the resident route at 16 x 16 (16-channel groups) and takes 4-channel
# groups, two blocks an SM, at 8 x 8; dW takes the implicit GEMM at every
# conv (the image-resident route's blocks would walk 43-128 images).
VGG_ROUTES = [
    ("conv0", (128, 3, 32, 32), (64, 3, 3, 3), ("wide", 32, 256), None,
     "gemm"),
    ("conv1", (128, 64, 32, 32), (64, 64, 3, 3), ("wide", 32, 256),
     ("gemm", 0), "gemm"),
    ("conv2", (128, 64, 16, 16), (128, 64, 3, 3), ("wide", 128, 128),
     ("resident", 16), "gemm"),
    ("conv3", (128, 128, 16, 16), (128, 128, 3, 3), ("wide", 128, 128),
     ("resident", 16), "gemm"),
    ("conv4", (128, 128, 8, 8), (256, 128, 3, 3), ("wide", 128, 128),
     ("resident", 4), "gemm"),
    ("conv5", (128, 256, 8, 8), (256, 256, 3, 3), ("wide", 128, 128),
     ("resident", 4), "gemm"),
    ("conv7", (128, 256, 4, 4), (512, 256, 3, 3), ("wide", 32, 256),
     ("gemm", 0), "gemm"),
    ("conv8", (128, 512, 4, 4), (512, 512, 3, 3), ("wide", 32, 256),
     ("gemm", 0), "gemm"),
    ("conv10", (128, 512, 2, 2), (512, 512, 3, 3), ("direct", 0, 0),
     ("gemm", 0), "gemm"),
]


@pytest.mark.parametrize("name,xs,ws,fwd,dx,dw", VGG_ROUTES,
                         ids=[r[0] for r in VGG_ROUTES])
def test_vgg16_kernel_routes_pin_the_measured_choices(name, xs, ws, fwd, dx,
                                                      dw):
    from deeplearning4j_tpu_torch.ops.conv_block import (
        SM_SMEM_BYTES,
        conv_block_route,
        conv_bwd_data_route,
        conv_bwd_w_route,
    )

    n, c, h, w = xs
    o, _, kh, kw = ws
    plan = conv_block_route(n, c, h, w, o, kh, kw, (1, 1), (1, 1))
    assert (plan.route, plan.tile_o, plan.tile_px) == fwd
    if dx is not None:
        plan = conv_bwd_data_route(n, c, h, w, o, kh, kw, 1, 1)
        assert (plan.route, plan.group) == dx
        if dx == ("resident", 4):
            assert 2 * (plan.smem_bytes + 1024) <= SM_SMEM_BYTES
    assert conv_bwd_w_route(n, c, h, w, o, kh, kw, 1, 1).route == dw


def test_vgg16_shapes_are_the_zoo_models():
    """VGG_ROUTES covers every conv of zoo.vgg16() at batch 128."""
    conf = vgg16()
    it = {"in": conf.input_types[0]}
    seen = set()
    for name in conf.topological_order():
        v = conf.vertices[name]
        src = it[conf.vertex_inputs[name][0]]
        it[name] = v.output_type([src])
        if name.startswith("conv"):
            seen.add(((128, src.channels, src.height, src.width),
                      (v.layer_conf.n_out, v.layer_conf.n_in, 3, 3)))
    assert seen == {(r[1], r[2]) for r in VGG_ROUTES}

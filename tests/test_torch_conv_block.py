"""The port's fused conv (``deeplearning4j_tpu_torch.ops.conv_block``)
against the JAX package's, on the CPU.

On a CPU tensor the port's ``conv_block`` runs its plain PyTorch
version; it is held against the JAX package's XLA reference
(``conv_block_reference``) and against the JAX Pallas kernel run
through the Pallas interpreter, on the same numpy inputs. Tolerance:
``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5) — both sides sum in f32,
in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.ops import conv_block as jax_conv_block
from deeplearning4j_tpu.ops import conv_block_reference as jax_conv_ref
from deeplearning4j_tpu_torch.ops import (
    SUPPORTED_EPILOGUES,
    conv_block,
    conv_block_reference,
    dispatch,
)

# (x shape, w shape, stride, padding)
GEOMETRIES = [
    ((2, 3, 9, 7), (5, 3, 3, 3), (1, 1), (0, 0)),
    ((2, 3, 9, 7), (5, 3, 3, 3), (1, 1), (1, 1)),
    ((2, 3, 9, 7), (5, 3, 3, 3), (2, 2), (1, 1)),
    ((2, 3, 9, 7), (5, 3, 3, 3), (2, 1), (2, 0)),   # asymmetric
    ((1, 4, 10, 8), (6, 4, 5, 2), (1, 3), (0, 1)),  # odd kernel and map
    ((2, 3, 35, 35), (8, 3, 11, 11), (4, 4), (2, 2)),  # AlexNet conv1-like
]


def _data(xs, ws, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(*ws) * 0.2).astype(np.float32)
    o = ws[0]
    bias = (rng.randn(o) * 0.1).astype(np.float32)
    scale = (rng.rand(o) + 0.5).astype(np.float32)
    shift = (rng.randn(o) * 0.1).astype(np.float32)
    return x, w, bias, scale, shift


def _port(arrays, **kw):
    out = conv_block(*(torch.from_numpy(a) for a in arrays), **kw)
    return out.numpy()


@pytest.mark.parametrize("xs,ws,stride,padding", GEOMETRIES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_conv_block_matches_jax_reference(xs, ws, stride, padding,
                                          activation):
    arrays = _data(xs, ws)
    got = _port(arrays, stride=stride, padding=padding,
                activation=activation)
    ref = jax_conv_ref(
        *(jnp.asarray(a) for a in arrays), stride=stride, padding=padding,
        activation=activation)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("xs,ws,stride,padding", [
    GEOMETRIES[1], GEOMETRIES[3], GEOMETRIES[5]])
@pytest.mark.parametrize("activation", ["relu", "leakyrelu"])
def test_conv_block_matches_jax_pallas_kernel(xs, ws, stride, padding,
                                              activation):
    """The JAX kernel itself, through the Pallas interpreter."""
    arrays = _data(xs, ws, seed=1)
    got = _port(arrays, stride=stride, padding=padding,
                activation=activation)
    ref = jax_conv_block(
        *(jnp.asarray(a) for a in arrays), stride=stride, padding=padding,
        activation=activation, interpret=True)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def test_conv_block_optional_terms_default_to_identity():
    x, w, _, _, _ = _data((2, 3, 9, 7), (5, 3, 3, 3))
    got = _port((x, w), padding=(1, 1), activation="tanh")
    ref = jax_conv_ref(jnp.asarray(x), jnp.asarray(w), padding=(1, 1),
                       activation="tanh")
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def test_conv_block_bf16_sums_in_f32():
    x, w, b, a, s = _data((2, 3, 9, 7), (5, 3, 3, 3))
    xb, wb = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, w))
    got = conv_block(xb, wb, torch.from_numpy(b), padding=(1, 1),
                     activation="relu")
    assert got.dtype == torch.bfloat16
    ref = jax_conv_ref(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b), padding=(1, 1), activation="relu")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=1e-2)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, w, b, _, _ = _data((1, 2, 6, 6), (3, 2, 3, 3))
    dispatch.reset_launch_counts()
    tx, tw, tb = (torch.from_numpy(v) for v in (x, w, b))
    got = conv_block(tx, tw, tb, activation="relu")
    ref = conv_block_reference(tx, tw, tb, activation="relu")
    assert torch.equal(got, ref)
    assert dispatch.launch_counts()["conv_block"] == 0


def test_unknown_epilogue_raises():
    x, w, _, _, _ = _data((1, 2, 6, 6), (3, 2, 3, 3))
    with pytest.raises(ValueError, match="unsupported epilogue"):
        conv_block(torch.from_numpy(x), torch.from_numpy(w),
                   activation="softmax")


# --- the backward ------------------------------------------------------------


def _jax_grads(arrays, g, **kw):
    """Grads of sum(conv_block(...) * g) w.r.t. x, w, bias, bn_scale,
    bn_shift: the JAX Pallas kernels (forward, backward-data and
    backward-weights) through the Pallas interpreter."""
    import jax

    def f(*a):
        return jnp.sum(jax_conv_block(*a, interpret=True, **kw)
                       * jnp.asarray(g))

    return [np.asarray(v) for v in jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrays))]


def _port_grads(fn, arrays, g, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    fn(*ts, **kw).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in ts]


def _upstream(arrays, stride, padding, ws, seed=2):
    xs = arrays[0].shape
    oh = (xs[2] + 2 * padding[0] - ws[2]) // stride[0] + 1
    ow = (xs[3] + 2 * padding[1] - ws[3]) // stride[1] + 1
    rng = np.random.RandomState(seed)
    return rng.randn(xs[0], ws[0], oh, ow).astype(np.float32)


@pytest.mark.parametrize("xs,ws,stride,padding", [
    GEOMETRIES[0], GEOMETRIES[2], GEOMETRIES[3]])
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_conv_block_grads_match_jax_pallas_kernels(xs, ws, stride, padding,
                                                   activation):
    """dx, dW, dbias, dscale and dshift against the JAX kernels'
    backward (stride 1 and 2, asymmetric padding, every epilogue,
    nonzero bias and BN terms); the port's CPU route is the plain
    version of the CUDA backward. kernel_tols: f32 sums in other
    orders."""
    arrays = _data(xs, ws, seed=3)
    g = _upstream(arrays, stride, padding, ws)
    kw = dict(stride=stride, padding=padding, activation=activation)
    got = _port_grads(conv_block, arrays, g, **kw)
    ref = _jax_grads(arrays, g, **kw)
    rtol, atol = kernel_tols()
    for name, a, b in zip(("x", "w", "bias", "bn_scale", "bn_shift"), got,
                          ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def test_relu_gradient_at_zero_is_one_half_as_on_the_kernel_route():
    """All-zero input windows and a zero bias give z == 0 exactly: the
    TPU kernel route (and so the port, on both of its routes) sends half
    the gradient through, where autograd through torch.relu sends
    none."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 0, 0] = 1.0
    w = np.ones((2, 1, 2, 2), np.float32)
    b = np.zeros(2, np.float32)
    g = np.ones((1, 2, 3, 3), np.float32)
    got = _port_grads(conv_block, (x, w, b), g, activation="relu")
    ref = _jax_grads((x, w, b, np.ones(2, np.float32),
                      np.zeros(2, np.float32)), g, activation="relu")
    # one window sees the 1 (z = 1), eight see only zeros (z = 0)
    np.testing.assert_allclose(got[2], [1.0 + 8 * 0.5] * 2)
    np.testing.assert_allclose(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1])
    plain = _port_grads(conv_block_reference, (x, w, b), g,
                        activation="relu")
    for a, r in zip(plain, got):
        np.testing.assert_array_equal(a, r)


def test_input_without_grad_skips_dx_and_keeps_dw():
    x, w, b, _, _ = _data((2, 1, 12, 12), (4, 1, 5, 5), seed=4)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    y = conv_block(tx, tw, tb, activation="relu")
    g = _upstream((x,), (1, 1), (0, 0), w.shape)
    y.backward(torch.from_numpy(g))
    assert tx.grad is None
    ref = _jax_grads((x, w, b, np.ones(4, np.float32),
                      np.zeros(4, np.float32)), g, activation="relu")
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(tw.grad.numpy(), ref[1], rtol=rtol, atol=atol)
    np.testing.assert_allclose(tb.grad.numpy(), ref[2], rtol=rtol, atol=atol)


@pytest.mark.parametrize("xs,ws,stride,padding", GEOMETRIES)
def test_backward_plain_versions_match_torch_grad(xs, ws, stride, padding):
    """The plain versions the CUDA backward kernels are held against on
    the card (col2im / im2col GEMMs) give torch.nn.grad's dx and dW."""
    from deeplearning4j_tpu_torch.ops import (
        conv_bwd_data,
        conv_bwd_w,
    )

    x, w, _, _, _ = _data(xs, ws, seed=5)
    dacc = torch.from_numpy(_upstream((x,), stride, padding, ws))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    dispatch.reset_launch_counts()
    dx = conv_bwd_data(dacc, tw, xs[2:], stride, padding)
    dw = conv_bwd_w(tx, dacc, ws, stride, padding)
    assert sum(dispatch.launch_counts().values()) == 0
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(
        dx.numpy(), torch.nn.grad.conv2d_input(
            xs, tw, dacc, stride=stride, padding=padding).numpy(),
        rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        dw.numpy(), torch.nn.grad.conv2d_weight(
            tx, ws, dacc, stride=stride, padding=padding).numpy(),
        rtol=rtol, atol=atol)


# (path, x shape, w shape, stride, padding, route): conv_bwd_data on the
# main paths. LeNet-5's conv2 at the training batch (its conv1 has no
# dx) takes the resident route, one block an image with all 20 channels;
# AlexNet's conv2-conv4 at batch 64, whose gradient maps and weights do
# not fit in shared memory, the implicit GEMM; its conv5, where 4-channel
# groups fit and do 29.7 multiply-adds a staged float, the resident
# route (1.21x faster than the GEMM at batch 128 on an H100 80GB HBM3 at
# 700 W).
BWD_ROUTE_CASES = [
    ("lenet256.conv2", (256, 20, 12, 12), (50, 20, 5, 5), 1, 0, "resident"),
    ("alexnet.conv2", (64, 96, 27, 27), (256, 96, 5, 5), 1, 2, "gemm"),
    ("alexnet.conv3", (64, 256, 13, 13), (384, 256, 3, 3), 1, 1, "gemm"),
    ("alexnet.conv4", (64, 384, 13, 13), (384, 384, 3, 3), 1, 1, "gemm"),
    ("alexnet.conv5", (64, 384, 13, 13), (256, 384, 3, 3), 1, 1,
     "resident"),
]


@pytest.mark.parametrize("path,xs,ws,stride,padding,route", BWD_ROUTE_CASES,
                         ids=[c[0] for c in BWD_ROUTE_CASES])
def test_conv_bwd_data_route_pins_the_main_paths(path, xs, ws, stride,
                                                 padding, route):
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_data_route

    n, c, h, w = xs
    o, _, kh, kw = ws
    plan = conv_bwd_data_route(n, c, h, w, o, kh, kw, stride, padding)
    assert plan.route == route
    if path == "lenet256.conv2":
        # one group of all 20 channels; 5 quads x 64 gradient pixels =
        # 320 threads a tap group, 3 tap groups
        assert (plan.group, plan.tap_groups, plan.threads,
                plan.smem_bytes) == (20, 3, 960, 147_360)
    elif route == "resident":
        # 96 groups of 4 channels: 169 gradient pixels (6 warps) a tap
        # group, 5 tap groups in 1024 threads, one block an SM
        assert (plan.group, plan.tap_groups, plan.threads,
                plan.smem_bytes) == (4, 5, 960, 223_440)


# (x shape, w shape, stride, padding, group): resident plans with one
# group and with channel groups: over 32 channels (40 -> 2 x 20), and
# weights too large for one block (32 channels of 80 x 5 x 5 taps ->
# 2 x 16)
@pytest.mark.parametrize("xs,ws,stride,padding,group", [
    ((3, 6, 11, 10), (9, 6, 3, 3), 2, 1, 6),
    ((2, 3, 9, 7), (7, 3, 3, 2), (2, 1), (2, 0), 3),
    ((2, 40, 12, 12), (64, 40, 5, 5), 1, 0, 20),
    ((2, 32, 12, 12), (80, 32, 5, 5), 1, 0, 16),
])
def test_conv_bwd_data_route_groups_channels(xs, ws, stride, padding, group):
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_data_route

    n, c, h, w = xs
    o, _, kh, kw = ws
    plan = conv_bwd_data_route(n, c, h, w, o, kh, kw, stride, padding)
    assert plan.route == "resident" and plan.group == group


def test_conv_bwd_data_resident_reckoning_stays_within_shared_memory():
    """Over a sweep of geometries, every resident plan fits the H100's
    232,448 bytes a block, holds at most 32 channels a group, covers
    every channel, takes at most 1024 threads, and reckons the bytes the
    kernel holds: the gradient map padded to 16 bytes, then kh*kw*o
    weights for each channel of the group padded to 4 and h*w of dx for
    each of them and each tap group."""
    from deeplearning4j_tpu_torch.ops.conv_block import (
        RESIDENT_MAX_GROUP,
        RESIDENT_MAX_THREADS,
        RESIDENT_SMEM_BYTES,
        conv_bwd_data_route,
        resident_smem_bytes,
    )

    assert RESIDENT_SMEM_BYTES == 232_448
    seen = {"resident": 0, "gemm": 0}
    for c in (1, 3, 5, 20, 33, 64, 96, 200):
        for o in (1, 7, 50, 128, 384):
            for hw, k, s, p in ((12, 5, 1, 0), (28, 5, 1, 2), (13, 3, 1, 1),
                                (11, 3, 2, 1), (56, 11, 4, 2)):
                plan = conv_bwd_data_route(2, c, hw, hw, o, k, k, s, p)
                seen[plan.route] += 1
                if plan.route != "resident":
                    continue
                oh = (hw + 2 * p - k) // s + 1
                assert plan.smem_bytes <= RESIDENT_SMEM_BYTES
                assert 1 <= plan.group <= min(c, RESIDENT_MAX_GROUP)
                assert 1 <= plan.tap_groups <= k * k
                assert plan.threads <= RESIDENT_MAX_THREADS
                assert plan.threads % (32 * plan.tap_groups) == 0
                assert plan.smem_bytes == resident_smem_bytes(
                    hw, hw, o, oh, oh, k, k, plan.group, plan.tap_groups)
                cgp = -(-plan.group // 4) * 4
                assert plan.smem_bytes == 4 * (
                    -(-o * oh * oh // 4) * 4 + k * k * o * cgp
                    + plan.tap_groups * cgp * hw * hw)
    assert seen["resident"] > 0 and seen["gemm"] > 0


# (path, x shape, w shape, stride, padding, route): conv_bwd_w on the
# main paths. LeNet-5's two convs at the training batch stage whole
# images in shared memory; AlexNet's five at batch 64 keep the implicit
# GEMM (one conv1 image is 602 KB, the conv2-conv5 gradient maps
# 173-746 KB, two of which no block holds).
DW_ROUTE_CASES = [
    ("lenet256.conv1", (256, 1, 28, 28), (20, 1, 5, 5), 1, 0,
     "image_resident"),
    ("lenet256.conv2", (256, 20, 12, 12), (50, 20, 5, 5), 1, 0,
     "image_resident"),
    ("alexnet.conv1", (64, 3, 224, 224), (96, 3, 11, 11), 4, 2, "gemm"),
    ("alexnet.conv2", (64, 96, 27, 27), (256, 96, 5, 5), 1, 2, "gemm"),
    ("alexnet.conv3", (64, 256, 13, 13), (384, 256, 3, 3), 1, 1, "gemm"),
    ("alexnet.conv4", (64, 384, 13, 13), (384, 384, 3, 3), 1, 1, "gemm"),
    ("alexnet.conv5", (64, 384, 13, 13), (256, 384, 3, 3), 1, 1, "gemm"),
]


@pytest.mark.parametrize("path,xs,ws,stride,padding,route", DW_ROUTE_CASES,
                         ids=[c[0] for c in DW_ROUTE_CASES])
def test_conv_bwd_w_route_pins_the_main_paths(path, xs, ws, stride, padding,
                                              route):
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_w_route

    n, c, h, w = xs
    o, _, kh, kw = ws
    assert conv_bwd_w_route(n, c, h, w, o, kh, kw, stride,
                            padding).route == route


def test_conv_bwd_w_route_plans_lenet():
    """conv1: 25 items (5 output quads x 5 tap rows of the one channel)
    times 12 pixel groups of two gradient rows, one image a block, 256
    chunks; conv2: 4 groups of 5 channels (13 quads x 5 rows x 5 = 325
    items), 4 images a block, 64 chunks (6.4 MB of partial sums)."""
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_w_route

    assert tuple(conv_bwd_w_route(256, 1, 28, 28, 20, 5, 5)) == (
        "image_resident", 1, 12, 320, 99_104, 1, 256)
    assert tuple(conv_bwd_w_route(256, 20, 12, 12, 50, 5, 5)) == (
        "image_resident", 5, 1, 352, 33_024, 4, 64)


def test_conv_bwd_w_resident_reckoning_stays_within_shared_memory():
    """Over a sweep of geometries, every image-resident plan (square
    kernels up to 5 x 5) fits the H100's 232,448 bytes a block and 384
    threads, covers every channel and image, splits the gradient rows
    evenly, keeps its partial sums within 16 MB, and reckons the bytes
    the kernel holds: two buffers of an x slab at an odd channel stride
    and gradient maps at a padded one (each padded to 16 bytes), or what
    the block leaves there at its end where that is larger (the pixel
    groups' sums, or its dW slice)."""
    from deeplearning4j_tpu_torch.ops.conv_block import (
        BWD_W_MAX_K,
        BWD_W_MAX_SCRATCH,
        BWD_W_MAX_THREADS,
        RESIDENT_SMEM_BYTES,
        bwd_w_smem_bytes,
        conv_bwd_w_route,
    )

    assert RESIDENT_SMEM_BYTES == 232_448
    seen = {"image_resident": 0, "gemm": 0}
    for n in (1, 7, 256):
        for c in (1, 3, 20, 96):
            for o in (1, 7, 50, 384):
                for hw, k, s, p in ((12, 5, 1, 0), (28, 5, 1, 2),
                                    (13, 3, 1, 1), (11, 3, 2, 1),
                                    (56, 11, 4, 2), (9, 1, 1, 0)):
                    plan = conv_bwd_w_route(n, c, hw, hw, o, k, k, s, p)
                    seen[plan.route] += 1
                    if plan.route != "image_resident":
                        continue
                    oh = (hw + 2 * p - k) // s + 1
                    assert k <= BWD_W_MAX_K
                    assert plan.smem_bytes <= RESIDENT_SMEM_BYTES
                    assert 1 <= plan.group <= c
                    assert oh % plan.pixel_groups == 0
                    items = -(-o // 4) * k * plan.group
                    assert plan.threads == -(-items * plan.pixel_groups
                                             // 32) * 32
                    assert plan.threads <= BWD_W_MAX_THREADS
                    assert plan.smem_bytes == bwd_w_smem_bytes(
                        hw, hw, o, oh, oh, k, plan.group, plan.pixel_groups)
                    stage = 2 * (-(-plan.group * (hw * hw | 1) // 4) * 4
                                 + o * (-(-oh * oh // 4) * 4 + 4))
                    end = (plan.pixel_groups * items * 4 * k
                           if plan.pixel_groups > 1
                           else o * plan.group * k * k)
                    assert plan.smem_bytes == 4 * max(stage, end)
                    assert plan.chunks == -(-n // plan.images_per_chunk)
                    assert (plan.chunks - 1) * plan.images_per_chunk < n
                    assert (plan.chunks == 1 or plan.chunks * 4 * o * c * k
                            * k <= BWD_W_MAX_SCRATCH)
    assert seen["image_resident"] > 0 and seen["gemm"] > 0
    # a kernel that is not square keeps the GEMM
    assert conv_bwd_w_route(2, 3, 9, 7, 7, 3, 2).route == "gemm"


# The forward's routes (conv_block_route), decided from the shape alone
# and fitted to scripts/torch_route_ab.py --sweep on the card: AlexNet's
# five convs at batch 64 take the wide implicit GEMM (96 x 256 tiles at
# conv1 and conv5, 128 x 128 at conv2-conv4); so do LeNet-5's first
# conv at the serving bucket of 32 (72 tiles of 32 x 256) and both its
# convs at the training batch (32 x 256); LeNet-5's second conv at the
# bucket (8 such tiles) keeps the direct tile with its split k.
FWD_ROUTE_CASES = [
    ("lenet.conv1", (32, 1, 28, 28), (20, 1, 5, 5), 1, 0, "wide"),
    ("lenet.conv2", (32, 20, 12, 12), (50, 20, 5, 5), 1, 0, "direct"),
    ("lenet256.conv1", (256, 1, 28, 28), (20, 1, 5, 5), 1, 0, "wide"),
    ("lenet256.conv2", (256, 20, 12, 12), (50, 20, 5, 5), 1, 0, "wide"),
    ("alexnet.conv1", (64, 3, 224, 224), (96, 3, 11, 11), 4, 2, "wide"),
    ("alexnet.conv2", (64, 96, 27, 27), (256, 96, 5, 5), 1, 2, "wide"),
    ("alexnet.conv3", (64, 256, 13, 13), (384, 256, 3, 3), 1, 1, "wide"),
    ("alexnet.conv4", (64, 384, 13, 13), (384, 384, 3, 3), 1, 1, "wide"),
    ("alexnet.conv5", (64, 384, 13, 13), (256, 384, 3, 3), 1, 1, "wide"),
]


@pytest.mark.parametrize("path,xs,ws,stride,padding,route", FWD_ROUTE_CASES,
                         ids=[c[0] for c in FWD_ROUTE_CASES])
def test_conv_block_route_pins_the_main_paths(path, xs, ws, stride, padding,
                                              route):
    from deeplearning4j_tpu_torch.ops.conv_block import (
        WIDE_MIN_TILES,
        WIDE_TILES,
        conv_block_route,
    )

    n, c, h, w = xs
    o, _, kh, kw = ws
    plan = conv_block_route(n, c, h, w, o, kh, kw, stride, padding)
    assert plan.route == route
    if route == "wide":
        assert (plan.tile_o, plan.tile_px) in WIDE_TILES
        assert plan.k_pad == -(-c * kh * kw // 16) * 16
        oh = (h + 2 * padding - kh) // stride + 1
        assert plan.tiles == (-(-n * oh * oh // plan.tile_px)
                              * -(-o // plan.tile_o))
        assert plan.tiles >= WIDE_MIN_TILES
    # half precision takes the same route and tile: the wide ring holds
    # f32 in every dtype
    for dt in (torch.bfloat16, torch.float16):
        assert conv_block_route(n, c, h, w, o, kh, kw, stride, padding,
                                dt) == plan


def test_conv_wide_reckoning_stays_within_shared_memory():
    """Over a sweep of geometries, every wide plan fits the H100's
    232,448 bytes a block and reckons the bytes the kernel holds: 4
    ring slots of a 16-deep slice of the transposed weights and of the
    im2col operand, then the tap table of k_pad int2 entries. A depth
    whose table cannot fit keeps the direct route."""
    from deeplearning4j_tpu_torch.ops.conv_block import (
        BLOCK_SMEM_BYTES,
        conv_block_route,
        conv_wide_smem_bytes,
    )

    assert BLOCK_SMEM_BYTES == 232_448
    seen = {"wide": 0, "direct": 0}
    for n in (1, 8, 64, 256):
        for c in (1, 3, 20, 96, 384, 2048):
            for o in (1, 20, 50, 96, 100, 384):
                for hw, k, s, p in ((12, 5, 1, 0), (28, 5, 1, 2),
                                    (13, 3, 1, 1), (224, 11, 4, 2),
                                    (27, 5, 1, 2)):
                    plan = conv_block_route(n, c, hw, hw, o, k, k, s, p)
                    seen[plan.route] += 1
                    if plan.route != "wide":
                        continue
                    ring = 4 * 16 * (plan.tile_o + plan.tile_px) * 4
                    assert plan.smem_bytes == ring + 8 * plan.k_pad
                    assert plan.smem_bytes == conv_wide_smem_bytes(
                        plan.tile_o, plan.tile_px, plan.k_pad)
                    assert plan.smem_bytes <= BLOCK_SMEM_BYTES
    assert seen["wide"] > 0 and seen["direct"] > 0
    # c 2048 under 7 x 7 taps: a 100,352-entry table, so direct
    assert conv_block_route(64, 2048, 14, 14, 512, 7, 7, 1,
                            3).route == "direct"
    # an image of 2^31 elements: the table's int32 offsets cannot
    # address it, so direct
    assert 3 * 32766 * 21846 < 2 ** 31 <= 3 * 32766 * 21847
    assert conv_block_route(1, 3, 32766, 21846, 96, 3, 3, 2,
                            0).route == "wide"
    assert conv_block_route(1, 3, 32766, 21847, 96, 3, 3, 2,
                            0).route == "direct"


def _gather_like_the_kernel(x, table, stride, padding, oh, ow):
    """The wide route's im2col operand as the kernel gathers it, in
    plain PyTorch: for pixel (img, oy, ox) and reduction row k, the
    table's offset from the pixel's top-left tap where (oy*s - p + dh,
    ox*s - p + dw) lies inside the image, else zero. Returns [n, k_pad,
    oh*ow]."""
    n, c, h, w = x.shape
    (sh, sw), (ph, pw) = stride, padding
    off, packed = table[:, 0].long(), table[:, 1].long()
    dh, dw = packed >> 16, packed & 0xFFFF
    oy = torch.arange(oh).repeat_interleave(ow)
    ox = torch.arange(ow).repeat(oh)
    iy0, ix0 = oy * sh - ph, ox * sw - pw
    iy = iy0[None, :] + dh[:, None]
    ix = ix0[None, :] + dw[:, None]
    ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    idx = (iy0 * w + ix0)[None, :] + off[:, None]
    flat = x.reshape(n, -1)
    vals = flat[:, idx.clamp(0, c * h * w - 1).reshape(-1)].reshape(
        n, *idx.shape)
    return torch.where(ok[None], vals, torch.zeros(()))


@pytest.mark.parametrize("xs,ws,stride,padding", [
    ((2, 3, 224, 224), (96, 3, 11, 11), (4, 4), (2, 2)),  # AlexNet conv1
    ((2, 5, 9, 7), (7, 5, 3, 2), (2, 1), (2, 0)),  # padded, odd, asymmetric
    ((1, 13, 33, 31), (70, 13, 3, 5), (2, 1), (1, 2)),
])
def test_conv_tap_table_gathers_im2col(xs, ws, stride, padding):
    """The tap table, gathered as the kernel gathers it, is F.unfold's
    im2col (the naive index of every tap), with zero rows past c*kh*kw
    up to the padded depth."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops.conv_block import conv_tap_table

    n, c, h, w = xs
    _, _, kh, kw = ws
    k_len = c * kh * kw
    k_pad = -(-k_len // 16) * 16
    table = conv_tap_table(c, h, w, kh, kw, k_pad)
    assert table.dtype == torch.int32 and tuple(table.shape) == (k_pad, 2)
    x = torch.arange(n * c * h * w, dtype=torch.float32).reshape(xs) + 1.0
    oh = (h + 2 * padding[0] - kh) // stride[0] + 1
    ow = (w + 2 * padding[1] - kw) // stride[1] + 1
    got = _gather_like_the_kernel(x, table, stride, padding, oh, ow)
    want = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    assert torch.equal(got[:, :k_len], want)
    assert not got[:, k_len:].any()

"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``--noconftest``: ``tests/conftest.py`` imports
JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: f32 kernels sum in another order than cuDNN / cuBLAS (both
run in full f32 here: TF32 is switched off), so agreement is to f32
rounding of sums up to 9216 terms (rtol/atol 1e-4 on O(1) outputs);
bf16 inputs round once on the store, so bf16 eps (2e-2). The weight
gradient sums up to 147,456 products of O(1) terms, so it is held
relative to the largest entry (f32 eps times the depth's square root,
about 5e-5 of the scale).
"""

import importlib
import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import (
    SUPPORTED_EPILOGUES,
    conv_block,
    conv_block_reference,
    conv_bwd_data,
    conv_bwd_data_reference,
    conv_bwd_w,
    conv_bwd_w_reference,
    dispatch,
    flash_attention,
    matmul_block,
    matmul_block_reference,
    mha,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()


# (x shape, w shape, stride, padding) of the forward's wide route
# (conv_block_route): AlexNet's conv1 (stride 4, padding 2, k 363) at
# batch 64 and 12, its conv2 at batch 16 and its conv5 at batch 64 (o
# 256, not a multiple of a 96-channel tile), a ragged o of 100 under
# padding, and o 40 under padding 2; every pixel count but one is
# ragged against its tile
WIDE_CONV_CASES = [
    ((64, 3, 224, 224), (96, 3, 11, 11), 4, 2),
    ((12, 3, 224, 224), (96, 3, 11, 11), 4, 2),
    ((16, 96, 27, 27), (256, 96, 5, 5), 1, 2),
    ((64, 384, 13, 13), (256, 384, 3, 3), 1, 1),
    ((8, 16, 40, 40), (100, 16, 3, 3), 1, 1),
    ((48, 3, 32, 32), (40, 3, 5, 5), 1, 2),
]

# (x shape, w shape, stride, padding): LeNet's two convs at bucket 32
# (the second splits its k axis), AlexNet's five at batch 4, odd
# geometry, a split-K case whose last k chunk is ragged, and the wide
# route's cases
# VGG-16's distinct convs at batch 128 (3 x 3, padding 1): the wide
# forward with 32 x 256 and 128 x 128 tiles and the direct one at 2 x 2
# (in test_conv_block_kernel_matches_plain), the resident dx route (16-
# and 4-channel groups) and the implicit GEMMs (every dW; in
# test_vgg_conv_bwd_kernels_match_plain_and_repeat)
VGG_CONV_CASES = [
    ((128, 3, 32, 32), (64, 3, 3, 3), 1, 1),
    ((128, 64, 32, 32), (64, 64, 3, 3), 1, 1),
    ((128, 64, 16, 16), (128, 64, 3, 3), 1, 1),
    ((128, 128, 16, 16), (128, 128, 3, 3), 1, 1),
    ((128, 128, 8, 8), (256, 128, 3, 3), 1, 1),
    ((128, 256, 8, 8), (256, 256, 3, 3), 1, 1),
    ((128, 256, 4, 4), (512, 256, 3, 3), 1, 1),
    ((128, 512, 4, 4), (512, 512, 3, 3), 1, 1),
    ((128, 512, 2, 2), (512, 512, 3, 3), 1, 1),
]

CONV_CASES = [
    ((32, 1, 28, 28), (20, 1, 5, 5), 1, 0),
    ((32, 20, 12, 12), (50, 20, 5, 5), 1, 0),
    ((4, 3, 224, 224), (96, 3, 11, 11), 4, 2),
    ((4, 96, 27, 27), (256, 96, 5, 5), 1, 2),
    ((4, 256, 13, 13), (384, 256, 3, 3), 1, 1),
    ((4, 384, 13, 13), (384, 384, 3, 3), 1, 1),
    ((4, 384, 13, 13), (256, 384, 3, 3), 1, 1),
    ((3, 5, 9, 7), (7, 5, 3, 2), (2, 1), (2, 0)),
    ((2, 37, 9, 9), (11, 37, 3, 3), 1, 1),
] + WIDE_CONV_CASES


@pytest.mark.parametrize("xs,ws,stride,padding",
                         CONV_CASES + VGG_CONV_CASES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_conv_block_kernel_matches_plain(cuda, xs, ws, stride, padding,
                                         activation):
    rng = np.random.RandomState(0)
    fan_in = ws[1] * ws[2] * ws[3]
    x = _t(rng.randn(*xs), cuda)
    w = _t(rng.randn(*ws) / np.sqrt(fan_in), cuda)
    b = _t(rng.randn(ws[0]) * 0.1, cuda)
    before = dispatch.launch_counts()["conv_block"]
    with torch.inference_mode():
        out = conv_block(x, w, b, stride=stride, padding=padding,
                         activation=activation)
        ref = conv_block_reference(x, w, b, stride=stride,
                                   padding=padding, activation=activation)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_block"] == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def _conv_operands(xs, ws, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = _t(rng.randn(*xs), "cuda", dtype)
    w = _t(rng.randn(*ws) / np.sqrt(ws[1] * ws[2] * ws[3]), "cuda", dtype)
    b = _t(rng.randn(ws[0]) * 0.1, "cuda")
    return x, w, b


@pytest.mark.parametrize("xs,ws,stride,padding", WIDE_CONV_CASES)
def test_conv_block_wide_route_matches_plain_and_repeats(cuda, xs, ws,
                                                         stride, padding):
    from deeplearning4j_tpu_torch.ops.conv_block import conv_block_route

    plan = conv_block_route(*xs, ws[0], ws[2], ws[3], stride, padding)
    assert plan.route == "wide"
    x, w, b = _conv_operands(xs, ws, 30)
    kw = dict(stride=stride, padding=padding, activation="relu")
    before = dispatch.launch_counts()["conv_block"]
    with torch.inference_mode():
        out = conv_block(x, w, b, **kw)
        again = conv_block(x, w, b, **kw)
        ref = conv_block_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_block"] == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tile", [(96, 256), (128, 128), (96, 128),
                                  (32, 256)])
@pytest.mark.parametrize("activation", ["identity", "tanh"])
def test_conv_block_every_wide_tile_matches_plain(cuda, monkeypatch, tile,
                                                  activation):
    """Each wide tile forced (the route function patched) on an odd
    geometry: asymmetric stride and padding, c 13 (k 195, padded to
    208), o 70 off every tile, a ragged pixel count."""
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    assert tile in cb.WIDE_TILES
    xs, ws, stride, padding = (7, 13, 33, 31), (70, 13, 3, 5), (2, 1), (1, 2)
    k_pad = 208
    plan = cb.ConvRoute("wide", tile[0], tile[1], k_pad, 0,
                        cb.conv_wide_smem_bytes(*tile, k_pad))
    monkeypatch.setattr(cb, "conv_block_route", lambda *a, **k: plan)
    x, w, b = _conv_operands(xs, ws, 31)
    kw = dict(stride=stride, padding=padding, activation=activation)
    with torch.inference_mode():
        out = conv_block(x, w, b, **kw)
        again = conv_block(x, w, b, **kw)
        ref = conv_block_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_conv_block_wide_shapes_take_the_direct_route_in_bf16(cuda):
    """A wide shape in bf16 took the direct tile until the wide route
    took half images; it now takes the wide route in bf16 too, by the
    route rule, and still matches."""
    from deeplearning4j_tpu_torch.ops.conv_block import conv_block_route

    xs, ws, stride, padding = WIDE_CONV_CASES[2]
    geo = (*xs, ws[0], ws[2], ws[3], stride, padding)
    assert conv_block_route(*geo).route == "wide"
    assert conv_block_route(*geo, dtype=torch.bfloat16).route == "wide"
    x, w, b = _conv_operands(xs, ws, 32, torch.bfloat16)
    kw = dict(stride=stride, padding=padding, activation="relu")
    with torch.inference_mode():
        out = conv_block(x, w, b, **kw)
        ref = conv_block_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


def test_conv_wide_smem_plan_matches_the_kernel(cuda):
    """The route's shared-memory reckoning is the C source's, for every
    tile at the AlexNet depths; a tile the build lacks is refused."""
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops.conv_block import (
        WIDE_TILES,
        conv_wide_smem_bytes,
    )

    lib = _build.load()
    for tile in WIDE_TILES:
        for k_pad in (32, 368, 2400, 3456):
            assert lib.dl4j_conv_wide_smem_bytes(*tile, k_pad) == \
                conv_wide_smem_bytes(*tile, k_pad)
    assert lib.dl4j_conv_wide_smem_bytes(48, 256, 32) == -1


def test_refused_wide_and_latency_plans_raise(cuda, monkeypatch):
    """No fallback: a plan the kernels refuse (a wide tile the build
    lacks; a latency block past its shared memory) raises."""
    from deeplearning4j_tpu_torch.ops import lstm_cell

    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    monkeypatch.setattr(cb, "conv_block_route", lambda *a, **k:
                        cb.ConvRoute("wide", 48, 256, 32, 1, 0))
    x, w, b = _conv_operands((2, 3, 9, 9), (5, 3, 3, 3), 33)
    with pytest.raises(RuntimeError, match="cudaError"):
        with torch.inference_mode():
            conv_block(x, w, b)
    monkeypatch.setattr(lc, "lstm_cell_route", lambda *a:
                        lc.CellRoute("latency", 32, 2, 4, 512, 8, 256, 0))
    xproj, h, c, rw, _ = _lstm_operands(None, 256, 1024, 13)
    with pytest.raises(RuntimeError, match="cudaError"):
        lstm_cell(xproj, h, c, rw)


def test_conv_block_kernel_bn_terms_and_bf16(cuda):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 11, 11)
    w = rng.randn(9, 6, 3, 3) * 0.2
    b, a, s = rng.randn(9) * 0.1, rng.rand(9) + 0.5, rng.randn(9) * 0.1
    bn = dict(stride=(1, 1), padding=(1, 1), activation="tanh")
    with torch.inference_mode():
        out = conv_block(_t(x, cuda), _t(w, cuda), _t(b, cuda), _t(a, cuda),
                         _t(s, cuda), **bn)
        ref = conv_block_reference(_t(x, cuda), _t(w, cuda), _t(b, cuda),
                                   _t(a, cuda), _t(s, cuda), **bn)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        xb, wb = _t(x, cuda, torch.bfloat16), _t(w, cuda, torch.bfloat16)
        outb = conv_block(xb, wb, _t(b, cuda), **bn)
        refb = conv_block_reference(xb, wb, _t(b, cuda), **bn)
    assert outb.dtype == torch.bfloat16
    torch.testing.assert_close(outb.float(), refb.float(), rtol=2e-2,
                               atol=2e-2)


# (m, k, n): LeNet's dense at bucket 32, AlexNet's two at batch 64
# (all three split K), and ragged edges on every axis
MATMUL_CASES = [(32, 800, 512), (64, 9216, 4096), (64, 4096, 4096),
                (1, 7, 3), (70, 33, 129), (5, 1000, 65), (128, 512, 512)]


@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_matmul_block_kernel_matches_plain(cuda, m, k, n, activation):
    rng = np.random.RandomState(2)
    x = _t(rng.randn(m, k), cuda)
    w = _t(rng.randn(k, n) / np.sqrt(k), cuda)
    b = _t(rng.randn(n) * 0.1, cuda)
    before = dispatch.launch_counts()["matmul_block"]
    with torch.inference_mode():
        out = matmul_block(x, w, b, activation=activation)
        ref = matmul_block_reference(x, w, b, activation=activation)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["matmul_block"] == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_conv_block_split_k_bn_terms_and_bf16(cuda):
    # few output tiles and a 333-deep k axis: the kernel splits k, and
    # the finish pass applies the folded BN affine and the cast
    rng = np.random.RandomState(4)
    x = rng.randn(2, 37, 9, 9)
    w = rng.randn(11, 37, 3, 3) * 0.05
    b, a, s = rng.randn(11) * 0.1, rng.rand(11) + 0.5, rng.randn(11) * 0.1
    bn = dict(stride=(1, 1), padding=(1, 1), activation="leakyrelu")
    with torch.inference_mode():
        out = conv_block(_t(x, cuda), _t(w, cuda), _t(b, cuda), _t(a, cuda),
                         _t(s, cuda), **bn)
        ref = conv_block_reference(_t(x, cuda), _t(w, cuda), _t(b, cuda),
                                   _t(a, cuda), _t(s, cuda), **bn)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        xb, wb = _t(x, cuda, torch.bfloat16), _t(w, cuda, torch.bfloat16)
        outb = conv_block(xb, wb, _t(b, cuda), _t(a, cuda), _t(s, cuda), **bn)
        refb = conv_block_reference(xb, wb, _t(b, cuda), _t(a, cuda),
                                    _t(s, cuda), **bn)
    assert outb.dtype == torch.bfloat16
    torch.testing.assert_close(outb.float(), refb.float(), rtol=2e-2,
                               atol=2e-2)


def test_matmul_block_kernel_bf16_and_no_bias(cuda):
    rng = np.random.RandomState(3)
    x = _t(rng.randn(17, 300), cuda, torch.bfloat16)
    w = _t(rng.randn(300, 40) * 0.05, cuda, torch.bfloat16)
    with torch.inference_mode():
        out = matmul_block(x, w, activation="relu")
        ref = matmul_block_reference(x, w, activation="relu")
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


def test_kernels_refuse_what_they_cannot_take(cuda):
    w = torch.randn(8, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_block(torch.randn(8, 4, device=cuda).t(), w)
    with pytest.raises(TypeError):
        matmul_block(torch.randn(4, 8, device=cuda, dtype=torch.float64),
                     w.double())
    with pytest.raises(ValueError, match="channels"):
        conv_block(torch.randn(1, 3, 8, 8, device=cuda),
                   torch.randn(4, 2, 3, 3, device=cuda))


# the backward kernels: CONV_CASES plus stride-2 and ragged geometry
# (maps and channel counts off the 64-wide tiles, remainder rows the
# strided forward never read), and LeNet's training shapes at batch 256
BWD_CASES = CONV_CASES + [
    ((3, 6, 11, 10), (9, 6, 3, 3), 2, 1),
    ((2, 5, 12, 9), (70, 5, 4, 3), (2, 3), (1, 0)),
    ((256, 1, 28, 28), (20, 1, 5, 5), 1, 0),
    ((256, 20, 12, 12), (50, 20, 5, 5), 1, 0),
]


def _bwd_operands(xs, ws, stride, padding, seed):
    from deeplearning4j_tpu_torch.ops.conv_block import (
        _pair,
        conv_output_size,
    )

    rng = np.random.RandomState(seed)
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    oh = conv_output_size(xs[2], ws[2], sh, ph)
    ow = conv_output_size(xs[3], ws[3], sw, pw)
    x = _t(rng.randn(*xs), "cuda")
    w = _t(rng.randn(*ws) / np.sqrt(ws[1] * ws[2] * ws[3]), "cuda")
    dacc = _t(rng.randn(xs[0], ws[0], oh, ow), "cuda")
    return x, w, dacc


def _close_to_scale(got, ref, rel):
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=rel * max(scale, 1.0))


@pytest.mark.parametrize("xs,ws,stride,padding", BWD_CASES)
def test_conv_bwd_data_kernel_matches_plain(cuda, xs, ws, stride, padding):
    x, w, dacc = _bwd_operands(xs, ws, stride, padding, 5)
    before = dispatch.launch_counts()["conv_bwd_data"]
    got = conv_bwd_data(dacc, w, xs[2:], stride, padding)
    ref = conv_bwd_data_reference(dacc, w, xs[2:], stride, padding)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_bwd_data"] == before + 1
    assert got.shape == x.shape and got.dtype == torch.float32
    _close_to_scale(got, ref, 5e-5)
    lib = torch.nn.grad.conv2d_input(xs, w, dacc, stride=stride,
                                     padding=padding)
    _close_to_scale(got, lib, 5e-5)


@pytest.mark.parametrize("xs,ws,stride,padding", BWD_CASES)
def test_conv_bwd_w_kernel_matches_plain(cuda, xs, ws, stride, padding):
    x, w, dacc = _bwd_operands(xs, ws, stride, padding, 6)
    before = dispatch.launch_counts()["conv_bwd_w"]
    got = conv_bwd_w(x, dacc, ws, stride, padding)
    ref = conv_bwd_w_reference(x, dacc, ws, stride, padding)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_bwd_w"] == before + 1
    assert tuple(got.shape) == ws and got.dtype == torch.float32
    _close_to_scale(got, ref, 5e-5)
    lib = torch.nn.grad.conv2d_weight(x, ws, dacc, stride=stride,
                                      padding=padding)
    _close_to_scale(got, lib, 5e-5)


# (x shape, w shape, stride, padding, route) of conv_bwd_w: LeNet-5's
# convs at the training batch and an odd batch (image-resident), three
# input channels, stride 2 with padding 1 and a ragged output-channel
# quad (image-resident), and AlexNet's conv2 (the implicit GEMM: its
# gradient map alone takes 746 KB an image)
DW_ROUTE_CASES = [
    ((256, 1, 28, 28), (20, 1, 5, 5), 1, 0, "image_resident"),
    ((256, 20, 12, 12), (50, 20, 5, 5), 1, 0, "image_resident"),
    ((7, 20, 12, 12), (50, 20, 5, 5), 1, 0, "image_resident"),
    ((5, 3, 32, 32), (16, 3, 3, 3), 1, 0, "image_resident"),
    ((6, 5, 15, 13), (10, 5, 3, 3), 2, 1, "image_resident"),
    ((4, 96, 27, 27), (256, 96, 5, 5), 1, 2, "gemm"),
]


@pytest.mark.parametrize("xs,ws,stride,padding,route", DW_ROUTE_CASES)
def test_conv_bwd_w_routes_match_plain_library_and_repeat(
        cuda, xs, ws, stride, padding, route):
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_w_route

    plan = conv_bwd_w_route(*xs, ws[0], ws[2], ws[3], stride, padding)
    assert plan.route == route
    x, _, dacc = _bwd_operands(xs, ws, stride, padding, 8)
    before = dispatch.launch_counts()["conv_bwd_w"]
    got = conv_bwd_w(x, dacc, ws, stride, padding)
    again = conv_bwd_w(x, dacc, ws, stride, padding)
    ref = conv_bwd_w_reference(x, dacc, ws, stride, padding)
    lib = torch.nn.grad.conv2d_weight(x, ws, dacc, stride=stride,
                                      padding=padding)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_bwd_w"] == before + 2
    assert torch.equal(got, again)
    _close_to_scale(got, ref, 5e-5)
    _close_to_scale(got, lib, 5e-5)


@pytest.mark.parametrize("xs,ws,stride,padding", [BWD_CASES[1],
                                                  BWD_CASES[-2]])
def test_conv_bwd_kernels_are_bitwise_deterministic(cuda, xs, ws, stride,
                                                    padding):
    x, w, dacc = _bwd_operands(xs, ws, stride, padding, 7)
    dx = [conv_bwd_data(dacc, w, xs[2:], stride, padding) for _ in range(2)]
    dw = [conv_bwd_w(x, dacc, ws, stride, padding) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dx[0], dx[1])
    assert torch.equal(dw[0], dw[1])


@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_conv_block_grads_match_plain_and_count_launches(cuda, activation):
    rng = np.random.RandomState(8)
    x0 = rng.rand(4, 3, 12, 12)
    x0[0, :, :6, :6] = 0.0   # all-zero windows: z == 0 with zero bias
    w0 = rng.randn(6, 3, 3, 3) * 0.3
    g0 = rng.randn(4, 6, 12, 12)
    grads = []
    for fn in (conv_block, conv_block_reference):
        x = _t(x0, cuda).requires_grad_(True)
        w = _t(w0, cuda).requires_grad_(True)
        b = torch.zeros(6, device=cuda, requires_grad=True)
        dispatch.reset_launch_counts()
        y = fn(x, w, b, stride=(1, 1), padding=(1, 1), activation=activation)
        y.backward(_t(g0, cuda))
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        grads.append((x.grad, w.grad, b.grad))
        if fn is conv_block:
            assert counts == {"conv_block": 2, "conv_bwd_data": 1,
                              "conv_bwd_w": 1, "matmul_block": 0,
                              "lstm_cell": 0, "lstm_seq_fwd": 0,
                              "lstm_seq_bwd": 0, "flash_attention": 0,
                              "flash_attention_streamed": 0,
                              "matmul_block_residual": 0}
        else:
            assert sum(counts.values()) == 0
    for got, ref in zip(*grads):
        _close_to_scale(got, ref, 5e-5)


def test_conv_block_skips_dx_when_x_needs_none(cuda):
    x = torch.rand(2, 1, 28, 28, device=cuda)
    w = torch.randn(20, 1, 5, 5, device=cuda, requires_grad=True)
    dispatch.reset_launch_counts()
    conv_block(x, w, activation="relu").sum().backward()
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_bwd_data"] == 0
    assert dispatch.launch_counts()["conv_bwd_w"] == 1
    assert w.grad is not None


def test_half_precision_training_raises_on_the_card(cuda):
    """Half-precision training runs the kernels now (it raised before
    the mixed-precision slice); each gradient matches the plain
    version's on the same operands."""
    for dt in (torch.bfloat16, torch.float16):
        x = torch.randn(2, 3, 8, 8, device=cuda, dtype=dt)
        w = torch.randn(4, 3, 3, 3, device=cuda, dtype=dt,
                        requires_grad=True)
        dispatch.reset_launch_counts()
        conv_block(x, w, activation="relu").float().sum().backward()
        assert dispatch.launch_counts()["conv_bwd_w"] == 1
        w_ref = w.detach().clone().requires_grad_(True)
        conv_block_reference(x, w_ref, activation="relu").float().sum(
        ).backward()
        torch.testing.assert_close(w.grad.float(), w_ref.grad.float(),
                                   rtol=2e-2, atol=8e-3)
        xm = x.reshape(2, -1)
        wm = torch.randn(192, 3, device=cuda, dtype=dt, requires_grad=True)
        matmul_block(xm, wm).float().sum().backward()
        assert wm.grad is not None and wm.grad.dtype == dt


def test_matmul_block_grads_match_plain(cuda):
    rng = np.random.RandomState(9)
    x0, w0 = rng.randn(64, 800), rng.randn(800, 512) * 0.03
    grads = []
    for fn in (matmul_block, matmul_block_reference):
        x = _t(x0, cuda).requires_grad_(True)
        w = _t(w0, cuda).requires_grad_(True)
        b = torch.zeros(512, device=cuda, requires_grad=True)
        fn(x, w, b, activation="relu").sum().backward()
        grads.append((x.grad, w.grad, b.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_lenet_fit_step_on_the_card_matches_the_cpu_twin(cuda):
    """One full-width LeNet-5 step (batch 256, Adam, MCXENT) through
    ``fit`` on the card, with exact launch counts, against the same step
    on the CPU (the plain path). Adam moves each weight by about lr at
    step 1 whatever the gradient's size, so a gradient at the f32 noise
    floor can move differently: weights are held at atol lr / 50 and
    at most 1 % of any parameter's entries may exceed rtol 1e-4 /
    atol 1e-5."""
    import warnings

    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import lenet

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ds = next(iter(MnistDataSetIterator(256, num_examples=256,
                                            allow_synthetic=True)))
    net = MultiLayerNetwork(lenet(), device=cuda).init()
    twin = MultiLayerNetwork(lenet(), device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in net.params.items()})
    dispatch.reset_launch_counts()
    net.fit(ds)
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == {
        "conv_block": 4, "conv_bwd_data": 1, "conv_bwd_w": 2,
        "matmul_block": 1, "lstm_cell": 0, "lstm_seq_fwd": 0,
        "lstm_seq_bwd": 0, "flash_attention": 0,
        "flash_attention_streamed": 0, "matmul_block_residual": 0}
    twin.fit(ds)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    lr = 0.01
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            got = net.params[ln][pn].cpu()
            torch.testing.assert_close(got, ref, rtol=0, atol=lr / 50)
            off = (got - ref).abs() > 1e-5 + 1e-4 * ref.abs()
            assert float(off.float().mean()) <= 0.01, (ln, pn)


# --- the LSTM kernels -------------------------------------------------------
#
# Shapes: the char-RNN's chunk (b 32, n 200), the saturated shape (b 256,
# n 1024), and ragged b and n: units off the 8-unit slices, batch rows off
# the 32-row groups, several row tiles (b 300), one row (b 1), and n 8500,
# whose 1063 slices outnumber the blocks the card holds at once, so each
# block of the sequence kernels walks more than one slice with RW's
# columns streamed from L2. f32 on both sides (TF32 off); the kernels sum
# h @ RW in another order than cuBLAS, over up to 8500 terms of O(1)
# products, and the sequence carries that rounding through T steps, so
# outputs are held relative to their largest entry (1e-4 of the scale).
#
# The sequence kernels' cluster route (n <= 256) also meets n off the
# 8-block cluster (13 and 17: 7 and 6 blocks, so that none is empty;
# 201: 8 blocks, the last with fewer units), b off the rows
# a cluster owns (33, 300: a last cluster with rows past b, and 38
# clusters, more than one wave), the T 1 launch at the sampling batch of
# 1, and n at the route's limit (256) and one past it (257: the grid).

LSTM_CELL_CASES = [(32, 200), (256, 1024), (5, 13), (33, 17), (70, 9),
                   (1, 200), (300, 40), (3, 8500)]
LSTM_SEQ_CASES = [(50, 32, 200), (128, 256, 1024), (3, 5, 13), (7, 33, 17),
                  (4, 300, 40), (2, 1, 200), (2, 3, 8500), (5, 33, 201),
                  (3, 300, 13), (1, 1, 200), (4, 32, 256), (4, 32, 257)]


def _assert_lstm_route(T, b, n, bwd):
    """The launch at (T, b, n) takes the route its shape calls for, and
    the C source reckons the cluster plan's shared memory as the route
    rule does."""
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        lstm_seq_plan,
        lstm_seq_route,
    )

    plan = lstm_seq_plan(b, n, bwd, T)
    assert plan["route"] == ("cluster" if n <= 256 else "grid")
    if plan["route"] == "cluster":
        route = lstm_seq_route(T, b, n, bwd)
        assert plan["cluster"] == route.cluster
        assert plan["smem_bytes"] == route.smem_bytes
        assert plan["max_active_clusters"] > 0


def _lstm_operands(T, b, n, seed, peephole=False):
    rng = np.random.RandomState(seed)
    lead = () if T is None else (T,)
    xproj = _t(rng.randn(*lead, b, 4 * n) * 0.5, "cuda")
    h = _t(rng.randn(b, n) * 0.1, "cuda")
    c = _t(rng.randn(b, n) * 0.1, "cuda")
    rw = _t(rng.randn(n, 4 * n) / np.sqrt(n), "cuda")
    peeps = (tuple(_t(rng.randn(n) * 0.1, "cuda") for _ in range(3))
             if peephole else None)
    return xproj, h, c, rw, peeps


@pytest.mark.parametrize("forced_slice", [False, True])
@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("b,n", LSTM_CELL_CASES)
def test_lstm_cell_kernel_matches_plain(cuda, monkeypatch, b, n, peephole,
                                        forced_slice):
    """Each shape on the route lstm_cell_route gives it, and on the
    slice route forced (the route function patched), so both routes
    meet every shape the latency route takes."""
    from deeplearning4j_tpu_torch.ops import lstm_cell, lstm_cell_reference

    lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    route = lc.lstm_cell_route(b, n).route
    assert route == ("slice" if (b, n) in ((256, 1024), (3, 8500))
                     else "latency")
    if forced_slice:
        monkeypatch.setattr(lc, "lstm_cell_route",
                            lambda *a: lc.CellRoute("slice"))
    xproj, h, c, rw, peeps = _lstm_operands(None, b, n, 11, peephole)
    before = dispatch.launch_counts()["lstm_cell"]
    h_k, c_k = lstm_cell(xproj, h, c, rw, peeps)
    h_r, c_r = lstm_cell_reference(xproj, h, c, rw, peeps)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["lstm_cell"] == before + 1
    _close_to_scale(h_k, h_r, 1e-4)
    _close_to_scale(c_k, c_r, 1e-4)


@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("b,n", [(32, 200), (1, 200)])
def test_lstm_cell_latency_route_repeats_bitwise(cuda, b, n, peephole):
    """The char-RNN's step and its sampling launch: 40 launches give the
    same bits, the first held to the plain version."""
    from deeplearning4j_tpu_torch.ops import lstm_cell, lstm_cell_reference
    from deeplearning4j_tpu_torch.ops.lstm_cell import lstm_cell_route

    assert lstm_cell_route(b, n).route == "latency"
    xproj, h, c, rw, peeps = _lstm_operands(None, b, n, 12, peephole)
    outs = [lstm_cell(xproj, h, c, rw, peeps) for _ in range(40)]
    h_r, c_r = lstm_cell_reference(xproj, h, c, rw, peeps)
    torch.cuda.synchronize()
    _close_to_scale(outs[0][0], h_r, 1e-4)
    _close_to_scale(outs[0][1], c_r, 1e-4)
    for h_k, c_k in outs[1:]:
        assert torch.equal(h_k, outs[0][0]) and torch.equal(c_k, outs[0][1])


def test_lstm_cell_plans_match_the_kernel(cuda):
    """The latency route's shared memory and threads as the C source
    reckons them, at every latency shape of LSTM_CELL_CASES; a plan past
    the route's 48 KB is refused there."""
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops.lstm_cell import (
        lstm_cell_plan,
        lstm_cell_route,
    )

    for b, n in LSTM_CELL_CASES:
        route = lstm_cell_route(b, n)
        plan = lstm_cell_plan(b, n)
        assert plan["route"] == route.route
        if route.route == "latency":
            assert plan["smem_bytes"] == route.smem_bytes
            assert plan["threads"] == route.threads
    import ctypes

    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    _build.load().dl4j_lstm_cell_plan(256, 1024, 32, 2, 4,
                                      ctypes.byref(smem),
                                      ctypes.byref(threads))
    assert (smem.value, threads.value) == (-1, -1)


@pytest.mark.parametrize("save_cseq", [True, False])
@pytest.mark.parametrize("T,b,n", LSTM_SEQ_CASES)
def test_lstm_seq_fwd_kernel_matches_plain(cuda, T, b, n, save_cseq):
    from deeplearning4j_tpu_torch.ops import (
        lstm_seq_fwd,
        lstm_seq_fwd_reference,
    )

    _assert_lstm_route(T, b, n, False)
    xproj, h0, c0, rw, _ = _lstm_operands(T, b, n, 12)
    before = dispatch.launch_counts()["lstm_seq_fwd"]
    got = lstm_seq_fwd(xproj, h0, c0, rw, save_cseq)
    ref = lstm_seq_fwd_reference(xproj, h0, c0, rw, save_cseq)
    again = lstm_seq_fwd(xproj, h0, c0, rw, save_cseq)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["lstm_seq_fwd"] == before + 2
    assert (got[1] is None) == (not save_cseq)
    for a, r, a2 in zip(got, ref, again):
        if r is not None:
            _close_to_scale(a, r, 1e-4)
            assert torch.equal(a, a2)  # fixed-order sums: same bits


@pytest.mark.parametrize("T,b,n", LSTM_SEQ_CASES)
def test_lstm_seq_bwd_kernel_matches_plain(cuda, T, b, n):
    from deeplearning4j_tpu_torch.ops import (
        lstm_seq_bwd,
        lstm_seq_bwd_reference,
        lstm_seq_fwd_reference,
    )

    _assert_lstm_route(T, b, n, True)
    xproj, h0, c0, rw, _ = _lstm_operands(T, b, n, 13)
    rng = np.random.RandomState(14)
    hseq, cseq, _, _ = lstm_seq_fwd_reference(xproj, h0, c0, rw)
    hprev = torch.cat([h0[None], hseq[:-1]]).contiguous()
    cprev = torch.cat([c0[None], cseq[:-1]]).contiguous()
    dhseq = _t(rng.randn(T, b, n), cuda)
    dhT, dcT = _t(rng.randn(b, n), cuda), _t(rng.randn(b, n), cuda)
    args = (xproj, hprev, cprev, cseq, rw, dhseq, dhT, dcT)
    before = dispatch.launch_counts()["lstm_seq_bwd"]
    got = lstm_seq_bwd(*args)
    ref = lstm_seq_bwd_reference(*args)
    again = lstm_seq_bwd(*args)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["lstm_seq_bwd"] == before + 2
    for a, r, a2 in zip(got, ref, again):
        _close_to_scale(a, r, 1e-4)
        assert torch.equal(a, a2)  # no atomics in the sums: same bits


def test_lstm_sequence_grads_match_plain_and_count_launches(cuda):
    from deeplearning4j_tpu_torch.ops import (
        lstm_seq_fwd_reference,
        lstm_sequence,
    )

    T, b, n = 50, 32, 200
    xproj0, h00, c00, rw0, _ = _lstm_operands(T, b, n, 15)
    ws = _t(np.random.RandomState(16).randn(T, b, n), cuda)
    grads = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_(True)
                  for t in (xproj0, h00, c00, rw0)]
        dispatch.reset_launch_counts()
        if kernels:
            hseq, hT, cT = lstm_sequence(*leaves)
        else:
            hseq, _, hT, cT = lstm_seq_fwd_reference(*leaves)
        loss = (hseq * ws).sum() + (hT ** 2).sum() + (cT ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        assert (counts["lstm_seq_fwd"], counts["lstm_seq_bwd"]) == (
            (1, 1) if kernels else (0, 0))
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        _close_to_scale(got, ref, 1e-4)
    # without a gradient: the c_seq-free forward, one launch
    dispatch.reset_launch_counts()
    with torch.inference_mode():
        lstm_sequence(xproj0, h00, c00, rw0)
    assert dispatch.launch_counts()["lstm_seq_fwd"] == 1


def test_lstm_cell_diff_grads_match_plain(cuda):
    from deeplearning4j_tpu_torch.ops import (
        lstm_cell_diff,
        lstm_cell_reference,
    )

    xproj0, h0, c0, rw0, peeps0 = _lstm_operands(None, 32, 200, 17, True)
    grads = []
    for fn in (lstm_cell_diff, lstm_cell_reference):
        leaves = [t.clone().requires_grad_(True)
                  for t in (xproj0, h0, c0, rw0) + peeps0]
        h, c = fn(*leaves[:4], tuple(leaves[4:]))
        ((h * 1.5).sum() + (c ** 2).sum()).backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        _close_to_scale(got, ref, 1e-4)


def test_lstm_kernels_refuse_half_precision(cuda):
    from deeplearning4j_tpu_torch.ops import lstm_cell, lstm_seq_fwd

    xproj, h, c, rw, _ = _lstm_operands(4, 8, 16, 18)
    bf = [t.bfloat16() for t in (xproj, h, c, rw)]
    with pytest.raises(NotImplementedError, match="bf16 / f16 LSTM"):
        lstm_seq_fwd(*bf)
    with pytest.raises(NotImplementedError, match="bf16 / f16 LSTM"):
        lstm_cell(bf[0][0], *bf[1:])


@pytest.mark.parametrize("peephole,masked", [(True, False), (False, False),
                                             (False, True)])
def test_graves_lstm_layer_on_card_matches_cpu(cuda, peephole, masked):
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM

    layer = GravesLSTM(n_in=77, n_out=200, peephole=peephole)
    params = layer.init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(19)
    x = rng.randn(32, 77, 50).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((32, 50), np.float32)
        mask[:8, 30:] = 0.0
    outs, launches = [], []
    for dev in (cuda, "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        m = None if mask is None else _t(mask, dev)
        dispatch.reset_launch_counts()
        with torch.inference_mode():
            y, st = layer.apply(p, _t(x, dev), {}, mask=m)
        outs.append((y.cpu(), st["h"].cpu(), st["c"].cpu()))
        launches.append(dispatch.launch_counts())
    routed = "lstm_cell" if (peephole or masked) else "lstm_seq_fwd"
    assert launches[0][routed] == (50 if routed == "lstm_cell" else 1)
    assert sum(launches[1].values()) == 0
    for got, ref in zip(*outs):
        _close_to_scale(got, ref, 1e-4)


def test_lstm_seq_plans(cuda):
    from deeplearning4j_tpu_torch.ops.lstm_cell import lstm_seq_plan

    # the char-RNN's chunk: 8 clusters of 8 blocks, 4 batch rows each,
    # RW's columns resident across each cluster, all 8 at once
    for bwd in (False, True):
        plan = lstm_seq_plan(32, 200, bwd, 50)
        assert {k: plan[k] for k in ("route", "cluster", "rows",
                                     "clusters")} == {
            "route": "cluster", "cluster": 8, "rows": 4, "clusters": 8}
        assert plan["max_active_clusters"] >= 8
        # bench.py's saturated shape: the grid route, RW's columns resident
        # on one block a slice of 8 units
        assert lstm_seq_plan(256, 1024, bwd, 128) == {
            "route": "grid", "grid": 128, "resident": True}
    # n 13: 7 blocks of 2 units, none empty
    assert lstm_seq_plan(5, 13, True, 8)["cluster"] == 7
    # n 8500: the grid route; 1063 slices, too many columns to keep:
    # streamed, and more slices than blocks, so blocks walk several
    plan = lstm_seq_plan(3, 8500)
    assert plan["route"] == "grid"
    assert not plan["resident"] and 0 < plan["grid"] < 1063


@pytest.mark.parametrize("T,b,n", [(12, 5, 13), (9, 33, 33), (8, 3, 9),
                                   (8, 2, 1), (10, 4, 41)])
def test_lstm_seq_cluster_route_repeats_at_uneven_splits(cuda, T, b, n):
    """n where 8 blocks of ceil(n / 8) units would leave a block empty
    (the route takes fewer blocks): many launches of both kernels, each
    bitwise equal to the first, which matches the plain version. An empty
    block would fall out of step with its peers' mbarrier phases (a hang
    or stale h) depending on which warp reached its wait last, so one
    launch proves little."""
    from deeplearning4j_tpu_torch.ops import (
        lstm_seq_bwd,
        lstm_seq_bwd_reference,
        lstm_seq_fwd,
        lstm_seq_fwd_reference,
    )

    _assert_lstm_route(T, b, n, False)
    _assert_lstm_route(T, b, n, True)
    xproj, h0, c0, rw, _ = _lstm_operands(T, b, n, 15)
    hseq, cseq, _, _ = lstm_seq_fwd_reference(xproj, h0, c0, rw)
    hprev = torch.cat([h0[None], hseq[:-1]])
    cprev = torch.cat([c0[None], cseq[:-1]])
    rng = np.random.RandomState(16)
    dhseq = _t(rng.randn(T, b, n) * 0.1, cuda)
    dhT, dcT = (_t(rng.randn(b, n) * 0.1, cuda) for _ in range(2))
    bwd_args = (xproj, hprev, cprev, cseq, rw, dhseq, dhT, dcT)
    fwd0, bwd0 = lstm_seq_fwd(xproj, h0, c0, rw), lstm_seq_bwd(*bwd_args)
    for got, ref in ((fwd0, lstm_seq_fwd_reference(xproj, h0, c0, rw)),
                     (bwd0, lstm_seq_bwd_reference(*bwd_args))):
        for a, r in zip(got, ref):
            _close_to_scale(a, r, 1e-4)
    for _ in range(40):
        fwd, bwd = lstm_seq_fwd(xproj, h0, c0, rw), lstm_seq_bwd(*bwd_args)
        for a, a0 in zip(fwd + bwd, fwd0 + bwd0):
            assert torch.equal(a, a0)
    torch.cuda.synchronize()


def test_lstm_cluster_plan_refused_raises(cuda, monkeypatch):
    """A cluster plan the kernels do not take is refused by the C entry
    and raises: no fallback to the grid route or the plain loop."""
    lstm_ops = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    xproj, h0, c0, rw, _ = _lstm_operands(3, 4, 16, 21)
    bad = lstm_ops.LstmSeqRoute("cluster", 16, 3, 2, 1)  # 16 blocks, 3 rows
    monkeypatch.setattr(lstm_ops, "lstm_seq_route", lambda *a: bad)
    before = dict(dispatch.launch_counts())
    with pytest.raises(RuntimeError, match="lstm_seq_fwd"):
        lstm_ops.lstm_seq_fwd(xproj, h0, c0, rw)
    assert dispatch.launch_counts() == before


def test_bidirectional_lstm_on_card_matches_cpu(cuda):
    from deeplearning4j_tpu_torch.nn.layers import GravesBidirectionalLSTM

    layer = GravesBidirectionalLSTM(n_in=7, n_out=24, peephole=False,
                                    mode="concat")
    params = layer.init_params(torch.Generator().manual_seed(1))
    x = np.random.RandomState(20).randn(5, 7, 9).astype(np.float32)
    outs = []
    for dev in (cuda, "cpu"):
        dispatch.reset_launch_counts()
        with torch.inference_mode():
            y, _ = layer.apply({k: v.to(dev) for k, v in params.items()},
                               _t(x, dev), {})
        outs.append(y.cpu())
    assert dispatch.launch_counts()["lstm_seq_fwd"] == 0  # the CPU's
    _close_to_scale(outs[0], outs[1], 1e-4)


@pytest.mark.parametrize("peephole", [True, False])
def test_char_rnn_fit_on_card_matches_cpu(cuda, peephole):
    """Three TBPTT chunks of a narrow char-RNN (RMSProp lr 0.1) on the
    card and on its CPU twin, with the launches of the minibatch; the
    tolerance is test_torch_char_rnn.py's (RMSProp's noise floor)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater("RMSPROP").list()
            .layer(GravesLSTM(n_in=11, n_out=40, peephole=peephole))
            .layer(GravesLSTM(n_in=40, n_out=40, peephole=peephole))
            .layer(RnnOutputLayer(n_out=11, loss="MCXENT"))
            .backprop_type("TruncatedBPTT").t_bptt_forward_length(5)
            .t_bptt_backward_length(5).build())
    net = MultiLayerNetwork(conf, device=cuda).init()
    net.scan_chunk = 1  # the per-chunk loop, whose launches are counted
    twin = MultiLayerNetwork(conf, device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in net.params.items()})
    ids = np.random.RandomState(21).randint(0, 11, (6, 16))
    eye = np.eye(11, dtype=np.float32)
    ds = DataSet(np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
                 np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1)))
    dispatch.reset_launch_counts()
    net.fit(ds)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    if peephole:   # 2 layers x 15 steps
        assert (counts["lstm_cell"], counts["lstm_seq_fwd"]) == (30, 0)
    else:          # 2 layers x 3 chunks, forward and backward
        assert (counts["lstm_cell"], counts["lstm_seq_fwd"],
                counts["lstm_seq_bwd"]) == (0, 6, 6)
    twin.fit(ds)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            torch.testing.assert_close(net.params[ln][pn].cpu(), ref,
                                       rtol=1e-3, atol=1e-4)


def test_lstm_sequence_kernels_replay_in_a_cuda_graph(cuda):
    """The cooperative sequence launches captured in a CUDA graph replay
    to the eager result (what a graph-captured training step needs)."""
    from deeplearning4j_tpu_torch.ops import lstm_seq_fwd

    xproj, h0, c0, rw, _ = _lstm_operands(12, 32, 200, 22)
    eager = lstm_seq_fwd(xproj, h0, c0, rw)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        lstm_seq_fwd(xproj, h0, c0, rw)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = lstm_seq_fwd(xproj, h0, c0, rw)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


# flash attention (b, h, t, d): the transformer's head dimension at a
# few q tiles, ragged t (a partial last tile; t 1), every head-dimension
# padding (8 -> 32, 48 -> 64, 128), and the long-context schedule's d
FLASH_CASES = [(2, 3, 128, 64), (1, 2, 100, 64), (2, 2, 17, 8),
               (1, 1, 130, 128), (1, 2, 1, 32), (1, 2, 300, 48)]


def _qkv(shape, device, dtype=torch.float32, seed=30):
    rng = np.random.RandomState(seed)
    return tuple(_t(rng.randn(*shape), device, dtype) for _ in range(3))


@pytest.mark.parametrize("shape", FLASH_CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("streamed", [False, True])
def test_flash_attention_kernel_matches_plain(cuda, shape, causal, streamed):
    import importlib

    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.ops.flash_attention")
    entry = "flash_attention_streamed" if streamed else "flash_attention"
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        q, k, v = _qkv(shape, cuda, dtype)
        before = dispatch.launch_counts()[entry]
        with torch.inference_mode():
            out = fa._kernel_forward(q, k, v, causal, streamed)
            again = fa._kernel_forward(q, k, v, causal, streamed)
            ref = fa.flash_attention_reference(q, k, v, causal,
                                               streamed=streamed)
        torch.cuda.synchronize()
        assert dispatch.launch_counts()[entry] == before + 2
        assert out.dtype == dtype and torch.equal(out, again)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 512, 4097])
@pytest.mark.parametrize("d", [32, 64, 100, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("streamed", [False, True])
def test_flash_attention_kernel_over_tiles_and_head_dims(cuda, t, d, causal,
                                                         streamed):
    """Both entries around the 64-key and 128-row tiles (t 1, 63-65, a
    ragged last tile at 4097), every head-dimension padding and K/V ring
    (d 100 and 128 take one f32 stage, two in half precision), in f32,
    bf16 and f16, each launch repeated bitwise."""
    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.ops.flash_attention")
    for dtype, rtol, atol in ((torch.float32, 1e-4, 2e-5),
                              (torch.bfloat16, 1e-2, 1e-2),
                              (torch.float16, 1e-2, 1e-2)):
        q, k, v = _qkv((1, 2, t, d), cuda, dtype, seed=t + d)
        with torch.inference_mode():
            out = fa._kernel_forward(q, k, v, causal, streamed)
            again = fa._kernel_forward(q, k, v, causal, streamed)
            ref = fa.flash_attention_reference(q, k, v, causal,
                                               streamed=streamed)
        torch.cuda.synchronize()
        assert out.dtype == dtype and torch.equal(out, again)
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=atol)


def test_flash_smem_plan_matches_the_kernel(cuda):
    import ctypes

    from deeplearning4j_tpu_torch.ops import _build

    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.ops.flash_attention")
    lib = _build.load()
    for dtype, code in _build.DTYPE_CODES.items():
        size = torch.empty((), dtype=dtype).element_size()
        for d in (1, 32, 33, 64, 100, 128):
            stages = ctypes.c_int(0)
            smem = lib.dl4j_flash_smem_bytes(code, d, ctypes.byref(stages))
            plan = fa.flash_smem_plan(d, size)
            assert (smem, stages.value) == (plan.smem_bytes, plan.stages)


def test_flash_attention_picks_the_entry_by_t_times_d(cuda, monkeypatch):
    import importlib

    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.ops.flash_attention")
    q, k, v = _qkv((1, 2, 64, 16), cuda)
    dispatch.reset_launch_counts()
    with torch.inference_mode():
        resident = flash_attention(q, k, v, causal=True)
        monkeypatch.setattr(fa, "_RESIDENT_TD_LIMIT", 63)
        streamed = flash_attention(q, k, v, causal=True)
    counts = dispatch.launch_counts()
    assert (counts["flash_attention"],
            counts["flash_attention_streamed"]) == (1, 1)
    assert torch.equal(resident, streamed)  # f32: the same function


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    """A launch the kernel refuses raises; it never runs the plain
    version instead."""
    dispatch.reset_launch_counts()
    q, k, v = _qkv((1, 2, 16, 136), cuda)
    with pytest.raises(ValueError, match="head dimension 136"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="head dimension"):
        mha(q, k, v, causal=True)
    qd, kd, vd = _qkv((1, 2, 16, 8), cuda, torch.float64)
    with pytest.raises(TypeError, match="unsupported dtype"):
        flash_attention(qd, kd, vd)
    q, k, v = _qkv((1, 2, 16, 8), cuda)
    with pytest.raises(TypeError):
        flash_attention(q, k.cpu(), v)
    assert sum(dispatch.launch_counts().values()) == 0


def test_mha_routes_every_mask_free_card_call_to_the_kernel(cuda):
    from deeplearning4j_tpu_torch.parallel.sequence import attention

    q, k, v = _qkv((2, 2, 24, 16), cuda)   # t 24: not attention_seq_ok
    mask = torch.ones(2, 24, device=cuda)
    mask[0, 10:] = 0
    dispatch.reset_launch_counts()
    with torch.inference_mode():
        out = mha(q, k, v, causal=True)
        assert dispatch.launch_counts()["flash_attention"] == 1
        masked = mha(q, k, v, causal=True, mask=mask)
        assert dispatch.launch_counts()["flash_attention"] == 1
        torch.testing.assert_close(out, attention(q, k, v, causal=True),
                                   rtol=1e-4, atol=2e-5)
        torch.testing.assert_close(
            masked, attention(q, k, v, causal=True, mask=mask))


def test_flash_attention_grads_match_the_cpu(cuda, monkeypatch):
    """The backward (the reference recompute; above the limit the
    blockwise loop) on the card against the same on the CPU."""
    import importlib

    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.ops.flash_attention")
    shape = (2, 2, 96, 32)
    g = np.random.RandomState(31).randn(*shape)
    for limit in (2048, 63):
        monkeypatch.setattr(fa, "_BWD_MATERIALIZE_T_LIMIT", limit)
        grads = []
        for dev in (cuda, "cpu"):
            leaves = [a.requires_grad_(True) for a in _qkv(shape, dev)]
            out = flash_attention(*leaves, causal=True)
            grads.append(torch.autograd.grad(out, leaves, _t(g, dev)))
        for a, b in zip(*grads):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


# (m, k, n) of the residual variant: the FFN's second product of a narrow
# block, a split-K shape (few tiles, deep k; the finish pass adds r) and
# ragged edges
RES_CASES = [(96, 128, 32), (16, 3072, 64), (70, 33, 129)]


@pytest.mark.parametrize("m,k,n", RES_CASES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_residual_matmul_kernel_matches_plain(cuda, m, k, n, activation):
    rng = np.random.RandomState(32)
    x = _t(rng.randn(m, k), cuda)
    w = _t(rng.randn(k, n) / np.sqrt(k), cuda)
    b = _t(rng.randn(n) * 0.1, cuda)
    r = _t(rng.randn(m, n), cuda)
    before = dispatch.launch_counts()
    with torch.inference_mode():
        out = matmul_block(x, w, b, r, activation=activation)
        ref = matmul_block_reference(x, w, b, r, activation=activation)
        outb = matmul_block(x.bfloat16(), w.bfloat16(), b, r.bfloat16(),
                            activation=activation)
        refb = matmul_block_reference(x.bfloat16(), w.bfloat16(), b,
                                      r.bfloat16(), activation=activation)
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    assert after["matmul_block_residual"] == before[
        "matmul_block_residual"] + 2
    assert after["matmul_block"] == before["matmul_block"]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outb.float(), refb.float(), rtol=2e-2,
                               atol=2e-2)
    with pytest.raises(ValueError, match="residual"):
        matmul_block(x, w, b, r[:-1].contiguous())


def test_residual_matmul_grads_match_plain(cuda):
    rng = np.random.RandomState(33)
    arrays = (rng.randn(40, 64), rng.randn(64, 24) / 8, rng.randn(24) * 0.1,
              rng.randn(40, 24))
    g = rng.randn(40, 24)
    grads = []
    for fn in (matmul_block, matmul_block_reference):
        leaves = [_t(a, cuda).requires_grad_(True) for a in arrays]
        out = fn(*leaves, activation="tanh")
        grads.append(torch.autograd.grad(out, leaves, _t(g, cuda)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _narrow_transformer():
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    return transformer_lm(vocab=11, d_model=64, n_layers=2, n_heads=4)


def test_transformer_fit_on_card_matches_cpu(cuda):
    """Two Adam steps of a narrow transformer LM on the card and on its
    CPU twin, with one step's launches: 2 flash attention (one a block),
    1 dense (the input projection), 2 residual (the FFN's second
    products)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(_narrow_transformer(), device=cuda).init()
    twin = MultiLayerNetwork(net.conf, device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in net.params.items()})
    ids = np.random.RandomState(34).randint(0, 11, (3, 97))
    eye = np.eye(11, dtype=np.float32)
    ds = DataSet(np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
                 np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1)))
    dispatch.reset_launch_counts()
    net.fit(ds)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "flash_attention": 2, "matmul_block": 1, "matmul_block_residual": 2}
    twin.fit(ds)
    net.fit(ds)
    twin.fit(ds)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            torch.testing.assert_close(net.params[ln][pn].cpu(), ref,
                                       rtol=1e-3, atol=1e-5)


def test_transformer_streaming_on_card_matches_output(cuda):
    """rnn_time_step through the KV cache launches no flash attention
    and gives output's probabilities; the long-context entry's first
    positions equal a short output (causality)."""
    import importlib

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.ops.flash_attention")
    net = MultiLayerNetwork(_narrow_transformer(), device=cuda).init()
    ids = np.random.RandomState(35).randint(0, 11, 40)
    x = np.ascontiguousarray(np.eye(11, dtype=np.float32)[ids].T[None])
    full = net.output(x)
    dispatch.reset_launch_counts()
    head = net.rnn_time_step(x[:, :, :30])
    steps = [net.rnn_time_step(x[:, :, t]) for t in range(30, 40)]
    assert dispatch.launch_counts()["flash_attention"] == 0
    stepped = torch.cat([head, torch.stack(steps, dim=2)], dim=2)
    _close_to_scale(stepped, full, 1e-4)
    old = fa._RESIDENT_TD_LIMIT
    try:
        fa._RESIDENT_TD_LIMIT = 16 * 16
        dispatch.reset_launch_counts()
        long = net.output(x)
        assert dispatch.launch_counts()["flash_attention_streamed"] == 2
    finally:
        fa._RESIDENT_TD_LIMIT = old
    torch.testing.assert_close(long, full)


# --- the routed kernels' routes ----------------------------------------------
#
# The dense kernel's wide route (128 x 192 tiles, a cp.async ring) and
# conv_bwd_data's resident route (an image's gradient and a channel
# group's weights in shared memory). Each case names the route it must
# take; the wide cases below a wave of tiles lower the route's threshold
# (matmul_block.WIDE_MIN_TILES) to reach the wide kernel at a small m.

# (m, k, n, residual, forced): the transformer's input projection; the
# FFN's second product at a narrower m with its residual; ragged m, n
# and k with k and n off multiples of 4 (4-byte staging, scalar stores)
WIDE_CASES = [(8192, 256, 768, False, False), (1024, 3072, 768, True, True),
              (1100, 1001, 770, True, True), (300, 40, 200, False, True)]


def _wide_route(monkeypatch, forced):
    mb = importlib.import_module("deeplearning4j_tpu_torch.ops.matmul_block")
    if forced:
        monkeypatch.setattr(mb, "WIDE_MIN_TILES", 1)
    return mb.matmul_route


def _wide_operands(m, k, n, residual, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = _t(rng.randn(m, k), "cuda", dtype)
    w = _t(rng.randn(k, n) / np.sqrt(k), "cuda", dtype)
    b = _t(rng.randn(n) * 0.1, "cuda")
    r = _t(rng.randn(m, n), "cuda", dtype) if residual else None
    return x, w, b, r


@pytest.mark.parametrize("m,k,n,residual,forced", WIDE_CASES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_wide_matmul_kernel_matches_plain(cuda, monkeypatch, m, k, n,
                                          residual, forced, activation):
    route = _wide_route(monkeypatch, forced)
    assert route(m, n) == "wide"
    x, w, b, r = _wide_operands(m, k, n, residual, 40)
    name = "matmul_block_residual" if residual else "matmul_block"
    before = dispatch.launch_counts()[name]
    with torch.inference_mode():
        out = matmul_block(x, w, b, r, activation=activation)
        again = matmul_block(x, w, b, r, activation=activation)
        ref = matmul_block_reference(x, w, b, r, activation=activation)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()[name] == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n,residual,forced", WIDE_CASES[1:3])
def test_wide_matmul_kernel_half_inputs(cuda, monkeypatch, dtype, m, k, n,
                                        residual, forced):
    route = _wide_route(monkeypatch, forced)
    assert route(m, n) == "wide"
    x, w, b, r = _wide_operands(m, k, n, residual, 41, dtype)
    with torch.inference_mode():
        out = matmul_block(x, w, b, r, activation="relu")
        ref = matmul_block_reference(x, w, b, r, activation="relu")
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


def test_wide_matmul_unaligned_operands(cuda, monkeypatch):
    """Views that start 4 bytes into their storage: the launcher stages
    w in 4-byte copies and stores one float at a time."""
    route = _wide_route(monkeypatch, True)
    m, k, n = 260, 96, 132
    assert route(m, n) == "wide"
    rng = np.random.RandomState(43)
    x = _t(rng.randn(m, k), cuda)
    w = _t(rng.randn(k * n + 1) / np.sqrt(k), cuda)[1:].view(k, n)
    b = _t(rng.randn(n + 1) * 0.1, cuda)[1:]
    r = _t(rng.randn(m * n + 1), cuda)[1:].view(m, n)
    with torch.inference_mode():
        out = matmul_block(x, w, b, r, activation="tanh")
        ref = matmul_block_reference(x, w, b, r, activation="tanh")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("residual", [False, True])
def test_wide_matmul_grads_match_plain(cuda, monkeypatch, residual):
    route = _wide_route(monkeypatch, True)
    m, k, n = 520, 200, 260
    assert route(m, n) == "wide"
    rng = np.random.RandomState(44)
    arrays = [rng.randn(m, k), rng.randn(k, n) / np.sqrt(k),
              rng.randn(n) * 0.1] + ([rng.randn(m, n)] if residual else [])
    g = _t(rng.randn(m, n), cuda)
    grads = []
    for fn in (matmul_block, matmul_block_reference):
        leaves = [_t(a, cuda).requires_grad_(True) for a in arrays]
        out = fn(*leaves, activation="leakyrelu")
        grads.append(torch.autograd.grad(out, leaves, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# (m, k, n, residual): the dense kernel's skinny route (at most
# SKINNY_MAX_M rows): AlexNet's first dense layer at batch 1 (16-byte
# loads of w, split K), LeNet's at batch 1 (n 500), eight rows with the
# residual, a ragged n and k (scalar loads, a k tail short of the
# unrolled rows) and a k too short to split
SKINNY_CASES = [(1, 9216, 4096, False), (1, 800, 500, False),
                (8, 4096, 1000, True), (3, 1001, 770, True),
                (5, 40, 130, False)]


@pytest.mark.parametrize("m,k,n,residual", SKINNY_CASES)
@pytest.mark.parametrize("activation", sorted(SUPPORTED_EPILOGUES))
def test_skinny_matmul_kernel_matches_plain(cuda, m, k, n, residual,
                                            activation):
    mb = importlib.import_module("deeplearning4j_tpu_torch.ops.matmul_block")
    assert mb.matmul_route(m, n) == "skinny"
    x, w, b, r = _wide_operands(m, k, n, residual, 46)
    name = "matmul_block_residual" if residual else "matmul_block"
    before = dispatch.launch_counts()[name]
    with torch.inference_mode():
        out = matmul_block(x, w, b, r, activation=activation)
        again = matmul_block(x, w, b, r, activation=activation)
        ref = matmul_block_reference(x, w, b, r, activation=activation)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()[name] == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_skinny_matmul_kernel_half_inputs(cuda, dtype):
    x, w, b, r = _wide_operands(4, 3000, 516, True, 47, dtype)
    with torch.inference_mode():
        out = matmul_block(x, w, b, r, activation="relu")
        ref = matmul_block_reference(x, w, b, r, activation="relu")
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


def test_skinny_matmul_unaligned_operands(cuda):
    """A w that starts 4 bytes into its storage: the skinny route reads
    it one element at a time."""
    m, k, n = 2, 96, 132
    rng = np.random.RandomState(48)
    x = _t(rng.randn(m, k), cuda)
    w = _t(rng.randn(k * n + 1) / np.sqrt(k), cuda)[1:].view(k, n)
    b = _t(rng.randn(n + 1) * 0.1, cuda)[1:]
    with torch.inference_mode():
        out = matmul_block(x, w, b, activation="tanh")
        ref = matmul_block_reference(x, w, b, activation="tanh")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


# (x shape, w shape, stride, padding, group): conv_bwd_data's resident
# route at LeNet conv2 (batch 256, c 20), stride 2 with padding, c 3
# under an asymmetric stride, and two channel-grouped cases (40 channels
# in 2 x 20; 32 channels whose weights need 2 x 16)
RESIDENT_CASES = [
    ((256, 20, 12, 12), (50, 20, 5, 5), 1, 0, 20),
    ((3, 6, 11, 10), (9, 6, 3, 3), 2, 1, 6),
    ((2, 3, 9, 7), (7, 3, 3, 2), (2, 1), (2, 0), 3),
    ((2, 40, 12, 12), (64, 40, 5, 5), 1, 0, 20),
    ((2, 32, 12, 12), (80, 32, 5, 5), 1, 0, 16),
]


@pytest.mark.parametrize("xs,ws,stride,padding,group", RESIDENT_CASES)
def test_conv_bwd_data_resident_route_matches_plain(cuda, xs, ws, stride,
                                                    padding, group):
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_data_route

    plan = conv_bwd_data_route(*xs, ws[0], ws[2], ws[3], stride, padding)
    assert plan.route == "resident" and plan.group == group
    _, w, dacc = _bwd_operands(xs, ws, stride, padding, 45)
    got = conv_bwd_data(dacc, w, xs[2:], stride, padding)
    again = conv_bwd_data(dacc, w, xs[2:], stride, padding)
    ref = conv_bwd_data_reference(dacc, w, xs[2:], stride, padding)
    lib = torch.nn.grad.conv2d_input(xs, w, dacc, stride=stride,
                                     padding=padding)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close_to_scale(got, ref, 5e-5)
    _close_to_scale(got, lib, 5e-5)


def test_conv_bwd_data_gemm_route_matches_plain(cuda):
    """AlexNet's conv3 (at batch 4): its gradient maps and weights do not
    fit a block, so it keeps the implicit GEMM."""
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_data_route

    xs, ws, stride, padding = (4, 256, 13, 13), (384, 256, 3, 3), 1, 1
    assert conv_bwd_data_route(*xs, ws[0], ws[2], ws[3], stride,
                               padding).route == "gemm"
    _, w, dacc = _bwd_operands(xs, ws, stride, padding, 46)
    got = conv_bwd_data(dacc, w, xs[2:], stride, padding)
    ref = conv_bwd_data_reference(dacc, w, xs[2:], stride, padding)
    lib = torch.nn.grad.conv2d_input(xs, w, dacc, stride=stride,
                                     padding=padding)
    torch.cuda.synchronize()
    _close_to_scale(got, ref, 5e-5)
    _close_to_scale(got, lib, 5e-5)


# --- VGG-16 on CIFAR-10 ------------------------------------------------------
#
# VGG-16's convs at batch 128 run in test_conv_block_kernel_matches_plain
# above (its dense layers in MATMUL_CASES); here both backward kernels
# at each of them, the conv forward with a BN scale / shift at two, the
# conv -> BN fold, and one full-width VGG-16 training step against the
# CPU.


@pytest.mark.parametrize("xs,ws,stride,padding", VGG_CONV_CASES)
def test_vgg_conv_bwd_kernels_match_plain_and_repeat(cuda, xs, ws, stride,
                                                     padding):
    """dx and dW against their plain versions, and bitwise on a second
    launch. Held to the plain version alone: at these depths (dW sums
    131,072 products at conv1) cuDNN's own dW (conv2d_weight, TF32 off)
    was measured 0.099 off the kernel in one of conv1's 36,864 entries
    (4e-4 of that entry), past 5e-5 of the scale, where the kernel
    holds to the plain version within it."""
    x, w, dacc = _bwd_operands(xs, ws, stride, padding, 12)
    dx = [conv_bwd_data(dacc, w, xs[2:], stride, padding) for _ in range(2)]
    dw = [conv_bwd_w(x, dacc, ws, stride, padding) for _ in range(2)]
    dx_ref = conv_bwd_data_reference(dacc, w, xs[2:], stride, padding)
    dw_ref = conv_bwd_w_reference(x, dacc, ws, stride, padding)
    torch.cuda.synchronize()
    assert torch.equal(dx[0], dx[1]) and torch.equal(dw[0], dw[1])
    _close_to_scale(dx[0], dx_ref, 5e-5)
    _close_to_scale(dw[0], dw_ref, 5e-5)


@pytest.mark.parametrize("xs,ws,stride,padding", [VGG_CONV_CASES[1],
                                                  VGG_CONV_CASES[-1]])
def test_vgg_conv_block_with_bn_terms_matches_plain(cuda, xs, ws, stride,
                                                    padding):
    x, w, b = _conv_operands(xs, ws, 15)
    rng = np.random.RandomState(16)
    scale = _t(rng.rand(ws[0]) + 0.5, cuda)
    shift = _t(rng.randn(ws[0]) * 0.3, cuda)
    kw = dict(stride=stride, padding=padding, activation="relu")
    with torch.inference_mode():
        out = conv_block(x, w, b, scale, shift, **kw)
        ref = conv_block_reference(x, w, b, scale, shift, **kw)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_conv_bn_fold_on_the_card_matches_the_unfused_cpu_walk(cuda):
    """A MultiLayer Conv(identity) -> BN(relu) network: its inference
    forward is one conv_block launch (the fold) and equals the CPU twin
    walked layer by layer; a training step (no fold) moves the running
    statistics as the CPU twin's does."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
        ShapeContext,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalization,
        ConvolutionLayer,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(1).updater("NESTEROVS")
            .learning_rate(0.01).list()
            .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                    padding=(1, 1)))
            .layer(BatchNormalization(activation="relu"))
            .layer(OutputLayer(n_out=5, loss="MCXENT"))
            .set_input_type(InputType.convolutional(8, 8, 8)).build())
    rng = np.random.RandomState(17)
    net = MultiLayerNetwork(conf, device=cuda).init()
    net.state["1"] = {"mean": _t(rng.randn(16) * 0.2, cuda),
                      "var": _t(rng.rand(16) + 0.5, cuda)}
    twin = MultiLayerNetwork(conf, device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in net.params.items()})
    twin.state = {ln: {k: t.cpu() for k, t in st.items()}
                  for ln, st in net.state.items()}
    x = rng.rand(32, 8, 8, 8).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 32)]
    dispatch.reset_launch_counts()
    out = net.output(x)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_block"] == 1
    h = torch.from_numpy(x)
    ctx = ShapeContext(batch=32)
    with torch.inference_mode():
        for i, name in enumerate(twin.layer_names):
            if i in conf.preprocessors:
                h = conf.preprocessors[i].preprocess(h, ctx)
            h, _ = conf.layers[i].apply(twin.params[name], h.contiguous(),
                                        twin.state[name])
    torch.testing.assert_close(out.cpu(), h, rtol=1e-4, atol=1e-6)
    dispatch.reset_launch_counts()
    net.fit(DataSet(x, y))
    twin.fit(DataSet(x, y))
    assert dispatch.launch_counts()["conv_block"] == 2
    for k in ("mean", "var"):
        torch.testing.assert_close(net.state["1"][k].cpu(),
                                   twin.state["1"][k], rtol=1e-4, atol=1e-6)


def test_vgg16_graph_step_on_the_card_matches_the_cpu_twin(cuda):
    """One full-width VGG-16 step (batch 8, NESTEROVS) through
    ``ComputationGraph.fit`` on the card, with exact launch counts (no
    dx at conv0), against the same step on the CPU."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import vgg16

    net = ComputationGraph(vgg16(), device=cuda).init()
    twin = ComputationGraph(vgg16(), device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in net.params.items()})
    rng = np.random.RandomState(18)
    ds = DataSet(rng.rand(8, 3, 32, 32).astype(np.float32),
                 np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
    dispatch.reset_launch_counts()
    net.fit(ds)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "conv_block": 26, "conv_bwd_data": 12, "conv_bwd_w": 13,
        "matmul_block": 2}
    twin.fit(ds)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            torch.testing.assert_close(net.params[ln][pn].cpu(), ref,
                                       rtol=1e-4, atol=1e-6)


# ResNet-50's new conv geometry (1 x 1 stride-2 projections, 3 x 3
# stride-2 padding-1 convs on an even side, the 7 x 7 stride-2 stem, 1 x
# 1 convs at c 2048): the resident dx plan a small case takes when
# forced, and the full-width shapes at a small batch on the routes their
# rules pick
def _resident_dx_plan(xs, ws, stride, padding):
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    (sh, sw), (ph, pw) = cb._pair(stride), cb._pair(padding)
    oh = cb.conv_output_size(xs[2], ws[2], sh, ph)
    ow = cb.conv_output_size(xs[3], ws[3], sw, pw)
    c = xs[1]
    group = -(-c // -(-c // cb.RESIDENT_MAX_GROUP))
    plan = cb._resident_plan(xs[2], xs[3], ws[0], oh, ow, ws[2], ws[3], group)
    assert plan.smem_bytes <= cb.RESIDENT_SMEM_BYTES
    return plan


def _dx_on_dirty_memory(dacc, w, xs, stride, padding):
    """conv_bwd_data with the caching allocator handing it a block that
    last held NaN: every dx element must be written, the ones no output
    reaches with 0."""
    junk = torch.full((int(np.prod(xs)),), float("nan"), device=dacc.device)
    del junk
    return conv_bwd_data(dacc, w, xs[2:], stride, padding)


@pytest.mark.parametrize("route", ["resident", "gemm"])
@pytest.mark.parametrize("xs,ws", [((4, 64, 14, 14), (128, 64, 1, 1)),
                                   ((3, 20, 16, 12), (36, 20, 1, 1))])
def test_conv_bwd_data_one_by_one_stride_two_writes_untouched_zeros(
        cuda, monkeypatch, route, xs, ws):
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    plan = (_resident_dx_plan(xs, ws, 2, 0) if route == "resident"
            else cb.BwdDataRoute("gemm"))
    monkeypatch.setattr(cb, "conv_bwd_data_route", lambda *a, **k: plan)
    _, w, dacc = _bwd_operands(xs, ws, 2, 0, 30)
    got = _dx_on_dirty_memory(dacc, w, xs, 2, 0)
    ref = conv_bwd_data_reference(dacc, w, xs[2:], 2, 0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # three quarters of dx: odd rows or odd columns, which no output reads
    untouched = torch.ones(xs[2:], dtype=torch.bool, device=cuda)
    untouched[::2, ::2] = False
    assert torch.equal(got[:, :, untouched],
                       torch.zeros_like(got[:, :, untouched]))
    _close_to_scale(got, ref, 5e-5)


@pytest.mark.parametrize("route", ["resident", "gemm"])
def test_conv_bwd_three_by_three_stride_two_even_side(cuda, monkeypatch,
                                                      route):
    """3 x 3, stride 2, padding 1 on an even side: the last input row and
    column are reached by the last output's third tap alone."""
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    xs, ws = (4, 16, 16, 16), (24, 16, 3, 3)
    plan = (_resident_dx_plan(xs, ws, 2, 1) if route == "resident"
            else cb.BwdDataRoute("gemm"))
    monkeypatch.setattr(cb, "conv_bwd_data_route", lambda *a, **k: plan)
    x, w, dacc = _bwd_operands(xs, ws, 2, 1, 31)
    got = _dx_on_dirty_memory(dacc, w, xs, 2, 1)
    ref = conv_bwd_data_reference(dacc, w, xs[2:], 2, 1)
    dw = conv_bwd_w(x, dacc, ws, 2, 1)
    dw_ref = conv_bwd_w_reference(x, dacc, ws, 2, 1)
    torch.cuda.synchronize()
    assert float(ref[:, :, -1, :].abs().max()) > 0
    assert float(ref[:, :, :, -1].abs().max()) > 0
    _close_to_scale(got, ref, 5e-5)
    torch.testing.assert_close(got[:, :, -1, :], ref[:, :, -1, :],
                               rtol=0, atol=5e-5 * float(ref.abs().max()))
    _close_to_scale(dw, dw_ref, 5e-5)


# (x shape, w shape, stride, padding) at ResNet-50's widths, small batch
RESNET_CONV_CASES = [
    ((8, 3, 224, 224), (64, 3, 7, 7), 2, 3),        # the stem
    ((8, 256, 56, 56), (512, 256, 1, 1), 2, 0),     # a stride-2 projection
    ((8, 128, 56, 56), (128, 128, 3, 3), 2, 1),     # a stride-2 3 x 3
    ((16, 2048, 7, 7), (512, 2048, 1, 1), 1, 0),    # 1 x 1 at c 2048 @ 7
    ((16, 512, 7, 7), (2048, 512, 1, 1), 1, 0),
]


@pytest.mark.parametrize("xs,ws,stride,padding", RESNET_CONV_CASES)
def test_resnet_conv_kernels_match_plain_and_repeat(cuda, xs, ws, stride,
                                                    padding):
    """The forward (identity epilogue, as ResNet's convs run before their
    BN), dx (not at the stem: its input is the data) and dW against their
    plain versions, each bitwise on a second launch, dx on dirty
    memory."""
    x, w, b = _conv_operands(xs, ws, 32)
    kw = dict(stride=stride, padding=padding, activation="identity")
    with torch.inference_mode():
        out = [conv_block(x, w, b, **kw) for _ in range(2)]
        ref = conv_block_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])
    torch.testing.assert_close(out[0], ref, rtol=1e-4, atol=1e-4)
    x, w, dacc = _bwd_operands(xs, ws, stride, padding, 33)
    if xs[1] != 3:
        dx = [_dx_on_dirty_memory(dacc, w, xs, stride, padding)
              for _ in range(2)]
        dx_ref = conv_bwd_data_reference(dacc, w, xs[2:], stride, padding)
        torch.cuda.synchronize()
        assert torch.equal(dx[0], dx[1])
        _close_to_scale(dx[0], dx_ref, 5e-5)
    dw = [conv_bwd_w(x, dacc, ws, stride, padding) for _ in range(2)]
    dw_ref = conv_bwd_w_reference(x, dacc, ws, stride, padding)
    torch.cuda.synchronize()
    assert torch.equal(dw[0], dw[1])
    _close_to_scale(dw[0], dw_ref, 5e-5)


def test_resnet50_graph_step_on_the_card_matches_the_cpu_twin(cuda,
                                                              monkeypatch):
    """One full-width ResNet-50 step (224 x 224, batch 4, NESTEROVS)
    through ``ComputationGraph.fit`` on the card, with exact launch
    counts (53 convs: forward and f32 recompute each, dW of all, dx of
    all but the stem), against the same step on the CPU. Every conv
    kernel call of the step is held against its plain version on the
    same operands (5e-5 of scale). The weights are held within half of
    each parameter's move: at ResNet-50's init the 53 BNs' backward
    cancels most of a gradient that the global average pool makes
    nearly constant over a channel, so f32 rounding in the forward
    reaches the updates amplified (up to 27 % of a move between card and
    CPU from the same state, measured), though the scores and the
    running statistics (forward sums) agree closely."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import resnet50

    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    held = []

    def holding(kernel, plain):
        def call(*args):
            got = kernel(*args)
            ref = plain(*args)
            held.append(float((got - ref).abs().max())
                        / max(float(ref.abs().max()), 1e-30))
            return got
        return call

    monkeypatch.setattr(cb, "_kernel_forward",
                        holding(cb._kernel_forward, cb._plain_forward))
    monkeypatch.setattr(cb, "conv_bwd_data",
                        holding(cb.conv_bwd_data, cb.conv_bwd_data_reference))
    monkeypatch.setattr(cb, "conv_bwd_w",
                        holding(cb.conv_bwd_w, cb.conv_bwd_w_reference))
    net = ComputationGraph(resnet50(learning_rate=0.01), device=cuda).init()
    before = {ln: {pn: t.cpu() for pn, t in lp.items()}
              for ln, lp in net.params.items()}
    twin = ComputationGraph(net.conf, device="cpu").init(params=before)
    rng = np.random.RandomState(34)
    # standardized pixels, as an ImageNet pipeline feeds them
    ds = DataSet(rng.randn(4, 3, 224, 224).astype(np.float32),
                 np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, 4)])
    dispatch.reset_launch_counts()
    net.fit(ds)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "conv_block": 106, "conv_bwd_data": 52, "conv_bwd_w": 53}
    assert len(held) == 211 and max(held) <= 5e-5
    twin.fit(ds)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            move = float((ref - before[ln][pn]).abs().max())
            diff = float((net.params[ln][pn].cpu() - ref).abs().max())
            assert diff <= 0.5 * move + 1e-6, (ln, pn, diff, move)
    for ln, st in twin.state.items():
        for k, ref in st.items():
            torch.testing.assert_close(net.state[ln][k].cpu(), ref,
                                       rtol=1e-3, atol=1e-5)


# -- the embeddings subsystem on the card --------------------------------


def _w2v_corpus(n=400, length=20, vocab=300, seed=0):
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    sents = [[f"w{i}" for i in rng.choice(vocab, size=length, p=p)]
             for _ in range(n)]
    cache = VocabConstructor(1).build_vocab_from_tokens(sents)
    return cache, [np.asarray([cache.index_of(w) for w in s], np.int32)
                   for s in sents]


def test_word2vec_device_generation_is_bitwise_repeatable(cuda):
    """Two device-generation fits from one seed: the same tables bit for
    bit (the row fold sums duplicates in a fixed order), and the route
    launches no atomics-ordered accumulation that could differ."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    cache, ids = _w2v_corpus()
    runs = []
    for _ in range(2):
        w = Word2Vec(cache, ids, layer_size=32, window=5, negative=5,
                     batch_size=1024, epochs=2, seed=1, device=cuda)
        assert w._use_device_gen()
        w.fit()
        runs.append((w.lookup.syn0.clone(), w.lookup.syn1neg.clone()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_sparse_fold_on_the_card_equals_the_cpu(cuda):
    from deeplearning4j_tpu_torch.embeddings import sparse

    rng = np.random.RandomState(0)
    ids = torch.from_numpy((rng.zipf(1.2, 50000) - 1).clip(0, 99))
    g = torch.from_numpy(rng.randn(50000, 64).astype(np.float32))
    u, s, n = sparse.dedup_segment_sum(ids.to(cuda), g.to(cuda))
    cu, cs, cn = sparse.dedup_segment_sum(ids, g)
    assert int(n) == int(cn) and torch.equal(u.cpu(), cu)
    torch.testing.assert_close(s.cpu(), cs, rtol=1e-5, atol=1e-4)
    again = sparse.dedup_segment_sum(ids.to(cuda), g.to(cuda))[1]
    assert torch.equal(again, s)


def test_sharded_lookup_on_the_card_equals_unsharded(cuda):
    from deeplearning4j_tpu_torch.embeddings import ShardedEmbeddingTable

    rng = np.random.RandomState(1)
    rows = rng.randn(257, 16).astype(np.float32)
    t = ShardedEmbeddingTable.from_rows(rows, device=cuda)
    assert t.table.is_cuda
    ids = rng.randint(0, 257, (33, 7))
    assert np.array_equal(t.lookup(ids).cpu().numpy(), rows[ids])
    grads = rng.randn(300, 16).astype(np.float32)
    hot = (rng.zipf(1.3, 300) - 1).clip(0, 256)
    t.apply_sparse_grads(hot, grads, 0.1)
    plain = ShardedEmbeddingTable.from_rows(rows, device="cpu")
    plain.apply_sparse_grads(hot, grads, 0.1)
    np.testing.assert_allclose(t.to_host(), plain.to_host(), rtol=1e-5,
                               atol=1e-6)


# -- half precision: the conv kernels' dtype variants ----------------------

HALF = [torch.bfloat16, torch.float16]
# bf16 / f16 outputs round once on the store: held at bf16 eps of the
# output's scale; f32 outputs of half operands (the recompute, dW) sum
# the same exact products in another order: 5e-5 of the scale
HALF_OUT_REL = 1e-2

# (x shape, w shape, stride, padding) at LeNet-5's, VGG-16's and
# ResNet-50's widths, small batches: each is wide in every dtype
HALF_WIDE_CASES = [
    ((256, 1, 28, 28), (20, 1, 5, 5), 1, 0),
    ((32, 64, 32, 32), (64, 64, 3, 3), 1, 1),
    ((8, 3, 224, 224), (64, 3, 7, 7), 2, 3),
    ((8, 256, 56, 56), (512, 256, 1, 1), 2, 0),
]


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("xs,ws,stride,padding", HALF_WIDE_CASES)
def test_conv_block_wide_route_half_in_half_out(cuda, dtype, xs, ws, stride,
                                                padding):
    """The wide route on a half image writes the image's dtype: against
    the plain version (f32 sums of the half values, one cast), repeated
    bitwise, one launch a call."""
    from deeplearning4j_tpu_torch.ops.conv_block import conv_block_route

    plan = conv_block_route(*xs, ws[0], ws[2], ws[3], stride, padding, dtype)
    assert plan.route == "wide"
    assert plan == conv_block_route(*xs, ws[0], ws[2], ws[3], stride,
                                    padding)
    x, w, b = _conv_operands(xs, ws, 40, dtype)
    kw = dict(stride=stride, padding=padding, activation="relu")
    before = dispatch.launch_counts()["conv_block"]
    with torch.inference_mode():
        out = [conv_block(x, w, b, **kw) for _ in range(2)]
        ref = conv_block_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["conv_block"] == before + 2
    assert out[0].dtype == dtype and torch.equal(out[0], out[1])
    _close_to_scale(out[0].float(), ref.float(), HALF_OUT_REL)


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("xs,ws,stride,padding,route",
                         [c + ("wide",) for c in HALF_WIDE_CASES]
                         + [c + ("direct",) for c in HALF_WIDE_CASES]
                         + [CONV_CASES[1] + ("direct",)])
def test_conv_block_half_in_f32_out(cuda, monkeypatch, route, dtype, xs, ws,
                                    stride, padding):
    """The backward's recompute: half operands, f32 accumulator out (JAX
    ``_direct_conv_call(..., jnp.float32)``), on each route forced."""
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    plan = cb.conv_block_route(*xs, ws[0], ws[2], ws[3], stride, padding,
                               dtype)
    assert plan.route == ("direct" if xs == CONV_CASES[1][0] else "wide")
    if route == "direct":
        plan = cb.ConvRoute("direct")
    monkeypatch.setattr(cb, "conv_block_route", lambda *a, **k: plan)
    x, w, _ = _conv_operands(xs, ws, 41, dtype)
    o = ws[0]
    ones = torch.ones(o, device=cuda)
    zeros = torch.zeros(o, device=cuda)
    st, pad = cb._pair(stride), cb._pair(padding)
    with torch.inference_mode():
        got = [cb._kernel_forward(x, w, ones, zeros, st, pad, "identity",
                                  torch.float32) for _ in range(2)]
        ref = cb._plain_forward(x, w, ones, zeros, st, pad, "identity",
                                torch.float32)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32 and torch.equal(got[0], got[1])
    _close_to_scale(got[0], ref, 5e-5)


# (x shape, w shape, stride, padding, route) of conv_bwd_w on a half
# image: LeNet-5's convs at the training batch (image-resident), a VGG-16
# conv and ResNet-50's stem and a 3 x 3 stride-2 conv (implicit GEMM)
HALF_DW_CASES = [
    ((256, 1, 28, 28), (20, 1, 5, 5), 1, 0, "image_resident"),
    ((256, 20, 12, 12), (50, 20, 5, 5), 1, 0, "image_resident"),
    ((32, 64, 32, 32), (64, 64, 3, 3), 1, 1, "gemm"),
    ((8, 3, 224, 224), (64, 3, 7, 7), 2, 3, "gemm"),
    ((8, 128, 56, 56), (128, 128, 3, 3), 2, 1, "gemm"),
]


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("xs,ws,stride,padding,route", HALF_DW_CASES)
def test_conv_bwd_w_on_a_half_image(cuda, dtype, xs, ws, stride, padding,
                                    route):
    """dW from a half image and the f32 dacc: f32 out, against the plain
    version (the same exact products in f32), repeated bitwise."""
    from deeplearning4j_tpu_torch.ops.conv_block import conv_bwd_w_route

    assert conv_bwd_w_route(*xs, ws[0], ws[2], ws[3], stride,
                            padding).route == route
    x, _, dacc = _bwd_operands(xs, ws, stride, padding, 42)
    xh = x.to(dtype)
    got = [conv_bwd_w(xh, dacc, ws, stride, padding) for _ in range(2)]
    ref = conv_bwd_w_reference(xh, dacc, ws, stride, padding)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32 and torch.equal(got[0], got[1])
    _close_to_scale(got[0], ref, 5e-5)
    # the half image's values exactly, in f32: the same sums
    _close_to_scale(got[0], conv_bwd_w(xh.float(), dacc, ws, stride,
                                       padding), 5e-5)


@pytest.mark.parametrize("dtype", HALF)
def test_conv_block_half_backward_matches_plain(cuda, dtype):
    """One half-precision conv_block backward (x, w, bias all wanting a
    gradient) on the kernels against the plain version on the same
    operands, with the launches: the forward, the f32 recompute, dx and
    dW."""
    xs, ws = (16, 32, 14, 14), (48, 32, 3, 3)
    x, w, b = _conv_operands(xs, ws, 43, dtype)
    g = _t(np.random.RandomState(44).randn(16, 48, 14, 14), cuda, dtype)
    grads = []
    for fn in (conv_block, conv_block_reference):
        xi, wi, bi = (t.detach().clone().requires_grad_(True)
                      for t in (x, w, b))
        dispatch.reset_launch_counts()
        out = fn(xi, wi, bi, stride=1, padding=1, activation="relu")
        out.backward(g)
        torch.cuda.synchronize()
        if fn is conv_block:
            counts = dispatch.launch_counts()
            assert (counts["conv_block"], counts["conv_bwd_data"],
                    counts["conv_bwd_w"]) == (2, 1, 1)
        assert xi.grad.dtype == dtype and wi.grad.dtype == dtype
        grads.append((out.float(), xi.grad.float(), wi.grad.float(),
                      bi.grad.float()))
    for got, ref in zip(*grads):
        _close_to_scale(got, ref, HALF_OUT_REL)


def test_conv_routes_pinned_for_half_inputs(cuda):
    """The forward's route and tile at every distinct conv shape of
    LeNet-5's, VGG-16's and ResNet-50's steps are the same in bf16 and
    f16 as in f32 (the wide ring holds f32 in every dtype), and the
    backward routes take no dtype."""
    from chip_smoke import kernel_shapes, resnet_shapes, vgg_shapes
    from deeplearning4j_tpu_torch.ops.conv_block import conv_block_route
    from deeplearning4j_tpu_torch.zoo import lenet

    shapes = [geo for _, kind, geo in kernel_shapes(lenet(), 256)
              if kind == "conv_block"]
    shapes += [geo for _, kind, geo, _ in vgg_shapes() + resnet_shapes()
               if kind == "conv_block"]
    assert len(shapes) > 20
    for geo in shapes:
        args = (*geo["x"], geo["w"][0], *geo["w"][2:], tuple(geo["stride"]),
                tuple(geo["padding"]))
        f32 = conv_block_route(*args)
        for dt in HALF:
            assert conv_block_route(*args, dtype=dt) == f32, geo


# -- dropout masks and megastep chunks on the card ---------------------------


@pytest.mark.parametrize("shape", [(128, 9216), (7, 3, 5, 5), (1,)])
def test_masks_on_the_card_are_the_cpus_bitwise(cuda, shape):
    from deeplearning4j_tpu_torch.nn import random

    for key in (random.fold_in(random.host_key(42), 3),
                random.fold_in(random.key(42, cuda), torch.tensor(3,
                                                                 device=cuda))):
        on_card = random.bernoulli(key, 0.5, shape, offset=11, device=cuda)
        assert on_card.is_cuda
        cpu_key = key if isinstance(key, tuple) else key.cpu()
        assert torch.equal(on_card.cpu(),
                           random.bernoulli(cpu_key, 0.5, shape, offset=11))


def _lenet_batches(n, batch=32, seed=0):
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.RandomState(seed)
    return [DataSet(rng.rand(batch, 784).astype(np.float32),
                    np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)])
            for _ in range(n)]


def _alex_batches(n, batch=8, seed=1):
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.RandomState(seed)
    return [DataSet((rng.rand(batch, 3, 67, 67) * 0.9 + 0.05).astype(
        np.float32), np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)])
        for _ in range(n)]


def _models():
    import chip_smoke
    from deeplearning4j_tpu_torch.zoo import lenet

    return {"lenet": (lambda: lenet(dense_width=64), _lenet_batches),
            "narrow_alexnet": (chip_smoke.narrow_alexnet, _alex_batches)}


def _same(a, b):
    import chip_smoke

    return chip_smoke.same_trees(torch, a, b)


@pytest.mark.parametrize("name", ["lenet", "narrow_alexnet"])
def test_graphed_chunk_is_the_eager_chunk_and_the_per_step_loop(cuda, name):
    """A megastep fit replays one captured chunk a block, bitwise equal
    to the per-step loop on the card and to the same chunk run eagerly
    (``core.chunk_steps`` on the card, not captured)."""
    from deeplearning4j_tpu_torch.nn import core, random
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    make, data = _models()[name]
    batches = data(8)
    ref = MultiLayerNetwork(make(), device=cuda).init()
    ref.scan_chunk = 1  # the per-step loop
    init = {ln: {pn: t.clone() for pn, t in lp.items()}
            for ln, lp in ref.params.items()}
    ref.fit(batches)
    mega = MultiLayerNetwork(make(), device=cuda).init(params=init)
    dispatch.reset_launch_counts()
    mega.fit(batches, megastep=4)
    at_capture = sum(dispatch.launch_counts().values())
    mega.fit(batches)  # replays only: Python launches nothing
    assert sum(dispatch.launch_counts().values()) == at_capture
    assert len(mega._megastep_graphs) == 1
    assert mega.iteration_count == 16
    ref.fit(batches)
    assert _same(ref, mega)
    # the eager chunk on the card from the same state
    eager = MultiLayerNetwork(make(), device=cuda).init(params=init)
    chunk = eager._stack_chunk(batches[:4])
    names, rows = eager.updater_def.lr_table(0, 4)
    trees, _ = core.chunk_steps(
        eager, eager._train_step(),
        (eager.params, eager.updater_state, eager.state, None, None),
        tuple(core._map_tree(lambda a: a.to(cuda), f)
              for f in chunk[:4]),
        names, torch.from_numpy(rows).to(cuda),
        torch.tensor(0, device=cuda), random.key(eager.conf.seed, cuda), 4)
    graphed = MultiLayerNetwork(make(), device=cuda).init(params=init)
    graphed.fit(batches[:4], megastep=4)
    eager.params, eager.updater_state, eager.state = trees[:3]
    assert _same(eager, graphed)


def test_a_capture_that_meets_a_host_sync_raises(cuda):
    from dataclasses import dataclass

    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        ActivationLayer,
        DenseLayer,
        OutputLayer,
        register_layer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    @register_layer
    @dataclass(frozen=True)
    class HostSyncLayer(ActivationLayer):
        def apply(self, params, x, state, *, train=False, rng=None,
                  mask=None):
            if float(x.abs().sum()) < 0:  # a device -> host read
                x = -x
            return x, state

    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater("SGD").list()
            .layer(DenseLayer(n_in=784, n_out=16, activation="relu"))
            .layer(HostSyncLayer())
            .layer(OutputLayer(n_out=10)).build())
    net = MultiLayerNetwork(conf, device=cuda).init()
    batches = _lenet_batches(4)
    net.fit(batches[:1])  # per step: the read is only slow
    with pytest.raises(RuntimeError, match="capturing the 3-step chunk"):
        net.fit(batches[1:], megastep=3)
    assert net.iteration_count == 1


def test_graph_engine_megastep_on_the_card_is_the_per_step_loop(cuda):
    """A ComputationGraph with dropout and BatchNormalization: chunks of
    3 (two captured replays, a per-step tail) bitwise its per-step run."""
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

    conf = (NeuralNetConfiguration.Builder().seed(5).updater("NESTEROVS")
            .learning_rate(0.05).graph_builder().add_inputs("in")
            .add_layer("c0", ConvolutionLayer(
                n_out=8, kernel_size=(3, 3), padding=(1, 1),
                activation="identity"), "in")
            .add_layer("bn", BatchNormalization(activation="relu"), "c0")
            .add_layer("p0", SubsamplingLayer(pooling_type="MAX"), "bn")
            .add_layer("fc", DenseLayer(n_out=32, activation="relu",
                                        dropout=0.5), "p0")
            .add_layer("out", OutputLayer(n_out=10, loss="MCXENT",
                                          dropout=0.2, drop_connect=True),
                       "fc")
            .set_outputs("out")
            .set_input_types(InputType.convolutional(16, 16, 3))
            .build())
    rng = np.random.RandomState(2)
    from deeplearning4j_tpu_torch.datasets import DataSet

    batches = [DataSet(rng.rand(16, 3, 16, 16).astype(np.float32),
                       np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)])
               for _ in range(7)]
    ref = ComputationGraph(conf, device=cuda).init()
    ref.scan_chunk = 1  # the per-step loop
    mega = ComputationGraph(conf, device=cuda).init(params=ref.params)
    ref.fit(batches)
    mega.fit(batches, megastep=3)
    assert mega.iteration_count == 7
    assert _same(ref, mega)


# -- the training runtime on the card ------------------------------------------


def _lenet_net(cuda, init=None):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import lenet

    return MultiLayerNetwork(lenet(dense_width=64), device=cuda).init(
        params=init)


def _flat_ckpt(path):
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if name.endswith(".npz"):
                import io

                with np.load(io.BytesIO(zf.read(name))) as z:
                    out.update({f"{name}:{k}": z[k] for k in z.files})
    return out


def test_async_save_taken_while_training_equals_a_sync_save(cuda, tmp_path):
    """A write-behind save's non-blocking copies into pinned staging are
    ordered before the next chunk's in-place writes (the graphed chunk
    ``copy_``s its results into the same tensors): the async checkpoint
    of step 4 equals the sync one of step 4, though training went on."""
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )

    batches = _lenet_batches(12)
    net = _lenet_net(cuda)
    net.fit(batches[:4], megastep=4)
    sync = CheckpointManager(tmp_path / "sync")
    asyn = CheckpointManager(tmp_path / "async", mode="async")
    info = sync.save(net)
    handle = asyn.save(net)
    net.fit(batches[4:])  # two more chunks write the same tensors
    got = handle.wait(60)
    assert got.step == info.step == 4 and net.iteration_count == 12
    a = _flat_ckpt(tmp_path / "sync" / info.file)
    b = _flat_ckpt(tmp_path / "async" / got.file)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    asyn.stop()


def test_prefetch_placed_batches_are_the_synchronously_placed(cuda):
    """``place_minibatch`` on the prefetch worker (its own stream, pinned
    staging, an event the consumer waits on) gives the tensors the
    same call gives on the main thread, bit for bit."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.prefetch import PrefetchIterator
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer

    batches = _lenet_batches(6)
    tr = DistributedTrainer(_lenet_net(cuda))
    pre = PrefetchIterator(ListDataSetIterator(batches), queue_depth=2,
                           placement=tr.place_minibatch)
    got = [p.wait() for p in pre]
    pre.shutdown()
    assert len(got) == len(batches)
    for placed, ds in zip(got, batches):
        ref = tr.place_minibatch(ds).wait()
        assert placed.features.is_cuda
        assert torch.equal(placed.features, ref.features)
        assert torch.equal(placed.labels, ref.labels)
        assert placed.weights == ref.weights


@pytest.mark.parametrize("megastep", [1, 4])
def test_conv_listener_snapshot_of_a_prefetched_chunk(cuda, megastep):
    """A chunk-mode ``PrefetchIterator`` places each block of 4 on its
    worker's copy stream (pinned staging, an event); the engines wait on
    the block's copies before they clone the conv listener's snapshot on
    the compute stream, so the snapshot is the last minibatch's rows and
    the listener draws its grids from them (scan and megastep paths)."""
    from deeplearning4j_tpu_torch import ui
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.api import PlacedChunk
    from deeplearning4j_tpu_torch.datasets.prefetch import PrefetchIterator
    from deeplearning4j_tpu_torch.nn import core

    batches = _lenet_batches(8, batch=256)

    def place(buf):
        (x, y), ready = core.place_tree(
            (np.stack([b.features for b in buf]),
             np.stack([b.labels for b in buf])), cuda, torch.float32)
        return PlacedChunk(x, y, ready=ready)

    net = _lenet_net(cuda)
    conv = ui.ConvolutionalIterationListener(frequency=1)
    net.set_listeners(conv)
    pre = PrefetchIterator(ListDataSetIterator(batches), queue_depth=2,
                           megastep=4, chunk_placement=place)
    try:
        net.fit(pre, megastep=megastep)
    finally:
        pre.shutdown()
    torch.cuda.synchronize()
    got = net._last_features
    assert torch.is_tensor(got) and got.is_cuda
    assert torch.equal(got.cpu(), torch.from_numpy(batches[-1].features))
    assert net.iteration_count == 8 and conv.last_grids


def test_graphed_trainer_chunk_is_the_per_step_trainer(cuda, tmp_path):
    """The trainer's megastep on an NCCL world of one: each block of 4
    is one CUDA-graph replay of the trainer's step (its fused
    all-reduce captured), bitwise the per-step trainer loop, with and
    without prefetch."""
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer,
        build_mesh,
        init_distributed,
        shutdown_distributed,
    )

    batches = _lenet_batches(8)
    init_distributed(f"file://{tmp_path}/rdv", 1, 0, device="cuda",
                     timeout_s=120)
    try:
        mesh = build_mesh()
        assert mesh.backend == "nccl"
        ref = _lenet_net(cuda)
        init = {ln: {pn: t.clone() for pn, t in lp.items()}
                for ln, lp in ref.params.items()}
        DistributedTrainer(ref, mesh=mesh).fit(batches)
        for prefetch in (None, 2):
            mega = _lenet_net(cuda, init)
            DistributedTrainer(mega, mesh=mesh).fit(
                batches, megastep=4, prefetch=prefetch)
            assert mega.iteration_count == 8
            assert len(mega._megastep_graphs) == 1
            assert _same(ref, mega)
    finally:
        shutdown_distributed()


def test_dispatch_window_waits_on_events_not_values(cuda, monkeypatch):
    """The per-step fit through the dispatch window reads nothing back:
    it waits on each step's completion event, ``max_in_flight`` steps
    late and at the epoch's end."""
    batches = _lenet_batches(6)
    net = _lenet_net(cuda)
    net.scan_chunk = 1  # the per-step loop
    net.fit(batches[:1])  # warm-up outside the spy
    waits = []
    real_sync = torch.cuda.Event.synchronize

    def counted(self):
        waits.append(1)
        return real_sync(self)

    def refuse(*a, **k):
        raise AssertionError("a host readback in the per-step loop")

    monkeypatch.setattr(torch.cuda.Event, "synchronize", counted)
    for name in ("item", "__float__", "cpu", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    net.fit(batches)
    monkeypatch.undo()
    assert len(waits) == len(batches)
    assert net.iteration_count == 1 + len(batches)


# -- the scan path on the card -------------------------------------------------


def test_graphed_scan_chunk_is_the_per_step_loop(cuda):
    """A two-epoch fit of a list takes the device-cached plan: its one
    chunk of 8 minibatches captured once (launches counted at capture:
    the warm-up step and the 8 captured ones), replayed every epoch,
    bitwise equal to the per-step loop on the card."""
    batches = _lenet_batches(8)
    ref = _lenet_net(cuda)
    ref.scan_chunk = 1
    net = _lenet_net(cuda, ref.params)
    dispatch.reset_launch_counts()
    ref.fit(batches[:1])
    one_step = dispatch.launch_counts()
    ref.fit(batches[1:])
    dispatch.reset_launch_counts()
    net.fit(batches, epochs=2)
    assert dispatch.launch_counts() == {k: 9 * v
                                        for k, v in one_step.items()}
    assert len(net._megastep_graphs) == 1 and net.iteration_count == 16
    ref.fit(batches)
    assert _same(ref, net)
    dispatch.reset_launch_counts()
    net.fit(batches, epochs=2)  # replays only
    assert sum(dispatch.launch_counts().values()) == 0
    ref.fit(batches, epochs=2)
    assert _same(ref, net)


@pytest.mark.parametrize("peephole", [True, False])
def test_graphed_fused_tbptt_chunk_is_the_per_chunk_loop(cuda, peephole):
    """The char-RNN's fused TBPTT plan on the card (3 minibatches of 4
    segments a chunk, the carry threaded through the CUDA graph and
    zeroed by the resets) against the per-chunk loop: parameters,
    RMSProp state and the carry the last minibatch ended with, bit for
    bit."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    vocab, hidden, tbptt, t, b = 12, 16, 5, 20, 4
    conf = (NeuralNetConfiguration.Builder().seed(42).learning_rate(0.1)
            .updater("RMSPROP").list()
            .layer(GravesLSTM(n_in=vocab, n_out=hidden, peephole=peephole))
            .layer(GravesLSTM(n_in=hidden, n_out=hidden, peephole=peephole))
            .layer(RnnOutputLayer(n_out=vocab, loss="MCXENT"))
            .backprop_type("TruncatedBPTT").t_bptt_forward_length(tbptt)
            .t_bptt_backward_length(tbptt).build())
    rng = np.random.RandomState(3)
    eye = np.eye(vocab, dtype=np.float32)
    data = []
    for _ in range(3):
        ids = rng.randint(0, vocab, (b, t + 1))
        data.append(DataSet(
            np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
            np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))))
    ref = MultiLayerNetwork(conf, device=cuda).init()
    ref.scan_chunk = 1
    net = MultiLayerNetwork(conf, device=cuda).init(params=ref.params)
    ref.fit(data, epochs=2)
    net.fit(data, epochs=2)
    assert len(net._megastep_graphs) == 1 and net.iteration_count == 24
    assert _same(ref, net)
    for name, carry in ref._tbptt_carry.items():
        for k, v in carry.items():
            assert torch.equal(net._tbptt_carry[name][k], v), (name, k)


def test_snapshot_ring_round_trip_of_cuda_trees(cuda):
    """``SnapshotRing`` on the card: the snapshot holds host copies (no
    storage shared with the live trees), a rollback puts fresh tensors
    back on the card in fresh dicts, never the static trees of a
    captured chunk, and the replay after it is bitwise the run that
    never rolled back."""
    from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import SnapshotRing

    batches = _lenet_batches(6)
    ref = _lenet_net(cuda)
    ref.scan_chunk = 1
    net = _lenet_net(cuda, ref.params)
    net.fit(batches[:2])  # two steps captured as a scan chunk
    ring = SnapshotRing(registry=MetricsRegistry())
    snap = ring.push(net, epoch_index=2)
    assert all(t.device.type == "cpu" for lp in snap["params"].values()
               for t in lp.values())
    static = [t.data_ptr() for g in net._megastep_graphs.values()
              for lp in g.trees[0].values() for t in lp.values()]
    net.fit(batches[2:4])
    before = net.params
    assert ring.restore_into_model(net)["step"] == net.iteration_count == 2
    assert net.params is not before
    for lp in net.params.values():
        for t in lp.values():
            assert t.device.type == "cuda" and t.data_ptr() not in static
    for ds in batches[2:]:
        net.fit(ds)
    ref.fit(batches)
    assert _same(ref, net)


def test_reform_distributed_world_of_one_on_the_card(cuda):
    """The re-formation cycle on the card: an NCCL world of one over a
    ``tcp://`` rendezvous, aborted and re-formed over a plan's fresh
    one; the new world all-reduces on the card and trains a step
    bitwise the one before the re-formation."""
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer,
        RecoveryPlan,
        init_distributed,
        reform_distributed,
        shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.parallel.control_plane import (
        _ephemeral_port,
    )

    batches = _lenet_batches(2)
    try:
        init_distributed(f"tcp://127.0.0.1:{_ephemeral_port()}", 1, 0,
                         device="cuda", timeout_s=60)
        a = _lenet_net(cuda)
        b = _lenet_net(cuda, a.params)
        DistributedTrainer(a).fit_minibatch(batches[0])
        plan = RecoveryPlan(epoch=2, term=2, members=(0,), num=1,
                            rendezvous=f"tcp://127.0.0.1:{_ephemeral_port()}",
                            member=0, rank=0)
        mesh = reform_distributed(plan, device="cuda")
        assert (mesh.data, mesh.backend) == (1, "nccl")
        x = torch.ones(3, device="cuda")
        torch.distributed.all_reduce(x)
        assert x.tolist() == [1.0, 1.0, 1.0]
        DistributedTrainer(b, mesh=mesh).fit_minibatch(batches[0])
        assert _same(a, b)
    finally:
        shutdown_distributed()


def test_transformer_default_fit_captures_and_is_the_per_step_loop(cuda):
    """The transformer LM's default fit (``scan_chunk`` 16: the
    minibatches as one CUDA-graph chunk) captures on the card (the
    positional encoding's and the attention backward's scalars are
    filled on the device, never copied from the host inside the
    capture) and is bitwise its ``scan_chunk = 1`` fit."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    conf = transformer_lm(vocab=32, d_model=64, n_layers=2, n_heads=4,
                          learning_rate=3e-4)
    rng = np.random.RandomState(5)
    eye = np.eye(32, dtype=np.float32)
    data = []
    for _ in range(3):
        ids = rng.randint(0, 32, (4, 65))
        data.append(DataSet(
            np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
            np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))))
    ref = MultiLayerNetwork(conf, device=cuda).init()
    ref.scan_chunk = 1
    net = MultiLayerNetwork(conf, device=cuda).init(params=ref.params)
    ref.fit(data)
    net.fit(data)
    assert len(net._megastep_graphs) == 1 and net.iteration_count == 3
    assert _same(ref, net)


# -- the serving tier on the card ----------------------------------------------

def _tiny_resnet(cuda, seed=42):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import resnet50

    return ComputationGraph(resnet50(height=16, width=16, channels=3,
                                     n_classes=7, depths=(1, 1),
                                     base_width=4, cifar_stem=True,
                                     seed=seed), device=cuda).init()


def _to_image(feats):
    return np.asarray(feats, np.float32).reshape(-1, 3, 16, 16)


def test_graph_tenant_bucketed_answers_are_its_solo_answers(cuda):
    """A ComputationGraph tenant on the card: requests coalesced into one
    padded bucket answer bitwise as each request alone on that bucket
    (the same kernels on the same operands; padding rows inert)."""
    import threading

    from deeplearning4j_tpu_torch.serving import ModelServer

    gate = threading.Event()
    gate.set()

    def held(feats):  # holds the drain thread while the gate is shut
        gate.wait(timeout=30)
        return _to_image(feats)

    server = ModelServer(models={"g": _tiny_resnet(cuda)}, device=cuda,
                         transform=held, bucket_ladder=[8],
                         batch_timeout_ms=2000).start()
    rng = np.random.RandomState(3)
    feats = [rng.randint(0, 256, (2, 768)).astype(np.float32)
             for _ in range(4)]
    try:
        solo = [server.submit(f, model="g")[1]["output"] for f in feats]
        results = [None] * 5
        threads = [threading.Thread(target=lambda: results.__setitem__(
            4, server.submit(feats[0][:1], model="g")))]
        gate.clear()
        threads[0].start()
        for i, f in enumerate(feats):
            while server.metrics.inflight < i + 1:
                threading.Event().wait(0.005)
            threads.append(threading.Thread(
                target=lambda i=i, f=f: results.__setitem__(
                    i, server.submit(f, model="g"))))
            threads[-1].start()
        while server.metrics.inflight < 5:
            threading.Event().wait(0.005)
        gate.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for (code, body, _), want in zip(results, solo):
            assert code == 200 and body["output"] == want
        assert server.metrics.snapshot()["batch_items"].get("4") == 1
    finally:
        gate.set()
        server.stop()


def test_page_in_before_a_forward_equals_never_evicting(cuda):
    """Paging on the card: parameters and BN state to pinned host
    tensors and back into fresh dicts, then a forward bitwise the one
    of a model never evicted."""
    from deeplearning4j_tpu_torch.serving.registry import (
        page_in_model,
        page_out_model,
    )

    kept, paged = _tiny_resnet(cuda), _tiny_resnet(cuda)
    x = np.random.RandomState(4).rand(8, 3, 16, 16).astype(np.float32)
    want = kept.output(x)[0]
    nbytes = page_out_model(paged)
    assert nbytes > 0
    assert all(t.device.type == "cpu" and t.is_pinned()
               for tree in (paged.params, paged.state)
               for d in tree.values() for t in d.values())
    assert page_in_model(paged) == nbytes
    assert all(t.device.type == "cuda"
               for tree in (paged.params, paged.state)
               for d in tree.values() for t in d.values())
    assert torch.equal(paged.output(x)[0], want)
    # a second cycle reuses the pinned copies
    host = dict(paged._paged_host)
    page_out_model(paged)
    assert all(paged._paged_host[k] is v for k, v in host.items())
    page_in_model(paged)
    assert torch.equal(paged.output(x)[0], want)


def test_library_from_a_bundle_loads_without_a_build(cuda, tmp_path):
    """The built kernel library, carried as an AOT artifact, installed
    into an empty cache directory by a fresh process: that process loads
    it (no nvcc) and launches a kernel that matches its plain version."""
    import os
    import subprocess
    import sys

    from deeplearning4j_tpu_torch.compile import aot

    art = tmp_path / "lib.aot"
    art.write_bytes(aot.export_library())
    cache = tmp_path / "cache"
    code = (
        "import sys, torch\n"
        "from deeplearning4j_tpu_torch.compile import aot\n"
        "from deeplearning4j_tpu_torch.ops import _build, conv_block, "
        "conv_block_reference\n"
        "path = aot.install_library(open(sys.argv[1], 'rb').read())\n"
        "assert path is not None and path.parent == _build.cache_dir()\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "x = torch.randn(2, 3, 8, 8, device='cuda', generator=g)\n"
        "w = torch.randn(4, 3, 3, 3, device='cuda', generator=g)\n"
        "b = torch.zeros(4, device='cuda')\n"
        "y = conv_block(x, w, b, stride=(1, 1), padding=(1, 1), "
        "activation='relu')\n"
        "r = conv_block_reference(x, w, b, stride=(1, 1), padding=(1, 1), "
        "activation='relu')\n"
        "torch.testing.assert_close(y, r, rtol=1e-4, atol=1e-4)\n"
        "assert _build.build_seconds is None\n"
        "assert _build.loaded_path == path\n"
        "print('ok')\n")
    env = dict(os.environ, DL4J_TPU_COMPILE_CACHE_DIR=str(cache),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code, str(art)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


# -- the continuous-learning loop and evaluate on the card -----------------


def _loop_net(cuda, seed=7):
    """4 -> 8 tanh -> 3 softmax, Adam (the loop tests' net)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.05)
            .updater("ADAM").list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3)).build())
    return MultiLayerNetwork(conf, device=cuda).init()


def _loop_rows(rng, rows=2, shifted=False):
    x = rng.randn(rows, 4).astype(np.float32)
    x[:, 3] = rng.randn(rows).astype(np.float32) * 8.0 if shifted else 0.0
    return x


@pytest.mark.parametrize("paged", [False, True])
def test_promote_then_rollback_on_the_card_adds_no_new_shape(cuda, tmp_path,
                                                             paged):
    """A candidate equal on today's traffic (feature 3 held at 0) but
    divergent once it moves is promoted on the card, then rolled back in
    probation: no new shape, no 5xx, and the answers after are bitwise
    the pre-promotion version's. ``paged``: the tenant was paged out to
    the host when the candidate's reload landed, so the promotion faults
    the retained snapshot back in (its probation shadow and the rollback
    then run on device weights)."""
    import threading

    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.loop import (
        ContinualTrainer,
        Promoter,
        PromotionGates,
        PromotionJournal,
    )
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
    )
    from deeplearning4j_tpu_torch.serving import ModelServer

    rng = np.random.RandomState(12345)

    def stream(n):
        out = []
        for _ in range(n):
            x = _loop_rows(rng, rows=8)
            y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 8)]
            out.append(DataSet(x, y))
        return ListDataSetIterator(out)

    mgr = CheckpointManager(tmp_path / "c", keep_last=10)
    journal = PromotionJournal(tmp_path / "j.json")
    ct = ContinualTrainer(_loop_net(cuda), mgr, publish_every=4,
                          journal=journal)
    ct.run(stream(4))
    server = ModelServer(checkpoint_manager=mgr, device=cuda, workers=2,
                         max_batch_size=4, aot=False).start()
    try:
        pr = Promoter(server, mgr, journal, gates=PromotionGates(
            min_shadow_requests=3, min_agreement=0.5, probation_requests=100,
            probation_min_agreement=0.9), seed=1337)
        probe = _loop_rows(np.random.RandomState(77), shifted=True)
        before = server.submit(probe)[1]["output"]
        bomb, info = mgr.restore_latest(load_updater=False, device=cuda)
        bomb.params["0"]["W"][3, :] = torch.where(
            torch.arange(8, device=cuda) % 2 == 0, 40.0, -40.0)
        bomb.iteration_count = info.step + 1
        mgr.save(bomb)

        def drive(n, shifted=False):
            sh = server.shadow
            base = sh.snapshot()["requests"]
            for _ in range(n):
                code, body, _ = server.submit(_loop_rows(rng,
                                                         shifted=shifted))
                assert code == 200, body
            for _ in range(4000):
                s = sh.snapshot()
                if s["requests"] >= base + n and s["shadowed"] == s[
                        "requests"]:
                    break
                threading.Event().wait(0.005)

        assert pr.poll() == "shadowing"
        drive(4)
        entry = server.model_registry.entry()
        if paged:
            with server.model_registry._lock:
                server.model_registry._evict(entry)
            assert entry.current.model.params["0"]["W"].device.type == "cpu"
        assert pr.poll() == "promoted"
        assert (pr.snapshot_pagein_ms is not None) == paged
        compiles = server.metrics.get("xla_compiles_total")
        drive(6, shifted=True)
        assert pr.poll() == "rolled_back"
        assert server.metrics.get("xla_compiles_total") == compiles
        assert server.metrics.get("post_warmup_compiles_total") == 0
        assert server.metrics.get("server_error_total") == 0
        assert journal.read()["promoted_step"] == 4
        assert server.submit(probe)[1]["output"] == before
    finally:
        server.stop(drain_timeout=1)


def test_evaluate_on_the_card_matches_the_cpu_twin(cuda, tmp_path):
    """Both engines' ``evaluate`` on the card against their CPU twins on
    the same minibatches: the same confusion matrix on rows whose top-2
    margin clears f32 noise."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
        write_model,
    )
    from deeplearning4j_tpu_torch.zoo import lenet

    def cpu_twin(model):
        path = str(tmp_path / f"{id(model)}.zip")
        write_model(model, path)
        return restore_model(path, device="cpu")

    rng = np.random.RandomState(5)
    net = MultiLayerNetwork(lenet(), device=cuda).init()
    twin = cpu_twin(net)
    x = rng.rand(256, 784).astype(np.float32)
    out = np.sort(twin.output(x).numpy(), axis=1)
    x = x[(out[:, -1] - out[:, -2]) > 1e-4][:192]
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, len(x))]
    parts = [DataSet(x[i:i + 64], y[i:i + 64]) for i in range(0, len(x), 64)]
    got, want = net.evaluate(parts), twin.evaluate(parts)
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)
    assert got.stats() == want.stats()
    graph = _tiny_resnet(cuda)
    gtwin = cpu_twin(graph)
    img = rng.rand(64, 3, 16, 16).astype(np.float32)
    out = np.sort(gtwin.output(img)[0].numpy(), axis=1)
    img = img[(out[:, -1] - out[:, -2]) > 1e-4]
    lab = np.eye(7, dtype=np.float32)[rng.randint(0, 7, len(img))]
    got = graph.evaluate([DataSet(img, lab)])
    want = gtwin.evaluate([DataSet(img, lab)])
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)


# -- Word2Vec's device epochs as CUDA-graph replays ------------------------


def _w2v_on_card(epochs=2, vocab=300, seed=4):
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    sents = [[f"w{i}" for i in rng.choice(vocab, 20, p=p / p.sum())]
             for _ in range(400)]
    cache = VocabConstructor(1).build_vocab_from_tokens(sents)
    ids = [np.asarray([cache.index_of(w) for w in s], np.int32)
           for s in sents]
    m = Word2Vec(cache, ids, layer_size=32, window=3, negative=4,
                 batch_size=512, epochs=epochs, seed=7, device="cuda")
    return m


def test_word2vec_graph_route_is_the_eager_route_bitwise(cuda):
    """Two epochs replayed from the captured epoch give the eager
    route's tables and losses bit for bit (same generator, same
    tables); the capture was timed."""
    g, e = _w2v_on_card(), _w2v_on_card()
    lg, le = g._fit_device_gen(), e._fit_device_gen(eager=True)
    assert torch.equal(lg, le)
    for a, b in zip(g.lookup.to_numpy(), e.lookup.to_numpy()):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert g._dev_graph.graph is not None and g._dev_graph.capture_s > 0
    assert e._dev_graph is None


def test_word2vec_graph_second_fit_continues_the_schedule(cuda):
    """A second fit replays the same graph with fresh draws and the
    continued alphas: bitwise the eager route's second fit."""
    g, e = _w2v_on_card(epochs=1), _w2v_on_card(epochs=1)
    for _ in range(2):
        g.fit()
        e._fit_device_gen(eager=True)
    first = g._dev_graph
    assert g._dev_steps_done == e._dev_steps_done
    assert g._dev_fit_no == 2 and first is g._dev_graph
    assert torch.equal(g.lookup.syn0, e.lookup.syn0)
    assert torch.equal(g.lookup.syn1neg, e.lookup.syn1neg)


def test_word2vec_rebound_table_is_never_written_by_a_stale_graph(cuda):
    """After ``load_numpy`` rebinds the tables, a fit captures a new
    graph on the new tensors; the old ones keep their bits."""
    m = _w2v_on_card(epochs=1)
    m.fit()
    old = (m.lookup.syn0, m.lookup.syn1neg)
    kept = [t.clone() for t in old]
    syn0, _, syn1neg = m.lookup.to_numpy()
    m.lookup.load_numpy(syn0, None, syn1neg)
    m.fit()
    assert all(torch.equal(a, b) for a, b in zip(old, kept))
    assert m._dev_graph.bound_to(m.lookup.syn0, m.lookup.syn1neg)
    assert not torch.equal(m.lookup.syn0, kept[0])


# -- the MoE transformer, GoogLeNet, graph TBPTT and the conv -> LSTM net ------

def _moe_lm(cuda, **kw):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    conf = transformer_lm(vocab=32, d_model=64, n_layers=2, n_heads=4,
                          learning_rate=3e-4, n_experts=4, **kw)
    return conf, MultiLayerNetwork(conf, device=cuda).init()


def _byte_batches(n, b=4, t=64, vocab=32, seed=5):
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.RandomState(seed)
    eye = np.eye(vocab, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (b, t + 1))
        out.append(DataSet(
            np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
            np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1))))
    return out


def test_moe_slot_dispatch_is_the_dense_plain_version_on_the_card(cuda):
    """The slot-index dispatch against the dense one-hot ``einsum``s on
    the same operands on the card: one nonzero term a sum, bitwise;
    with a token mask and drops (capacity factor 1)."""
    from deeplearning4j_tpu_torch.parallel import expert

    gen = torch.Generator().manual_seed(3)
    p = {k: v.to(cuda) for k, v in expert.init_moe_params(
        gen, 64, 256, 4).items()}
    x = torch.randn((512, 64), generator=gen).to(cuda)
    mask = (torch.rand(512, generator=gen) > 0.2).float().to(cuda)
    for m in (None, mask):
        fast = expert.moe_ffn(p, x, 1.0, m)
        assert torch.equal(fast, expert.moe_ffn_reference(p, x, 1.0, m))
        cpu = expert.moe_ffn({k: v.cpu() for k, v in p.items()}, x.cpu(),
                             1.0, None if m is None else m.cpu())
        torch.testing.assert_close(fast.cpu(), cpu, rtol=1e-4, atol=1e-5)


def test_moe_transformer_default_fit_captures_and_is_the_per_step_loop(cuda):
    """The MoE LM's default fit: the routing (argmax, the position
    cumsum, the slot scatter and gather) holds static shapes, so the
    minibatches capture as one CUDA-graph chunk, bitwise the
    ``scan_chunk = 1`` fit."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf, ref = _moe_lm(cuda)
    ref.scan_chunk = 1
    net = MultiLayerNetwork(conf, device=cuda).init(params=ref.params)
    data = _byte_batches(3)
    ref.fit(data)
    net.fit(data)
    assert len(net._megastep_graphs) == 1 and net.iteration_count == 3
    assert _same(ref, net)


def test_moe_transformer_launches_and_sampling_on_the_card(cuda):
    """A step launches flash attention a block and the dense kernel once
    (the MoE replaces the residual FFN product); ``rnn_time_step``
    streams the prompt and one byte at a time through the KV cache."""
    conf, net = _moe_lm(cuda)
    net.scan_chunk = 1
    ds = _byte_batches(1)[0]
    dispatch.reset_launch_counts()
    net.fit(ds)
    counts = dispatch.launch_counts()
    assert counts["flash_attention"] == 2 and counts["matmul_block"] == 1
    assert counts["matmul_block_residual"] == 0
    net.rnn_clear_previous_state()
    out = net.rnn_time_step(ds.features[:1, :, :8])
    step = net.rnn_time_step(ds.features[:1, :, 8])
    assert out.shape == (1, 32, 8) and step.shape == (1, 32)
    assert bool(torch.isfinite(step).all())


def test_expert_parallel_world_of_one_over_nccl_is_the_single_device(
        cuda, tmp_path):
    from deeplearning4j_tpu_torch.parallel import (
        init_distributed,
        shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.parallel import expert

    gen = torch.Generator().manual_seed(4)
    p = {k: v.to(cuda) for k, v in expert.init_moe_params(
        gen, 64, 256, 4).items()}
    x = torch.randn((256, 64), generator=gen).to(cuda)
    init_distributed(f"file://{tmp_path}/rdv", 1, 0, device="cuda",
                     timeout_s=60)
    try:
        mesh = expert.build_expert_mesh()
        assert mesh.backend == "nccl"
        ep = expert.ExpertParallelMoE(mesh, n_experts=4)
        assert torch.equal(ep.apply(ep.shard_params(p), x),
                           expert.moe_ffn(p, x, 1.25))
    finally:
        shutdown_distributed()


def test_googlenet_step_on_the_card_matches_the_cpu_twin(cuda):
    """A 64 x 64 GoogLeNet step on the card (57 convs: 114 forward
    launches with the recompute, 56 dx, 57 dW) against the plain path."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import googlenet

    conf = googlenet(height=64, width=64, n_classes=10)
    net = ComputationGraph(conf, device=cuda).init()
    net.scan_chunk = 1
    twin = ComputationGraph(conf, device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in net.params.items()})
    rng = np.random.RandomState(0)
    ds = DataSet(rng.rand(2, 3, 64, 64).astype(np.float32),
                 np.eye(10, dtype=np.float32)[rng.randint(0, 10, 2)])
    dispatch.reset_launch_counts()
    net.fit(ds)
    twin.fit(ds)
    counts = dispatch.launch_counts()
    assert (counts["conv_block"], counts["conv_bwd_data"],
            counts["conv_bwd_w"]) == (114, 56, 57)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            torch.testing.assert_close(net.params[ln][pn].cpu(), ref,
                                       rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("peephole", [True, False])
def test_graph_tbptt_and_rnn_time_step_are_the_multilayer_ones(cuda,
                                                               peephole):
    """The char-RNN as a ComputationGraph on the card, truncated BPTT and
    streaming, against the ``MultiLayerNetwork`` char-RNN on the same
    weights and data (the same kernels: bitwise)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def lstm(n_in):
        return GravesLSTM(n_in=n_in, n_out=24, activation="tanh",
                          peephole=peephole)

    base = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
            .updater("RMSPROP"))
    gconf = (base.graph_builder().add_inputs("in")
             .add_layer("l0", lstm(11), "in").add_layer("l1", lstm(24), "l0")
             .add_layer("out", RnnOutputLayer(n_in=24, n_out=11), "l1")
             .set_outputs("out").backprop_type("TruncatedBPTT")
             .t_bptt_forward_length(8).t_bptt_backward_length(8).build())
    lconf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
             .updater("RMSPROP").list().layer(lstm(11)).layer(lstm(24))
             .layer(RnnOutputLayer(n_out=11)).backprop_type("TruncatedBPTT")
             .t_bptt_forward_length(8).t_bptt_backward_length(8).build())
    g = ComputationGraph(gconf, device=cuda).init()
    net = MultiLayerNetwork(lconf, device=cuda).init(params={
        str(i): {k: t.clone() for k, t in g.params[n].items()}
        for i, n in enumerate(("l0", "l1", "out"))})
    g.scan_chunk = net.scan_chunk = 1
    rng = np.random.RandomState(2)
    eye = np.eye(11, dtype=np.float32)
    ids = rng.randint(0, 11, (4, 33))
    ds = DataSet(np.ascontiguousarray(eye[ids[:, :-1]].transpose(0, 2, 1)),
                 np.ascontiguousarray(eye[ids[:, 1:]].transpose(0, 2, 1)))
    g.fit(ds)
    net.fit(ds)
    assert g.iteration_count == net.iteration_count == 4
    for i, n in enumerate(("l0", "l1", "out")):
        for k, t in g.params[n].items():
            assert torch.equal(t, net.params[str(i)][k]), (n, k)
    for t in range(3):
        assert torch.equal(g.rnn_time_step(ds.features[:, :, t])[0],
                           net.rnn_time_step(ds.features[:, :, t]))


def test_conv_lstm_step_on_the_card_matches_the_cpu_twin(cuda):
    """Frames -> RnnToCnn -> two conv stages -> CnnToRnn -> GravesLSTM
    -> RnnToFeedForward -> softmax: one step's launches and scores
    against the plain path."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
        RnnToCnnPreProcessor,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer,
        GravesLSTM,
        OutputLayer,
        SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.01)
            .updater("ADAM").list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="MAX"))
            .layer(GravesLSTM(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=4))
            .input_pre_processor(0, RnnToCnnPreProcessor(10, 10, 1))
            .set_input_type(InputType.recurrent(100, 5)).build())
    net = MultiLayerNetwork(conf, device=cuda).init()
    net.scan_chunk = 1
    twin = MultiLayerNetwork(conf, device="cpu").init(params={
        ln: {pn: t.cpu() for pn, t in lp.items()}
        for ln, lp in net.params.items()})
    rng = np.random.RandomState(4)
    ds = DataSet(rng.rand(3, 100, 5).astype(np.float32),
                 np.eye(4, dtype=np.float32)[rng.randint(0, 4, 15)])
    dispatch.reset_launch_counts()
    net.fit(ds)
    twin.fit(ds)
    counts = dispatch.launch_counts()
    assert (counts["conv_block"], counts["conv_bwd_w"],
            counts["lstm_cell"]) == (2, 1, 5)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    assert net.output(ds.features).shape == (15, 4)


# -- tensor parallelism, the ring and GPipe on the card -------------------

# Two gloo ranks on one card (NCCL refuses two ranks a device): a narrow
# LeNet under tensor parallelism (model=2) against one process on the
# card, ring attention (seq 2) against the plain attention, and a
# two-stage GPipe of dense-kernel stages against their serial
# composition. Rank 0 computes the references.
_CARD_WORLD = r"""
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dispatch, matmul_block
from deeplearning4j_tpu_torch.parallel import (
    DistributedTrainer, GPipe, attention, build_mesh, build_pipe_mesh,
    build_seq_mesh, ring_attention)
from deeplearning4j_tpu_torch.zoo import lenet

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
rng = np.random.RandomState(0)
x = torch.from_numpy(rng.rand(16, 256).astype(np.float32)).cuda()
y = torch.from_numpy(np.eye(4, dtype=np.float32)[rng.randint(0, 4, 16)]).cuda()
conf = lenet(height=16, width=16, n_classes=4, dense_width=64,
             updater="SGD", learning_rate=0.1)
if RANK == 0:
    one = MultiLayerNetwork(conf, device="cuda").init()
    for _ in range(3):
        one.fit_minibatch(DataSet(x, y))
    for ln, lp in one.params.items():
        for pn, t in lp.items():
            OUT[f"one:{ln}/{pn}"] = t.cpu().numpy()
net = MultiLayerNetwork(conf, device="cuda").init()
tr = DistributedTrainer(net, mesh=build_mesh(data=1, model=2),
                        tensor_parallel=True)
dispatch.reset_launch_counts()
OUT["tp_scores"] = np.asarray([float(tr.fit_minibatch(DataSet(x, y)))
                               for _ in range(3)])
OUT["tp_launches"] = np.asarray(json.dumps(dispatch.launch_counts()))
for ln, lp in core.canonical_trees(net)[0].items():
    for pn, t in lp.items():
        OUT[f"tp:{ln}/{pn}"] = t.cpu().numpy()
# the ring: q, k, v [1, 2, 64, 16], each rank its 32 positions
q, k, v = (torch.from_numpy(rng.randn(1, 2, 64, 16).astype(np.float32))
           .cuda() for _ in range(3))
build_seq_mesh(data=1, seq=2)
rows = slice(RANK * 32, (RANK + 1) * 32)
mine = [t[:, :, rows].clone().requires_grad_() for t in (q, k, v)]
out = ring_attention(*mine, axis_name="seq", axis_size=2, causal=True)
(out ** 2).sum().backward()
OUT["ring"] = out.detach().cpu().numpy()
for name, t in zip("qkv", mine):
    OUT["ring_d" + name] = t.grad.cpu().numpy()
if RANK == 0:
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = attention(*full, causal=True)
    (ref ** 2).sum().backward()
    OUT["ring_ref"] = ref.detach().cpu().numpy()
    for name, t in zip("qkv", full):
        OUT["ring_ref_d" + name] = t.grad.cpu().numpy()
# GPipe: two dense-kernel stages (relu), batch 32 in 4 microbatches
w = torch.from_numpy((rng.randn(2, 64, 64) / 8).astype(np.float32))
b = torch.from_numpy((0.1 * rng.randn(2, 64)).astype(np.float32))
gx = torch.from_numpy(rng.randn(32, 64).astype(np.float32)).cuda()


def stage(p, h):
    return matmul_block(h, p["w"], p["b"], activation="relu")


pipe = GPipe(build_pipe_mesh(2), stage, n_micro=4)
dispatch.reset_launch_counts()
OUT["pipe"] = pipe.apply(pipe.shard_params({"w": w, "b": b},
                                           device="cuda"), gx).cpu().numpy()
OUT["pipe_launches"] = np.asarray(dispatch.launch_counts()["matmul_block"])
if RANK == 0:
    h = gx
    for s in range(2):
        h = stage({"w": w[s].cuda(), "b": b[s].cuda()}, h)
    OUT["pipe_ref"] = h.cpu().numpy()
save()
shutdown_distributed()
"""


@pytest.fixture(scope="module")
def card_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_world import RankWorld

    world = RankWorld.start(tmp_path_factory.mktemp("card_world"), 2,
                            _CARD_WORLD, {"device": "cuda",
                                          "backend": "gloo"})
    try:
        return world.wait()
    finally:
        world.kill()


def test_tensor_parallel_lenet_on_the_card(card_world):
    """The shard kernels' SGD steps against one process's: the same
    weights to f32 rounding of sums in another order (each conv at
    half its out-channels, each dense layer at half its columns, the
    head's product on the kernel with the identity epilogue)."""
    a, b = card_world
    np.testing.assert_array_equal(a["tp_scores"], b["tp_scores"])
    for key in [k for k in a if k.startswith("one:")]:
        np.testing.assert_allclose(a["tp:" + key[4:]], a[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    launches = json.loads(str(a["tp_launches"]))
    assert launches["conv_block"] == 3 * 4 and launches["matmul_block"] == 6


def test_ring_attention_on_the_card(card_world):
    a, b = card_world
    got = np.concatenate([a["ring"], b["ring"]], axis=2)
    np.testing.assert_allclose(got, a["ring_ref"], rtol=1e-4, atol=1e-5)
    for name in "qkv":
        np.testing.assert_allclose(
            np.concatenate([a["ring_d" + name], b["ring_d" + name]], axis=2),
            a["ring_ref_d" + name], rtol=1e-4, atol=1e-5, err_msg=name)


def test_gpipe_on_the_card(card_world):
    """Every rank gets the serial composition's output; each stage
    launches the dense kernel once a tick (4 microbatches + 1)."""
    a, b = card_world
    for r in (a, b):
        np.testing.assert_allclose(r["pipe"], a["pipe_ref"], rtol=1e-5,
                                   atol=1e-6)
        assert int(r["pipe_launches"]) == 5


@pytest.mark.parametrize("algo", ["LBFGS", "CONJUGATE_GRADIENT",
                                  "LINE_GRADIENT_DESCENT"])
def test_lenet_solver_step_launches_on_the_card(cuda, algo):
    """[lenet-lbfgs]'s solver on LeNet-5: each ``fit_minibatch`` launches
    exactly ``chip_smoke.solver_step_launches`` of its line-search
    trials (the gradient through the four kernels, a forward a trial),
    and two steps hold the CPU twin: the scores and parameters to rtol
    2e-4 / atol 2e-5, the same accepted alpha. A first trial step of 1
    makes the line search backtrack."""
    import chip_smoke
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import lenet

    conf = MultiLayerConfiguration.from_dict(dict(
        lenet(dense_width=64, learning_rate=1.0).to_dict(),
        optimization_algo=algo))
    init = chip_smoke.host_params(MultiLayerNetwork(conf,
                                                    device="cpu").init())
    net = MultiLayerNetwork(conf, device=cuda).init(params=init)
    twin = MultiLayerNetwork(conf, device="cpu").init(params=init)
    backtracked = 0
    for i, ds in enumerate(_lenet_batches(2, batch=64)):
        dispatch.reset_launch_counts()
        got = float(net.fit_minibatch(ds))
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        ref = float(twin.fit_minibatch(ds))
        trials = [s["trials"] for s in net._solver.last_steps]
        backtracked += sum(trials)
        want = chip_smoke.solver_step_launches(algo, trials, i == 0)
        assert {k: v for k, v in counts.items() if v} == want
        assert [float(s["alpha"]) for s in net._solver.last_steps] == [
            float(s["alpha"]) for s in twin._solver.last_steps]
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert backtracked > 0
    chip_smoke.hold_params("solver", net, twin, 2e-4, 2e-5)


def test_f64_gradient_check_refuses_the_kernels(cuda):
    """``check_gradients(device="cuda")`` builds its f64 copy on the card
    and the first kernel it reaches refuses f64; it does not move to the
    CPU on its own."""
    from deeplearning4j_tpu_torch.nn.gradient_check import check_gradients
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import lenet

    net = MultiLayerNetwork(lenet(dense_width=16), device=cuda).init()
    ds = _lenet_batches(1, batch=2)[0]
    with pytest.raises((TypeError, NotImplementedError), match="float64"):
        check_gradients(net, ds.features, ds.labels, device="cuda",
                        max_per_param=2)
    assert torch.get_default_dtype() == torch.float32


# --- the kernel tuner's plans (ops/tiling.py, ops/autotune.py) ---------------
# Every candidate plan of each tuned family, forced by replacing
# autotune.resolve, against the plain version at 2-3 shapes each: LeNet's
# conv2 at its bucket, AlexNet's conv2 at batch 16, a VGG 3 x 3 at 28 x
# 28; dense at the transformer's skinny and the embedding MLP's shapes
# and a deep skinny fc; the char-RNN's cell and sequence shapes.

TUNED_CONV = [((32, 20, 12, 12), (50, 20, 5, 5), (1, 1), (0, 0)),
              ((16, 96, 27, 27), (256, 96, 5, 5), (1, 1), (2, 2)),
              ((8, 64, 28, 28), (128, 64, 3, 3), (1, 1), (1, 1))]
TUNED_DENSE = [(16, 768, 768), (1024, 128, 256), (16, 6272, 512),
               (1, 4096, 1000), (7, 1001, 770)]
TUNED_CELL = [(32, 200), (1, 200), (8, 48)]
TUNED_SEQ = [(6, 32, 200), (4, 3, 40)]


def _forced(monkeypatch, plan):
    at = importlib.import_module("deeplearning4j_tpu_torch.ops.autotune")
    monkeypatch.setattr(at, "resolve", lambda *a, **k: plan)


@pytest.mark.parametrize("xs,ws,stride,padding", TUNED_CONV)
def test_every_conv_candidate_matches_the_plain_version(cuda, monkeypatch,
                                                        xs, ws, stride,
                                                        padding):
    tiling = importlib.import_module("deeplearning4j_tpu_torch.ops.tiling")
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(xs, device=cuda, generator=gen)
    w = torch.randn(ws, device=cuda, generator=gen) / (ws[1] * 9) ** 0.5
    b = 0.1 * torch.randn(ws[0], device=cuda, generator=gen)
    args = (*xs, ws[0], ws[2], ws[3], stride, padding)
    ref = conv_block_reference(x, w, b, stride=stride, padding=padding,
                               activation="relu")
    oh, ow = ref.shape[2:]
    dacc = torch.randn((xs[0], ws[0], oh, ow), device=cuda, generator=gen)
    ref_dx = conv_bwd_data_reference(dacc, w, xs[2:], stride, padding)
    ref_dw = conv_bwd_w_reference(x, dacc, ws, stride, padding)
    tried = 0
    for plan in tiling.conv_fwd_candidates(*args):
        _forced(monkeypatch, plan)
        got = conv_block(x, w, b, stride=stride, padding=padding,
                         activation="relu")
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{plan}: {m}")
        tried += 1
    for plan in tiling.conv_bwd_data_candidates(*args):
        _forced(monkeypatch, plan)
        got = conv_bwd_data(dacc, w, xs[2:], stride, padding)
        torch.testing.assert_close(got, ref_dx, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{plan}: {m}")
        tried += 1
    scale = float(ref_dw.abs().max())
    for plan in tiling.conv_bwd_w_candidates(*args):
        _forced(monkeypatch, plan)
        got = conv_bwd_w(x, dacc, ws, stride, padding)
        torch.testing.assert_close(got, ref_dw, rtol=0, atol=5e-5 * scale,
                                   msg=lambda m: f"{plan}: {m}")
        tried += 1
    assert tried >= 8


@pytest.mark.parametrize("m,k,n", TUNED_DENSE)
def test_every_dense_candidate_matches_the_plain_version(cuda, monkeypatch,
                                                         m, k, n):
    tiling = importlib.import_module("deeplearning4j_tpu_torch.ops.tiling")
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(m, k, device=cuda, generator=gen)
    w = torch.randn(k, n, device=cuda, generator=gen) / k ** 0.5
    b = 0.1 * torch.randn(n, device=cuda, generator=gen)
    r = torch.randn(m, n, device=cuda, generator=gen)
    ref = matmul_block_reference(x, w, b, activation="relu")
    ref_r = matmul_block_reference(x, w, b, r, activation="relu")
    for plan in tiling.matmul_candidates(m, k, n):
        _forced(monkeypatch, plan)
        torch.testing.assert_close(matmul_block(x, w, b, activation="relu"),
                                   ref, rtol=1e-4, atol=1e-4,
                                   msg=lambda s: f"{plan}: {s}")
        torch.testing.assert_close(
            matmul_block(x, w, b, r, activation="relu"), ref_r, rtol=1e-4,
            atol=1e-4, msg=lambda s: f"{plan} residual: {s}")


@pytest.mark.parametrize("b,n", TUNED_CELL)
def test_every_lstm_cell_candidate_matches_the_plain_version(cuda,
                                                             monkeypatch,
                                                             b, n):
    lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    tiling = importlib.import_module("deeplearning4j_tpu_torch.ops.tiling")
    gen = torch.Generator(device=cuda).manual_seed(5)
    xp = torch.randn(b, 4 * n, device=cuda, generator=gen)
    h = torch.randn(b, n, device=cuda, generator=gen)
    c = torch.randn(b, n, device=cuda, generator=gen)
    rw = torch.randn(n, 4 * n, device=cuda, generator=gen) / n ** 0.5
    peeps = tuple(0.1 * torch.randn(n, device=cuda, generator=gen)
                  for _ in range(3))
    want = lc.lstm_cell_reference(xp, h, c, rw, peeps)
    for plan in tiling.lstm_cell_candidates(b, n):
        _forced(monkeypatch, plan)
        got = lc.lstm_cell(xp, h, c, rw, peeps)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5,
                                       msg=lambda s: f"{plan}: {s}")


@pytest.mark.parametrize("T,b,n", TUNED_SEQ)
def test_every_lstm_sequence_candidate_matches_the_plain_version(
        cuda, monkeypatch, T, b, n):
    lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")
    tiling = importlib.import_module("deeplearning4j_tpu_torch.ops.tiling")
    gen = torch.Generator(device=cuda).manual_seed(6)
    xp = torch.randn(T, b, 4 * n, device=cuda, generator=gen)
    h0 = torch.randn(b, n, device=cuda, generator=gen)
    c0 = torch.randn(b, n, device=cuda, generator=gen)
    rw = torch.randn(n, 4 * n, device=cuda, generator=gen) / n ** 0.5
    want = lc.lstm_seq_fwd_reference(xp, h0, c0, rw)
    hseq, cseq = want[0], want[1]
    hprev = torch.cat([h0[None], hseq[:-1]]).contiguous()
    cprev = torch.cat([c0[None], cseq[:-1]]).contiguous()
    dh = torch.randn(T, b, n, device=cuda, generator=gen)
    dhT = torch.randn(b, n, device=cuda, generator=gen)
    dcT = torch.randn(b, n, device=cuda, generator=gen)
    want_b = lc.lstm_seq_bwd_reference(xp, hprev, cprev, cseq, rw, dh, dhT,
                                       dcT)
    for bwd in (False, True):
        for plan in tiling.lstm_seq_candidates(T, b, n, bwd):
            _forced(monkeypatch, plan)
            got = (lc.lstm_seq_bwd(xp, hprev, cprev, cseq, rw, dh, dhT, dcT)
                   if bwd else lc.lstm_seq_fwd(xp, h0, c0, rw))
            for g, r in zip(got, want_b if bwd else want):
                torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4,
                                           msg=lambda s: f"{plan}: {s}")


def test_python_split_rule_is_the_librarys(cuda):
    """The split counts ops/tiling.py computes are the C library's
    former rule, as its query entry points still report it, over a grid
    of shapes from one tile to well past two waves."""
    from deeplearning4j_tpu_torch.ops import _build

    tiling = importlib.import_module("deeplearning4j_tpu_torch.ops.tiling")
    lib = _build.load()
    n_checked = 0
    for n in (1, 2, 16, 128):
        for c in (1, 3, 20, 96, 512):
            for o in (1, 10, 64, 256):
                for k in (1, 3, 5):
                    for hw in (1, 4, 13, 28, 56):
                        assert tiling.direct_splits(n, c, o, k, k, hw, hw) \
                            == lib.dl4j_conv_block_splits(n, c, o, k, k, hw,
                                                          hw)
                        assert tiling.data_splits(n, c, hw, hw, o, k, k) \
                            == lib.dl4j_conv_bwd_data_splits(n, c, hw, hw, o,
                                                             k, k)
                        assert tiling.weight_splits(n, c, o, k, k, hw, hw) \
                            == lib.dl4j_conv_bwd_w_splits(n, c, o, k, k, hw,
                                                          hw)
                        n_checked += 3
    for m in (1, 16, 64, 1024):
        for k in (1, 100, 768, 4096, 25088):
            for n in (1, 10, 256, 4096):
                assert tiling.matmul_splits(m, k, n) == \
                    lib.dl4j_matmul_block_splits(m, k, n)
                n_checked += 1
    assert n_checked > 3000


def test_register_budget_is_the_built_kernels(cuda):
    """BWD_W_REGISTERS (ops/tiling.py) is what the image-resident dW
    kernel was built to: cudaFuncGetAttributes' registers a thread stay
    within it (two blocks of 384 threads an SM) in every kernel size and
    dtype, and a block takes the 384 threads."""
    import ctypes

    from deeplearning4j_tpu_torch.ops import _build

    tiling = importlib.import_module("deeplearning4j_tpu_torch.ops.tiling")
    cb = importlib.import_module("deeplearning4j_tpu_torch.ops.conv_block")
    lib = _build.load()
    for dtype, code in _build.DTYPE_CODES.items():
        for k in range(1, cb.BWD_W_MAX_K + 1):
            regs, threads = ctypes.c_int(0), ctypes.c_int(0)
            assert lib.dl4j_conv_bwd_w_resident_attrs(
                k, code, ctypes.byref(regs), ctypes.byref(threads)) == 0
            assert 0 < regs.value <= tiling.BWD_W_REGISTERS, (dtype, k)
            assert 2 * cb.BWD_W_MAX_THREADS * regs.value \
                <= tiling.SM_REGISTERS
            assert threads.value >= cb.BWD_W_MAX_THREADS


def test_tuner_measures_persists_and_refuses_a_capture_on_the_card(
        cuda, monkeypatch, tmp_path):
    """DL4J_TPU_TUNE=on measures a conv's candidates on the card with
    CUDA events and persists the winner, which a fresh memo in cached
    mode uses without measuring; a miss inside a CUDA-graph capture
    raises, naming the kernel."""
    at = importlib.import_module("deeplearning4j_tpu_torch.ops.autotune")
    monkeypatch.setenv("DL4J_TPU_TUNE", "on")
    monkeypatch.setenv("DL4J_TPU_TUNE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("DL4J_TPU_TUNE_BUDGET_MS", "200")
    dispatch.reset_for_tests()
    try:
        x = torch.randn(8, 64, 28, 28, device=cuda)
        w = torch.randn(128, 64, 3, 3, device=cuda) / 24.0
        ref = conv_block_reference(x, w, padding=(1, 1))
        got = conv_block(x, w, padding=(1, 1))
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        ident = {"n": 8, "c": 64, "h": 28, "w": 28, "o": 128, "kh": 3,
                 "kw": 3, "sh": 1, "sw": 1, "ph": 1, "pw": 1, "dtype": "f32"}
        entry = at.read_entry("conv_block", ident)
        assert entry is not None and entry["measured"] >= 2
        assert entry["best_ms"] <= entry["timings_ms"][
            "{}:{}".format(entry["heuristic"][0],
                           "x".join(str(v) for v in entry["heuristic"][1:]))]
        monkeypatch.setenv("DL4J_TPU_TUNE", "cached")
        dispatch.reset_for_tests()
        got = conv_block(x, w, padding=(1, 1))
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        assert at.resolved()[("conv_block", tuple(ident.items()))] == \
            tuple(entry["config"])
        monkeypatch.setenv("DL4J_TPU_TUNE", "on")
        dispatch.reset_for_tests()
        x2 = torch.randn(8, 64, 14, 14, device=cuda)
        g = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="conv_block.*capture"):
            with torch.cuda.graph(g):
                conv_block(x2, w, padding=(1, 1))
    finally:
        monkeypatch.delenv("DL4J_TPU_TUNE_CACHE_DIR")
        monkeypatch.delenv("DL4J_TPU_TUNE")
        dispatch.reset_for_tests()


def test_tree_summaries_read_cuda_tensors_as_their_host_copies(cuda):
    """``mean_magnitudes`` / ``array_histograms`` of a tree of CUDA
    tensors (one read back a tensor, one wait) equal those of its host
    copy exactly, and ``host_arrays(fresh=True)`` does not see a later
    in-place write on the card."""
    from deeplearning4j_tpu_torch.observability import metrics

    gen = torch.Generator(device="cuda").manual_seed(3)
    tree = {"0": {"W": torch.randn(300, 70, device=cuda, generator=gen),
                  "b": torch.randn(70, device=cuda, generator=gen)},
            "1": {"W": torch.randn(9, 9, device=cuda,
                                   generator=gen).requires_grad_()}}
    host = {ln: {pn: t.detach().cpu() for pn, t in lp.items()}
            for ln, lp in tree.items()}
    assert metrics.mean_magnitudes(tree) == metrics.mean_magnitudes(host)
    assert (json.dumps(metrics.array_histograms(tree))
            == json.dumps(metrics.array_histograms(host)))
    fresh = metrics.host_arrays(tree, fresh=True)
    with torch.no_grad():
        tree["0"]["W"].add_(1.0)
    np.testing.assert_array_equal(fresh["0"]["W"], host["0"]["W"].numpy())

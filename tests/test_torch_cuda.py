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
    matmul_block,
    matmul_block_reference,
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


# (x shape, w shape, stride, padding): LeNet's two convs at bucket 32
# (the second splits its k axis), AlexNet's five at batch 4, odd
# geometry, and a split-K case whose last k chunk is ragged
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
]


@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
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
                (1, 7, 3), (70, 33, 129), (5, 1000, 65)]


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
                              "conv_bwd_w": 1, "matmul_block": 0}
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
    x = torch.randn(2, 3, 8, 8, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(4, 3, 3, 3, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(NotImplementedError, match="mixed-precision"):
        conv_block(x, w, activation="relu")
    with pytest.raises(NotImplementedError, match="mixed-precision"):
        matmul_block(x.reshape(2, -1), torch.randn(
            192, 3, device=cuda, dtype=torch.bfloat16, requires_grad=True))


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
        "matmul_block": 1}
    twin.fit(ds)
    np.testing.assert_allclose(net.score_value, twin.score_value, rtol=1e-4)
    lr = 0.01
    for ln, lp in twin.params.items():
        for pn, ref in lp.items():
            got = net.params[ln][pn].cpu()
            torch.testing.assert_close(got, ref, rtol=0, atol=lr / 50)
            off = (got - ref).abs() > 1e-5 + 1e-4 * ref.abs()
            assert float(off.float().mean()) <= 0.01, (ln, pn)

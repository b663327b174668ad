"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``--noconftest``: ``tests/conftest.py`` imports
JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: f32 kernels sum in another order than cuDNN / cuBLAS (both
run in full f32 here: TF32 is switched off), so agreement is to f32
rounding of sums up to 9216 terms (rtol/atol 1e-4 on O(1) outputs);
bf16 inputs round once on the store, so bf16 eps (2e-2).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import (
    SUPPORTED_EPILOGUES,
    conv_block,
    conv_block_reference,
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
    x = torch.randn(4, 8, device=cuda, requires_grad=True)
    w = torch.randn(8, 3, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        matmul_block(x, w)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_block(torch.randn(8, 4, device=cuda).t(), w)
    with pytest.raises(TypeError):
        matmul_block(torch.randn(4, 8, device=cuda, dtype=torch.float64),
                     w.double())
    with pytest.raises(ValueError, match="channels"):
        conv_block(torch.randn(1, 3, 8, 8, device=cuda),
                   torch.randn(4, 2, 3, 3, device=cuda))

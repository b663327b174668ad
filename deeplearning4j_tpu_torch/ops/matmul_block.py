"""Fused dense epilogue: ``activation(x @ w + b)`` as one hand-written
CUDA kernel (``csrc/matmul_block.cu``).

Counterpart of ``deeplearning4j_tpu/ops/matmul_block.py``. Layouts are
the JAX package's: x ``[m, k]``, w ``[k, n]`` (the layer's ``W`` as
stored, ``y = x @ W + b``), b ``[n]``. Any m, k, n is taken: the kernel
masks ragged edges, so there is no counterpart of ``matmul_block_ok``.
f32, bf16 and f16 inputs are taken; the sum is f32 and is cast once.
A skinny product (few output tiles, deep K) splits K over an f32
scratch that the wrapper allocates (``_build.split_scratch``).

``matmul_block`` launches the kernel for a CUDA tensor and runs
``matmul_block_reference`` (the plain PyTorch version) for a CPU one.
When a gradient is wanted both run through ``_MatmulBlockFn``, whose
backward is plain PyTorch through the reference math, as the JAX
package's (``_matmul_block_bwd`` is ``jax.vjp`` of its XLA reference):
recompute ``z = x @ w + b`` in f32, ``dz = g * act'(z)`` with relu's
0.5 at z == 0, then ``dx = dz wᵀ``, ``dW = xᵀ dz``, ``db = Σ dz``. The
residual variant of the TPU kernel has no caller yet and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import _build, dispatch
from deeplearning4j_tpu_torch.ops.conv_block import (
    _EPILOGUE_GRADS,
    _EPILOGUES,
    EPILOGUE_CODES,
    check_epilogue,
    check_kernel_operand,
    check_trainable,
    wants_grad,
)


def _bias_f32(b, n: int, device) -> torch.Tensor:
    if b is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    return b.to(torch.float32).contiguous()


def _plain_z(x, w, bias):
    xf, wf = x, w
    if x.dtype != torch.float32:
        xf, wf = x.float(), w.float()
    return torch.matmul(xf, wf) + bias


def _plain_forward(x, w, bias, activation):
    return _EPILOGUES[activation](_plain_z(x, w, bias)).to(x.dtype)


def _kernel_forward(x, w, bias, activation):
    kernel = "matmul_block"
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    check_kernel_operand(kernel, "x", x, x.device, x.dtype, 2)
    check_kernel_operand(kernel, "w", w, x.device, x.dtype, 2)
    m, k = (int(v) for v in x.shape)
    wk, n = (int(v) for v in w.shape)
    if wk != k:
        raise ValueError(f"{kernel}: x is [{m}, {k}] but w is [{wk}, {n}]")
    check_kernel_operand(kernel, "b", bias, x.device, torch.float32, 1)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load()
    splits = lib.dl4j_matmul_block_splits(m, k, n)
    scratch = _build.split_scratch(splits, out.numel(), x.device)
    rc = lib.dl4j_matmul_block(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _build.DTYPE_CODES[x.dtype], m, k, n, EPILOGUE_CODES[activation],
        splits, _build.current_stream_handle(x.device),
    )
    _build.check(rc, kernel)
    dispatch.note_launch(kernel)
    return out


class _MatmulBlockFn(torch.autograd.Function):
    """The fused dense epilogue with the reference math's backward;
    ``kernels`` picks the CUDA kernel or the plain version forward."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, kernels):
        ctx.save_for_backward(x, w, bias)
        ctx.activation = activation
        fwd = _kernel_forward if kernels else _plain_forward
        return fwd(x, w, bias, activation)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        f32 = torch.float32
        xf, wf = x.to(f32), w.to(f32)
        dz = g.to(f32) * _EPILOGUE_GRADS[ctx.activation](_plain_z(xf, wf,
                                                                  bias))
        dx = torch.matmul(dz, wf.t()).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        dw = torch.matmul(xf.t(), dz).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        db = dz.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None


def _matmul(x, w, b, activation, kernels: bool):
    check_epilogue("matmul_block", activation)
    n = int(w.shape[1])
    if kernels and b is not None and (b.device != x.device
                                      or b.numel() != n):
        raise ValueError(f"matmul_block: b must hold {n} values on "
                         f"{x.device}")
    bias = _bias_f32(b, n, x.device)
    if not wants_grad(x, w, bias):
        fwd = _kernel_forward if kernels else _plain_forward
        return fwd(x, w, bias, activation)
    if kernels:
        check_trainable("matmul_block", x)
    return _MatmulBlockFn.apply(x, w, bias, activation, kernels)


def matmul_block_reference(x, w, b=None, *, activation="identity"):
    """The plain PyTorch version: same semantics as the kernel (f32
    sum, f32 epilogue, one final cast, the same backward), on any
    device."""
    return _matmul(x, w, b, activation, kernels=False)


def matmul_block(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *,
                 activation: str = "identity") -> torch.Tensor:
    """Fused ``activation(x @ w + b)``: the CUDA kernel for a CUDA
    ``x``, the plain version for a CPU one. Differentiable in x, w
    and b."""
    return _matmul(x, w, b, activation, kernels=dispatch.is_kernel_tensor(x))

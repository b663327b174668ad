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
The residual variant of the TPU kernel has no caller yet and is not
ported in this slice; a CUDA input that requires a gradient raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import _build, dispatch
from deeplearning4j_tpu_torch.ops.conv_block import (
    _EPILOGUES,
    EPILOGUE_CODES,
    check_epilogue,
    check_inference_only,
    check_kernel_operand,
)


def _bias_f32(b, n: int, device) -> torch.Tensor:
    if b is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    return b.to(torch.float32).contiguous()


def matmul_block_reference(x, w, b=None, *, activation="identity"):
    """The plain PyTorch version: same semantics as the kernel (f32
    sum, f32 epilogue, one final cast), on any device."""
    check_epilogue("matmul_block", activation)
    xf, wf = x, w
    if x.dtype != torch.float32:
        xf, wf = x.float(), w.float()
    z = torch.matmul(xf, wf) + _bias_f32(b, int(w.shape[1]), x.device)
    return _EPILOGUES[activation](z).to(x.dtype)


def matmul_block(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *,
                 activation: str = "identity") -> torch.Tensor:
    """Fused ``activation(x @ w + b)``: the CUDA kernel for a CUDA
    ``x``, the plain version for a CPU one."""
    check_epilogue("matmul_block", activation)
    if not dispatch.is_kernel_tensor(x):
        return matmul_block_reference(x, w, b, activation=activation)
    kernel = "matmul_block"
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    check_kernel_operand(kernel, "x", x, x.device, x.dtype, 2)
    check_kernel_operand(kernel, "w", w, x.device, x.dtype, 2)
    check_inference_only(kernel, x, w, b)
    m, k = (int(v) for v in x.shape)
    wk, n = (int(v) for v in w.shape)
    if wk != k:
        raise ValueError(f"{kernel}: x is [{m}, {k}] but w is [{wk}, {n}]")
    if b is not None and (b.device != x.device or b.numel() != n):
        raise ValueError(f"{kernel}: b must hold {n} values on {x.device}")
    bias = _bias_f32(b, n, x.device)
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

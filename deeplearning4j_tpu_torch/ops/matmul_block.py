"""Fused dense epilogue: ``activation(x @ w + b [+ residual])`` as one
hand-written CUDA kernel (``csrc/matmul_block.cu``).

Counterpart of ``deeplearning4j_tpu/ops/matmul_block.py``. Layouts are
the JAX package's: x ``[m, k]``, w ``[k, n]`` (the layer's ``W`` as
stored, ``y = x @ W + b``), b ``[n]``, residual ``[m, n]`` in x's dtype,
added to the f32 sum before the activation (the TPU kernel's residual
variant, ``_matmul_res_kernel``; it counts its launches apart, as
``matmul_block_residual``). Any m, k, n is taken: the kernel
masks ragged edges, so there is no counterpart of ``matmul_block_ok``.
f32, bf16 and f16 inputs are taken; the sum is f32 and is cast once.
The plain version also takes f64 (the gradient check's), summed in f64
(``acc_dtype``).
The kernel has three routes, picked from the shape alone by
``matmul_route``: ``"skinny"`` (a stream of w, each thread 4 columns of
all rows) for at most ``SKINNY_MAX_M`` rows, ``"wide"`` (128 x 192
tiles, a cp.async ring) for products whose grid fills the card,
``"tiled"`` (64 x 64 tiles) for the rest. The tiled and skinny routes
split K over an f32 scratch that the wrapper allocates
(``_build.split_scratch``) where a product has few output blocks and a
deep K, the split count by ``ops/tiling.py``'s ``matmul_splits`` /
``skinny_splits``. The plan (route and split count) comes from
``autotune.resolve``: the heuristic unless the tuning cache holds a
measured winner for the shape.

``matmul_block`` launches the kernel for a CUDA tensor and runs
``matmul_block_reference`` (the plain PyTorch version) for a CPU one.
When a gradient is wanted both run through ``_MatmulBlockFn``, whose
backward is plain PyTorch through the reference math, as the JAX
package's (``_matmul_block_bwd`` is ``jax.vjp`` of its XLA reference):
recompute ``z = x @ w + b [+ r]`` in f32, ``dz = g * act'(z)`` with
relu's 0.5 at z == 0 (the identity's ``dz = g`` needs no recompute),
then ``dx = dz wᵀ``, ``dW = xᵀ dz``, ``db = Σ dz``, ``dr = dz``.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import _build, autotune, dispatch, tiling
from deeplearning4j_tpu_torch.ops.conv_block import (
    _EPILOGUE_GRADS,
    _EPILOGUES,
    EPILOGUE_CODES,
    acc_dtype,
    check_epilogue,
    check_kernel_operand,
    check_trainable,
    wants_grad,
)


# The wide route's output tile (rows, columns), and the tiles its grid
# must hold: one wave of blocks (one an SM) on the H100's 132 SMs. Below
# that the 64 x 64 tiled route (with its split-K plan) keeps more blocks
# in flight.
WIDE_TILE = (128, 192)
WIDE_MIN_TILES = 132
# The skinny route's most rows (csrc/matmul_block.cu skinny::kM), and the
# columns one of its blocks owns (skinny::kN). A 64 x 64 tile at so few
# rows multiplies mostly zeros: the product is a read of w.
SKINNY_MAX_M = 8
SKINNY_COLS = 256
# route codes of csrc/matmul_block.cu (enum Route)
ROUTE_CODES = {"tiled": 0, "wide": 1, "skinny": 2}


def matmul_route(m: int, n: int) -> str:
    """The kernel route of an ``[m, k] @ [k, n]`` product: ``"skinny"``
    for at most ``SKINNY_MAX_M`` rows, ``"wide"`` when its 128 x 192 grid
    holds at least one wave of blocks, else ``"tiled"``. Depth and
    element type do not change it."""
    if m <= SKINNY_MAX_M:
        return "skinny"
    tiles = -(-m // WIDE_TILE[0]) * -(-n // WIDE_TILE[1])
    return "wide" if tiles >= WIDE_MIN_TILES else "tiled"


def _bias_acc(b, n: int, device, dtype) -> torch.Tensor:
    if b is None:
        return torch.zeros(n, dtype=dtype, device=device)
    return b.to(dtype).contiguous()


def _plain_z(x, w, bias, residual=None):
    acc = acc_dtype(x.dtype)
    z = torch.matmul(x.to(acc), w.to(acc)) + bias
    if residual is not None:
        z = z + residual.to(acc)
    return z


def _plain_forward(x, w, bias, residual, activation):
    return _EPILOGUES[activation](_plain_z(x, w, bias, residual)).to(x.dtype)


def _kernel_forward(x, w, bias, residual, activation):
    kernel = "matmul_block" if residual is None else "matmul_block_residual"
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    check_kernel_operand(kernel, "x", x, x.device, x.dtype, 2)
    check_kernel_operand(kernel, "w", w, x.device, x.dtype, 2)
    m, k = (int(v) for v in x.shape)
    wk, n = (int(v) for v in w.shape)
    if wk != k:
        raise ValueError(f"{kernel}: x is [{m}, {k}] but w is [{wk}, {n}]")
    check_kernel_operand(kernel, "b", bias, x.device, torch.float32, 1)
    if residual is not None:
        check_kernel_operand(kernel, "residual", residual, x.device, x.dtype,
                             2)
        if tuple(residual.shape) != (m, n):
            raise ValueError(f"{kernel}: residual is "
                             f"{list(residual.shape)}, expected [{m}, {n}]")
    args = (m, k, n)
    plan = autotune.resolve(
        kernel, {"m": m, "k": k, "n": n,
                 "dtype": dispatch.DTYPE_TAGS[x.dtype]},
        lambda: tiling.matmul_heuristic(*args),
        lambda: tiling.matmul_candidates(*args),
        lambda p: tiling.matmul_prior(p, *args),
        lambda p: lambda: _launch(x, w, bias, residual, activation, p,
                                  count=False))
    return _launch(x, w, bias, residual, activation, plan)


def _launch(x, w, bias, residual, activation, plan, count=True):
    """One launch of the dense kernel with ``plan`` (``("wide", 1)``,
    ``("tiled", splits)`` or, for at most ``SKINNY_MAX_M`` rows,
    ``("skinny", splits)``) on checked operands; counted unless
    ``count`` is False (the tuner's timing launches)."""
    kernel = "matmul_block" if residual is None else "matmul_block_residual"
    m, k = (int(v) for v in x.shape)
    n = int(w.shape[1])
    route, splits = plan
    if (route not in ROUTE_CODES or (route == "wide" and splits != 1)
            or (route == "skinny" and m > SKINNY_MAX_M)):
        raise ValueError(f"{kernel}: unknown plan {plan} for {m} rows")
    tiling.check_splits(kernel, k, splits)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load()
    scratch = _build.split_scratch(splits, out.numel(), x.device)
    rc = lib.dl4j_matmul_block(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _build.DTYPE_CODES[x.dtype], m, k, n, EPILOGUE_CODES[activation],
        splits, ROUTE_CODES[route], _build.current_stream_handle(x.device),
    )
    _build.check(rc, kernel)
    if count:
        dispatch.note_launch(kernel, dispatch.DTYPE_TAGS[x.dtype])
    return out


class _MatmulBlockFn(torch.autograd.Function):
    """The fused dense epilogue with the reference math's backward;
    ``kernels`` picks the CUDA kernel or the plain version forward."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, activation, kernels):
        ctx.save_for_backward(x, w, bias, residual)
        ctx.activation = activation
        fwd = _kernel_forward if kernels else _plain_forward
        return fwd(x, w, bias, residual, activation)

    @staticmethod
    def backward(ctx, g):
        x, w, bias, residual = ctx.saved_tensors
        acc = acc_dtype(x.dtype)
        xf, wf = x.to(acc), w.to(acc)
        dz = g.to(acc)
        if ctx.activation != "identity":
            dz = dz * _EPILOGUE_GRADS[ctx.activation](
                _plain_z(xf, wf, bias, residual))
        need = ctx.needs_input_grad
        dx = torch.matmul(dz, wf.t()).to(x.dtype) if need[0] else None
        dw = torch.matmul(xf.t(), dz).to(w.dtype) if need[1] else None
        db = dz.sum(0) if need[2] else None
        dr = dz.to(residual.dtype) if need[3] else None
        return dx, dw, db, dr, None, None


def _matmul(x, w, b, residual, activation, kernels: bool):
    check_epilogue("matmul_block", activation)
    n = int(w.shape[1])
    if kernels and b is not None and (b.device != x.device
                                      or b.numel() != n):
        raise ValueError(f"matmul_block: b must hold {n} values on "
                         f"{x.device}")
    bias = _bias_acc(b, n, x.device, acc_dtype(x.dtype))
    if not wants_grad(x, w, bias, residual):
        fwd = _kernel_forward if kernels else _plain_forward
        return fwd(x, w, bias, residual, activation)
    if kernels:
        check_trainable("matmul_block", x)
    return _MatmulBlockFn.apply(x, w, bias, residual, activation, kernels)


def matmul_block_reference(x, w, b=None, residual=None, *,
                           activation="identity"):
    """The plain PyTorch version: same semantics as the kernel (f32
    sum, f32 epilogue, one final cast, the same backward), on any
    device."""
    return _matmul(x, w, b, residual, activation, kernels=False)


def matmul_block(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None, *,
                 activation: str = "identity") -> torch.Tensor:
    """Fused ``activation(x @ w + b [+ residual])``: the CUDA kernel for
    a CUDA ``x``, the plain version for a CPU one. Differentiable in x,
    w, b and the residual."""
    return _matmul(x, w, b, residual, activation,
                   kernels=dispatch.is_kernel_tensor(x))

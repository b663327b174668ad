"""Fused convolution: ``activation((conv2d(x, w) + bias) * bn_scale +
bn_shift)`` as one hand-written CUDA kernel (``csrc/conv_block.cu``),
with a hand-written backward (``csrc/conv_bwd.cu``).

Counterpart of ``deeplearning4j_tpu/ops/conv_block.py``. The public
layouts are the JAX package's: x NCHW ``[n, c, h, w]``, w OIHW
``[o, c, kh, kw]``, per-channel bias / BN terms ``[o]``. Bias and the
BN affine fold into one f32 ``(scale, shift)`` pair outside the kernel
(``_fold_epilogue``), so the kernel sees two ``[o]`` vectors and the
gradients of bias, gamma and beta flow through the fold by autograd;
padding is done inside the kernel by bounds checks, so no padded copy
of x is made. f32, bf16 and f16 inputs are taken; the sum is f32 and is
cast once, as on the TPU. When the output has too few tiles to fill the
card, the library splits the reduction and the wrapper hands it an f32
scratch for the partial sums (``_build.split_scratch``).

``conv_block`` launches the kernel for a CUDA tensor and runs
``conv_block_reference`` (the plain PyTorch version, same semantics)
for a CPU tensor. When a gradient is wanted, both run through
``_ConvBlockFn``, the backward of the JAX package's ``_conv_block_bwd``:
recompute the f32 accumulator (the forward kernel, identity epilogue,
f32 out), apply the epilogue gradient in f32 (``_EPILOGUE_GRADS``:
relu's gradient at z == 0 is 0.5, the TPU kernel route's value, where
autograd through ``torch.relu`` would give 0), sum dscale and dshift,
then one launch each of ``conv_bwd_data`` (only when x needs a
gradient) and ``conv_bwd_w``. Under ``no_grad`` / ``inference_mode``
the forward is the direct launch alone. The backward kernels take f32:
training in bf16 / f16 on the card raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _build, dispatch

# Epilogue nonlinearities applied to the f32 accumulator before the
# single cast; numerics match nn/activations.py (leaky slope 0.01).
_EPILOGUES = {
    "identity": lambda z: z,
    "relu": torch.relu,
    "leakyrelu": lambda z: torch.where(z >= 0, z, z * 0.01),
    "tanh": torch.tanh,
}
SUPPORTED_EPILOGUES = tuple(_EPILOGUES)
# codes of csrc/common.cuh (enum Act)
EPILOGUE_CODES = {"identity": 0, "relu": 1, "leakyrelu": 2, "tanh": 3}

# d(act)/dz on the f32 pre-activation: the backward's epilogue, as the
# JAX package's _EPILOGUE_GRADS (its lax.max splits the tie at z == 0
# evenly, hence relu's 0.5 there).
_EPILOGUE_GRADS = {
    "identity": lambda z: torch.ones_like(z),
    "relu": lambda z: torch.where(
        z > 0, 1.0, torch.where(z == 0, 0.5, 0.0)).to(z.dtype),
    "leakyrelu": lambda z: torch.where(z >= 0, 1.0, 0.01).to(z.dtype),
    "tanh": lambda z: 1.0 - torch.square(torch.tanh(z)),
}

TRAINING_DTYPES = (torch.float32,)


def check_epilogue(kernel: str, activation: str) -> None:
    if activation not in _EPILOGUES:
        raise ValueError(
            f"{kernel}: unsupported epilogue '{activation}' "
            f"(supported: {SUPPORTED_EPILOGUES})"
        )


def wants_grad(*tensors) -> bool:
    """True when this call must record a graph for a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_trainable(kernel: str, x: torch.Tensor) -> None:
    """The backward kernels take f32: refuse a half-precision training
    call on the card instead of falling back."""
    if x.dtype not in TRAINING_DTYPES:
        raise NotImplementedError(
            f"{kernel}: training in {x.dtype} on the card arrives with "
            "the mixed-precision training slice; train in float32"
        )


def check_kernel_operand(kernel: str, name: str, t: torch.Tensor,
                         device: torch.device, dtype: torch.dtype,
                         ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must be {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _pair(v) -> tuple:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _fold_epilogue(o: int, bias, bn_scale, bn_shift, device):
    """Collapse bias + BN affine to one f32 (scale, shift) pair:
    act((conv + bias) * a + b) == act(conv * a + (bias * a + b))."""
    f32 = torch.float32
    if bn_scale is None and bn_shift is None and bias is not None:
        # the conv layers' case: no BN, so shift is the bias as it is
        return (torch.ones(o, dtype=f32, device=device),
                bias.to(f32).contiguous())
    scale = (bn_scale.to(f32) if bn_scale is not None
             else torch.ones(o, dtype=f32, device=device))
    shift = (bn_shift.to(f32) if bn_shift is not None
             else torch.zeros(o, dtype=f32, device=device))
    if bias is not None:
        shift = shift + bias.to(f32) * scale
    return scale.contiguous(), shift.contiguous()


def conv_output_size(size: int, k: int, s: int, p: int) -> int:
    out = (size + 2 * p - k) // s + 1
    if out <= 0:
        raise ValueError(
            f"Invalid conv/pool geometry: input {size}, kernel {k}, "
            f"stride {s}, padding {p} -> output {out}"
        )
    return out


# --- the forward: kernel and plain version ---------------------------------


def _plain_forward(x, w, scale, shift, stride, padding, activation,
                   out_dtype):
    xf, wf = x, w
    if x.dtype != torch.float32:  # f32 accumulation for half inputs
        xf, wf = x.float(), w.float()
    y = F.conv2d(xf, wf, stride=stride, padding=padding)
    z = y * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)
    return _EPILOGUES[activation](z).to(out_dtype)


def _kernel_forward(x, w, scale, shift, stride, padding, activation,
                    out_dtype):
    kernel = "conv_block"
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    check_kernel_operand(kernel, "x", x, x.device, x.dtype, 4)
    check_kernel_operand(kernel, "w", w, x.device, x.dtype, 4)
    if out_dtype != x.dtype:  # the f32 recompute takes an f32 x
        raise TypeError(f"{kernel}: the kernel writes {x.dtype}, not "
                        f"{out_dtype}")
    n, c, h, wd = (int(v) for v in x.shape)
    o, wc, kh, kw = (int(v) for v in w.shape)
    if wc != c:
        raise ValueError(f"{kernel}: x has {c} channels, w expects {wc}")
    sh, sw = stride
    ph, pw = padding
    if sh < 1 or sw < 1 or ph < 0 or pw < 0:
        raise ValueError(f"{kernel}: bad stride {stride} / padding "
                         f"{padding}")
    oh = conv_output_size(h, kh, sh, ph)
    ow = conv_output_size(wd, kw, sw, pw)
    for name, t in (("scale", scale), ("shift", shift)):
        check_kernel_operand(kernel, name, t, x.device, torch.float32, 1)
        if t.numel() != o:
            raise ValueError(f"{kernel}: {name} must hold {o} values")
    out = torch.empty((n, o, oh, ow), dtype=x.dtype, device=x.device)
    lib = _build.load()
    splits = lib.dl4j_conv_block_splits(n, c, o, kh, kw, oh, ow)
    scratch = _build.split_scratch(splits, out.numel(), x.device)
    rc = lib.dl4j_conv_block(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, c, h, wd, o, kh, kw, sh, sw, ph, pw,
        oh, ow, EPILOGUE_CODES[activation], splits,
        _build.current_stream_handle(x.device),
    )
    _build.check(rc, kernel)
    dispatch.note_launch(kernel)
    return out


# --- the backward kernels and their plain versions -------------------------


def conv_bwd_data_reference(dacc, w, x_hw, stride=(1, 1), padding=(0, 0)):
    """dL/dx of ``conv2d(x, w)`` for the f32 gradient ``dacc`` of its
    output, in plain PyTorch: the GEMM ``wᵀ · dacc`` into im2col
    columns, scattered back onto the image by ``F.fold`` (col2im)."""
    stride, padding = _pair(stride), _pair(padding)
    n, o, oh, ow = (int(v) for v in dacc.shape)
    _, c, kh, kw = (int(v) for v in w.shape)
    cols = torch.matmul(w.float().reshape(o, c * kh * kw).t(),
                        dacc.float().reshape(n, o, oh * ow))
    return F.fold(cols, output_size=tuple(int(v) for v in x_hw),
                  kernel_size=(kh, kw), stride=stride, padding=padding)


def conv_bwd_w_reference(x, dacc, w_shape, stride=(1, 1), padding=(0, 0)):
    """dL/dW (f32, OIHW) of ``conv2d(x, w)`` for the f32 gradient
    ``dacc`` of its output, in plain PyTorch: im2col (``F.unfold``),
    then one GEMM ``dacc · colsᵀ`` over the batch and the pixels."""
    stride, padding = _pair(stride), _pair(padding)
    o, c, kh, kw = (int(v) for v in w_shape)
    n = int(dacc.shape[0])
    cols = F.unfold(x.float(), (kh, kw), padding=padding, stride=stride)
    g = dacc.float().reshape(n, o, -1)
    dw = torch.einsum("nol,nkl->ok", g, cols)
    return dw.reshape(o, c, kh, kw)


def _bwd_geometry(kernel, n, c, h, wd, o, kh, kw, stride, padding, oh, ow):
    sh, sw = stride
    ph, pw = padding
    if sh < 1 or sw < 1 or ph < 0 or pw < 0:
        raise ValueError(f"{kernel}: bad stride {stride} / padding "
                         f"{padding}")
    if (conv_output_size(h, kh, sh, ph) != oh
            or conv_output_size(wd, kw, sw, pw) != ow):
        raise ValueError(
            f"{kernel}: a {h}x{wd} input under a {kh}x{kw} kernel, stride "
            f"{stride}, padding {padding} gives no {oh}x{ow} output")
    return (n, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow)


def conv_bwd_data(dacc: torch.Tensor, w: torch.Tensor, x_hw,
                  stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """dL/dx (f32 ``[n, c, h, w]``, ``x_hw = (h, w)``) from the f32
    pre-epilogue gradient ``dacc [n, o, oh, ow]`` and the f32 weights:
    the CUDA kernel for a CUDA ``dacc``, the plain version for a CPU
    one."""
    if not dispatch.is_kernel_tensor(dacc):
        return conv_bwd_data_reference(dacc, w, x_hw, stride, padding)
    kernel = "conv_bwd_data"
    f32 = torch.float32
    check_kernel_operand(kernel, "dacc", dacc, dacc.device, f32, 4)
    check_kernel_operand(kernel, "w", w, dacc.device, f32, 4)
    n, o, oh, ow = (int(v) for v in dacc.shape)
    wo, c, kh, kw = (int(v) for v in w.shape)
    if wo != o:
        raise ValueError(f"{kernel}: dacc has {o} channels, w has {wo}")
    h, wd = (int(v) for v in x_hw)
    geo = _bwd_geometry(kernel, n, c, h, wd, o, kh, kw, _pair(stride),
                        _pair(padding), oh, ow)
    dx = torch.empty((n, c, h, wd), dtype=f32, device=dacc.device)
    lib = _build.load()
    splits = lib.dl4j_conv_bwd_data_splits(n, c, h, wd, o, kh, kw)
    scratch = _build.split_scratch(splits, dx.numel(), dacc.device)
    rc = lib.dl4j_conv_bwd_data(
        dacc.data_ptr(), w.data_ptr(), dx.data_ptr(),
        None if scratch is None else scratch.data_ptr(), *geo, splits,
        _build.current_stream_handle(dacc.device))
    _build.check(rc, kernel)
    dispatch.note_launch(kernel)
    return dx


def conv_bwd_w(x: torch.Tensor, dacc: torch.Tensor, w_shape,
               stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """dL/dW (f32 OIHW ``w_shape``) from the f32 input ``x`` and the f32
    pre-epilogue gradient ``dacc``: the CUDA kernel for a CUDA ``x``,
    the plain version for a CPU one."""
    if not dispatch.is_kernel_tensor(x):
        return conv_bwd_w_reference(x, dacc, w_shape, stride, padding)
    kernel = "conv_bwd_w"
    f32 = torch.float32
    check_kernel_operand(kernel, "x", x, x.device, f32, 4)
    check_kernel_operand(kernel, "dacc", dacc, x.device, f32, 4)
    n, c, h, wd = (int(v) for v in x.shape)
    o, wc, kh, kw = (int(v) for v in w_shape)
    dn, do, oh, ow = (int(v) for v in dacc.shape)
    if wc != c or do != o or dn != n:
        raise ValueError(f"{kernel}: x {tuple(x.shape)}, dacc "
                         f"{tuple(dacc.shape)} and w {tuple(w_shape)} "
                         "disagree")
    geo = _bwd_geometry(kernel, n, c, h, wd, o, kh, kw, _pair(stride),
                        _pair(padding), oh, ow)
    dw = torch.empty((o, c, kh, kw), dtype=f32, device=x.device)
    lib = _build.load()
    splits = lib.dl4j_conv_bwd_w_splits(n, c, o, kh, kw, oh, ow)
    scratch = _build.split_scratch(splits, dw.numel(), x.device)
    rc = lib.dl4j_conv_bwd_w(
        x.data_ptr(), dacc.data_ptr(), dw.data_ptr(),
        None if scratch is None else scratch.data_ptr(), *geo, splits,
        _build.current_stream_handle(x.device))
    _build.check(rc, kernel)
    dispatch.note_launch(kernel)
    return dw


# --- autograd ---------------------------------------------------------------


class _ConvBlockFn(torch.autograd.Function):
    """The fused conv with the JAX package's hand-written backward;
    ``kernels`` picks the CUDA kernels or their plain versions for
    both passes."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, stride, padding, activation,
                kernels):
        ctx.save_for_backward(x, w, scale, shift)
        ctx.geometry = (stride, padding, activation, kernels)
        fwd = _kernel_forward if kernels else _plain_forward
        return fwd(x, w, scale, shift, stride, padding, activation, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, scale, shift = ctx.saved_tensors
        stride, padding, activation, kernels = ctx.geometry
        f32 = torch.float32
        fwd = _kernel_forward if kernels else _plain_forward
        acc = fwd(x, w, torch.ones_like(scale), torch.zeros_like(shift),
                  stride, padding, "identity", f32)
        # epilogue gradient in f32 (g arrives in x's dtype)
        sc, sf = scale.reshape(1, -1, 1, 1), shift.reshape(1, -1, 1, 1)
        dz = g.to(f32) * _EPILOGUE_GRADS[activation](acc * sc + sf)
        dscale = (dz * acc).sum((0, 2, 3)) if ctx.needs_input_grad[2] else None
        dshift = dz.sum((0, 2, 3)) if ctx.needs_input_grad[3] else None
        dacc = (dz * sc).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            bwd_data = conv_bwd_data if kernels else conv_bwd_data_reference
            dx = bwd_data(dacc, w.to(f32).contiguous(), x.shape[2:], stride,
                          padding).to(x.dtype)
        if ctx.needs_input_grad[1]:
            bwd_w = conv_bwd_w if kernels else conv_bwd_w_reference
            dw = bwd_w(x.to(f32).contiguous(), dacc, w.shape, stride,
                       padding).to(w.dtype)
        return dx, dw, dscale, dshift, None, None, None, None


def _conv(x, w, bias, bn_scale, bn_shift, stride, padding, activation,
          kernels: bool):
    check_epilogue("conv_block", activation)
    o = int(w.shape[0])
    if kernels:
        for name, t in (("bias", bias), ("bn_scale", bn_scale),
                        ("bn_shift", bn_shift)):
            if t is not None and (t.device != x.device or t.numel() != o):
                raise ValueError(f"conv_block: {name} must hold {o} values "
                                 f"on {x.device}")
    scale, shift = _fold_epilogue(o, bias, bn_scale, bn_shift, x.device)
    stride, padding = _pair(stride), _pair(padding)
    if not wants_grad(x, w, scale, shift):
        fwd = _kernel_forward if kernels else _plain_forward
        return fwd(x, w, scale, shift, stride, padding, activation, x.dtype)
    if kernels:
        check_trainable("conv_block", x)
    return _ConvBlockFn.apply(x, w, scale, shift, stride, padding,
                              activation, kernels)


def conv_block_reference(x, w, bias=None, bn_scale=None, bn_shift=None, *,
                         stride=(1, 1), padding=(0, 0),
                         activation="identity"):
    """The plain PyTorch version: same semantics as the kernel, forward
    and backward, on any device. The CPU route of ``conv_block`` and the
    yardstick the kernels are held against on the card."""
    return _conv(x, w, bias, bn_scale, bn_shift, stride, padding,
                 activation, kernels=False)


def conv_block(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               bn_scale: Optional[torch.Tensor] = None,
               bn_shift: Optional[torch.Tensor] = None, *,
               stride=(1, 1), padding=(0, 0),
               activation: str = "identity") -> torch.Tensor:
    """Fused ``activation((conv2d(x, w) + bias) * bn_scale + bn_shift)``:
    the CUDA kernels for a CUDA ``x``, the plain version for a CPU
    one. Differentiable in x, w, bias, bn_scale and bn_shift."""
    return _conv(x, w, bias, bn_scale, bn_shift, stride, padding,
                 activation, kernels=dispatch.is_kernel_tensor(x))

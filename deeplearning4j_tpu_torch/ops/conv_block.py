"""Fused convolution: ``activation((conv2d(x, w) + bias) * bn_scale +
bn_shift)`` as one hand-written CUDA kernel (``csrc/conv_block.cu``).

Counterpart of ``deeplearning4j_tpu/ops/conv_block.py``. The public
layouts are the JAX package's: x NCHW ``[n, c, h, w]``, w OIHW
``[o, c, kh, kw]``, per-channel bias / BN terms ``[o]``. Bias and the
BN affine fold into one f32 ``(scale, shift)`` pair outside the kernel
(``_fold_epilogue``), so the kernel sees two ``[o]`` vectors; padding
is done inside the kernel by bounds checks, so no padded copy of x is
made. f32, bf16 and f16 inputs are taken; the sum is f32 and is cast
once, as on the TPU. When the output has too few tiles to fill the
card, the library splits the reduction and the wrapper hands it an f32
scratch for the partial sums (``_build.split_scratch``).

``conv_block`` launches the kernel for a CUDA tensor and runs
``conv_block_reference`` (the plain PyTorch version, same semantics)
for a CPU tensor. This slice serves inference: the backward kernels
come with the training slice, so a CUDA input that requires a gradient
raises.
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


def check_epilogue(kernel: str, activation: str) -> None:
    if activation not in _EPILOGUES:
        raise ValueError(
            f"{kernel}: unsupported epilogue '{activation}' "
            f"(supported: {SUPPORTED_EPILOGUES})"
        )


def check_inference_only(kernel: str, *tensors) -> None:
    """The CUDA kernels of this slice have no backward yet: refuse a
    graph-recording call instead of silently dropping the gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel is forward-only (inference); "
            "call it under torch.no_grad() or torch.inference_mode()"
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


def _reference_core(x, w, scale, shift, stride, padding, activation):
    xf, wf = x, w
    if x.dtype != torch.float32:  # f32 accumulation for half inputs
        xf, wf = x.float(), w.float()
    y = F.conv2d(xf, wf, stride=stride, padding=padding)
    z = y * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)
    return _EPILOGUES[activation](z).to(x.dtype)


def conv_block_reference(x, w, bias=None, bn_scale=None, bn_shift=None, *,
                         stride=(1, 1), padding=(0, 0),
                         activation="identity"):
    """The plain PyTorch version: same semantics as the kernel, on any
    device. The CPU route of ``conv_block`` and the yardstick the
    kernel is held against on the card."""
    check_epilogue("conv_block", activation)
    scale, shift = _fold_epilogue(int(w.shape[0]), bias, bn_scale,
                                  bn_shift, x.device)
    return _reference_core(x, w, scale, shift, _pair(stride),
                           _pair(padding), activation)


def conv_output_size(size: int, k: int, s: int, p: int) -> int:
    out = (size + 2 * p - k) // s + 1
    if out <= 0:
        raise ValueError(
            f"Invalid conv/pool geometry: input {size}, kernel {k}, "
            f"stride {s}, padding {p} -> output {out}"
        )
    return out


def conv_block(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               bn_scale: Optional[torch.Tensor] = None,
               bn_shift: Optional[torch.Tensor] = None, *,
               stride=(1, 1), padding=(0, 0),
               activation: str = "identity") -> torch.Tensor:
    """Fused ``activation((conv2d(x, w) + bias) * bn_scale + bn_shift)``:
    the CUDA kernel for a CUDA ``x``, the plain version for a CPU one."""
    check_epilogue("conv_block", activation)
    if not dispatch.is_kernel_tensor(x):
        return conv_block_reference(x, w, bias, bn_scale, bn_shift,
                                    stride=stride, padding=padding,
                                    activation=activation)
    kernel = "conv_block"
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    check_kernel_operand(kernel, "x", x, x.device, x.dtype, 4)
    check_kernel_operand(kernel, "w", w, x.device, x.dtype, 4)
    check_inference_only(kernel, x, w, bias, bn_scale, bn_shift)
    n, c, h, wd = (int(v) for v in x.shape)
    o, wc, kh, kw = (int(v) for v in w.shape)
    if wc != c:
        raise ValueError(f"{kernel}: x has {c} channels, w expects {wc}")
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    if sh < 1 or sw < 1 or ph < 0 or pw < 0:
        raise ValueError(f"{kernel}: bad stride {stride} / padding "
                         f"{padding}")
    oh = conv_output_size(h, kh, sh, ph)
    ow = conv_output_size(wd, kw, sw, pw)
    for name, t in (("bias", bias), ("bn_scale", bn_scale),
                    ("bn_shift", bn_shift)):
        if t is not None and (t.device != x.device or t.numel() != o):
            raise ValueError(f"{kernel}: {name} must hold {o} values on "
                             f"{x.device}")
    scale, shift = _fold_epilogue(o, bias, bn_scale, bn_shift, x.device)
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

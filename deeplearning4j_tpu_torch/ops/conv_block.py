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
cast once, as on the TPU. The plain version also takes f64, summed in
f64 (``acc_dtype``; the gradient check's). When the output has too few tiles to fill the
card, the library splits the reduction and the wrapper hands it an f32
scratch for the partial sums (``_build.split_scratch``). The output is
x's dtype, or f32 for the backward's recompute of the accumulator (half
in, f32 out, as the JAX backward asks of its Pallas kernel).

``conv_block`` launches the kernel for a CUDA tensor and runs
``conv_block_reference`` (the plain PyTorch version, same semantics)
for a CPU tensor. The forward kernel takes one of two routes, picked
from the shape alone by ``conv_block_route``: the wide implicit GEMM
(large tiles fed by a ring of staged slices, the image converted to f32
as it is staged) where its grid fills the card, the direct 64 x 64 tile
with split-K elsewhere. Each kernel's plan (route, tile, channel group,
split count) comes from ``ops/autotune.py`` ``resolve`` over
``ops/tiling.py``'s candidates: the route function's unless a tuning
cache holds a measured winner for the shape.
When a gradient is wanted, the kernels and the plain version alike
run through ``_ConvBlockFn``, the backward of the JAX package's ``_conv_block_bwd``:
recompute the f32 accumulator (the forward kernel, identity epilogue,
f32 out), apply the epilogue gradient in f32 (``_EPILOGUE_GRADS``:
relu's gradient at z == 0 is 0.5, the TPU kernel route's value, where
autograd through ``torch.relu`` would give 0), sum dscale and dshift,
then one launch each of ``conv_bwd_data`` (only when x needs a
gradient; f32 dacc and weights, as in JAX) and ``conv_bwd_w`` (on x in
its own dtype, f32 dacc and dW). ``conv_bwd_data`` takes one of two kernel
routes, picked from the shape alone by ``conv_bwd_data_route``: the
resident kernel (one image's gradient, a channel group's weights and
its dx held in shared memory) where they fit, the implicit GEMM
elsewhere; ``conv_bwd_w`` likewise, by ``conv_bwd_w_route``: the
image-resident kernel (whole images staged, dW summed in registers)
where two images fit, the implicit GEMM elsewhere. Under ``no_grad`` /
``inference_mode`` the forward is its one launch alone. Every kernel
sums products of the (half or f32) values in f32 and casts once, as the
plain versions do.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _build, autotune, dispatch, tiling
# the H100's budgets the routes are sized by (ops/tiling.py holds them)
from deeplearning4j_tpu_torch.ops.tiling import (  # noqa: F401
    BLOCK_SMEM_BYTES,
    BWD_W_REGISTERS,
    SM_COUNT,
    SM_REGISTERS,
    SM_SMEM_BYTES,
    SM_THREADS,
)

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

TRAINING_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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
    """The backward kernels take f32, bf16 and f16 images: refuse any
    other training dtype on the card instead of falling back."""
    if x.dtype not in TRAINING_DTYPES:
        raise NotImplementedError(
            f"{kernel}: the kernels train in {TRAINING_DTYPES}, not "
            f"{x.dtype}")


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


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a conv of ``dtype`` operands sums in: f32, or f64 for
    f64 (the plain version's, for the f64 gradient check; the kernels
    take no f64)."""
    return torch.promote_types(dtype, torch.float32)


def _fold_epilogue(o: int, bias, bn_scale, bn_shift, device,
                   f32=torch.float32):
    """Collapse bias + BN affine to one (scale, shift) pair in the sum's
    dtype ``f32`` (f32 but in the f64 plain version):
    act((conv + bias) * a + b) == act(conv * a + (bias * a + b))."""
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
    acc = acc_dtype(x.dtype)  # f32 accumulation for half inputs
    y = F.conv2d(x.to(acc), w.to(acc), stride=stride, padding=padding)
    z = y * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)
    return _EPILOGUES[activation](z).to(out_dtype)


# The forward's two kernel routes (csrc/conv_block.cu), picked from the
# shape alone by conv_block_route. The wide route's tiles (output
# channels, pixels), each with the blocks an SM it keeps (its
# __launch_bounds__: the 96 x 256 tile's 96 accumulators a thread take
# one block an SM) and whether a thread's pixels are float4 groups (the
# wide tiles' shared loads) or lanes 32 apart (the narrow tiles' stores,
# coalesced: their small depths make the epilogue count). A conv takes
# the wide route where its tile with the least wave-quantised work has
# at least WIDE_MIN_TILES tiles (LeNet-5's first conv at the bucket of
# 32: 72 tiles, 3 % under the direct route's time) and the ring plus
# the tap table fit a block's shared memory; elsewhere the direct route.
# The ring holds f32 in every dtype (a half image is converted as it is
# staged), so one rule serves f32, bf16 and f16 (in bf16 it stays within
# 10 % of the best route at LeNet-5's, AlexNet's, VGG-16's and
# ResNet-50's shapes but at ResNet-50's three stage-0 1 x 1 convs,
# 1.16-1.27x: scripts/torch_route_ab.py --sweep --dtype bfloat16,
# PERF.md). Where the reduction is at most WIDE_SHALLOW_K deep, the
# epilogue's stores weigh as much as the sums, and only the tiles with
# coalesced lane stores compete (ResNet-50's 1 x 1 convs over 64
# channels at batch 128: 96 x 128 ran 0.556 ms where 128 x 128 ran
# 0.661). The tiles, their layouts and the cost model are fitted to
# scripts/torch_route_ab.py --sweep (PERF.md).
ROUTE_CODES = {"direct": 0, "wide": 1}
WIDE_TILES = {(96, 256): (1, True), (128, 128): (2, True),
              (96, 128): (2, False), (32, 256): (2, False)}
WIDE_K_SLICE = 16
WIDE_STAGES = 4
WIDE_MIN_TILES = 64
WIDE_SOLO_ROWS = 64
WIDE_SHALLOW_K = 64
WIDE_PAD_TAP = 0x7FFF  # a tap-table dh that fails every bounds check


class ConvRoute(NamedTuple):
    """``route`` is ``"direct"`` or ``"wide"``; the rest are the wide
    route's (0 on the direct route): its tile (``tile_o`` channels x
    ``tile_px`` pixels), the depth padded to the k slice (``k_pad``),
    the ``tiles`` of its grid and one block's dynamic shared memory
    (``smem_bytes``: the ring and the tap table)."""
    route: str
    tile_o: int = 0
    tile_px: int = 0
    k_pad: int = 0
    tiles: int = 0
    smem_bytes: int = 0


def conv_wide_smem_bytes(tile_o: int, tile_px: int, k_pad: int) -> int:
    """Dynamic shared memory of a wide block (csrc/conv_block.cu
    ``wide_smem_bytes``): WIDE_STAGES ring slots of a 16-deep slice of
    the transposed weights (16 x tile_o f32) and of the im2col operand
    (16 x tile_px f32), then the tap table (k_pad int2 entries)."""
    ring = WIDE_STAGES * WIDE_K_SLICE * (tile_o + tile_px) * 4
    return ring + 8 * k_pad


def _wide_issue_share(to: int, tp: int, vec: bool) -> float:
    """The share of a wide thread's issue slots that are FMAs, a k row
    at a time: (to / 8) x (tp / 32) FMAs against to / 32 float4 shared
    loads of channels and tp / 128 float4 (vec) or tp / 32 scalar ones
    of pixels, and the staging (about 8 instructions a gathered
    element, tp / 256 of them a row, and 6 a 16-byte weight copy)."""
    fma = (to // 8) * (tp // 32)
    loads = to // 32 + (tp // 128 if vec else tp // 32)
    copies = -(-WIDE_K_SLICE * to // 4 // 256)
    staging = 8 * tp / 256 + 6 * copies / WIDE_K_SLICE
    return fma / (fma + loads + staging)


def _wide_cost(tile, n_px, o, k_pad):
    """(wave-quantised issue, tiles) of a wide tile: the rounds of
    132 x blocks-an-SM slots its tiles take, each round one tile's FMAs
    (WIDE_SOLO_ROWS more rows of depth where the tile runs alone on its
    SM: nothing hides its prologue and epilogue) times the blocks an SM
    runs side by side, over the tile's FMA share of the issue. A grid
    short of one full round puts fewer blocks on an SM than it could
    hold (VGG-16's 8 x 8 convs: 128 tiles of 128 x 128, one an SM), and
    is charged for those alone."""
    (to, tp), (per_sm, vec) = tile, WIDE_TILES[tile]
    smem = conv_wide_smem_bytes(to, tp, k_pad)
    per_sm = max(1, min(per_sm, SM_SMEM_BYTES // (smem + 1024)))
    tiles = -(-n_px // tp) * -(-o // to)
    rounds = -(-tiles // (SM_COUNT * per_sm))
    side_by_side = min(per_sm, -(-tiles // SM_COUNT))
    depth = k_pad + (WIDE_SOLO_ROWS if per_sm == 1 else 0)
    return (rounds * side_by_side * to * tp * depth
            / _wide_issue_share(to, tp, vec), tiles)


def wide_plan(tile, n_px: int, o: int, k_pad: int) -> ConvRoute:
    """The wide route's plan in ``tile`` for ``n_px`` output pixels of
    ``o`` channels at a padded depth of ``k_pad``."""
    return ConvRoute("wide", tile[0], tile[1], k_pad,
                     _wide_cost(tile, n_px, o, k_pad)[1],
                     conv_wide_smem_bytes(*tile, k_pad))


@functools.lru_cache(maxsize=256)
def conv_block_route(n: int, c: int, h: int, w: int, o: int, kh: int,
                     kw: int, stride=(1, 1), padding=(0, 0),
                     dtype=torch.float32) -> ConvRoute:
    """The forward's kernel route for an ``[n, c, h, w]`` input under
    ``[o, c, kh, kw]`` weights (f32, bf16 or f16): ``"wide"`` where the
    wide tile
    with the least wave-quantised work (ties: the larger tile; at a
    depth of at most WIDE_SHALLOW_K the lane-store tiles alone) has at
    least WIDE_MIN_TILES tiles and its ring and tap table fit a block,
    else ``"direct"``. Decided from the shape alone (and kept per shape:
    it runs at every launch)."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    oh = conv_output_size(h, kh, sh, ph)
    ow = conv_output_size(w, kw, sw, pw)
    k_pad = -(-c * kh * kw // WIDE_K_SLICE) * WIDE_K_SLICE
    fits = [t for t in WIDE_TILES
            if conv_wide_smem_bytes(*t, k_pad) <= BLOCK_SMEM_BYTES
            and not (k_pad <= WIDE_SHALLOW_K and WIDE_TILES[t][1])]
    if (h + ph >= WIDE_PAD_TAP or not fits
            or c * h * w >= 2 ** 31):  # the tap table's int32 offsets
        return ConvRoute("direct")
    n_px = n * oh * ow
    tile = min(fits, key=lambda t: (_wide_cost(t, n_px, o, k_pad)[0],
                                    -t[0] * t[1]))
    plan = wide_plan(tile, n_px, o, k_pad)
    return plan if plan.tiles >= WIDE_MIN_TILES else ConvRoute("direct")


def conv_tap_table(c: int, h: int, w: int, kh: int, kw: int,
                   k_pad: int) -> torch.Tensor:
    """The wide route's tap table, int32 ``[k_pad, 2]``: for each k =
    (ci, dh, dw) of the reduction, the input offset ``ci*h*w + dh*w +
    dw`` from a pixel's top-left tap and ``dh << 16 | dw`` for the
    kernel's bounds checks; rows past ``c*kh*kw`` carry a dh of
    WIDE_PAD_TAP, which no bounds check passes (zero-filled)."""
    k = torch.arange(k_pad, dtype=torch.int64)
    ci, r = k // (kh * kw), k % (kh * kw)
    dh, dw = r // kw, r % kw
    live = k < c * kh * kw
    off = torch.where(live, ci * h * w + dh * w + dw, 0)
    packed = torch.where(live, dh * 65536 + dw, WIDE_PAD_TAP * 65536)
    return torch.stack([off, packed], 1).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _device_tap_table(geometry, device) -> torch.Tensor:
    """conv_tap_table on ``device``, made once per geometry and kept."""
    return conv_tap_table(*geometry).to(device)


def _conv_identity(n, c, h, wd, o, kh, kw, stride, padding, dtype=None):
    ident = {"n": n, "c": c, "h": h, "w": wd, "o": o, "kh": kh, "kw": kw,
             "sh": stride[0], "sw": stride[1], "ph": padding[0],
             "pw": padding[1]}
    if dtype is not None:
        ident["dtype"] = dispatch.DTYPE_TAGS[dtype]
    return ident


def _resolve(kernel, family, ident, args, measure, heur_args=None):
    """``autotune.resolve`` of ``kernel`` over ``tiling``'s ``family`` at
    ``args``: the heuristic, candidates and prior of that family."""
    heuristic, candidates, prior = tiling.FAMILIES[family]
    return autotune.resolve(
        kernel, ident, lambda: heuristic(*(heur_args or args)),
        lambda: candidates(*args), lambda p: prior(p, *args), measure)


def _kernel_forward(x, w, scale, shift, stride, padding, activation,
                    out_dtype):
    kernel = "conv_block"
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    check_kernel_operand(kernel, "x", x, x.device, x.dtype, 4)
    check_kernel_operand(kernel, "w", w, x.device, x.dtype, 4)
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{kernel}: the kernel writes {x.dtype} or "
                        f"float32, not {out_dtype}")
    n, c, h, wd = (int(v) for v in x.shape)
    o, wc, kh, kw = (int(v) for v in w.shape)
    if wc != c:
        raise ValueError(f"{kernel}: x has {c} channels, w expects {wc}")
    sh, sw = stride
    ph, pw = padding
    if sh < 1 or sw < 1 or ph < 0 or pw < 0:
        raise ValueError(f"{kernel}: bad stride {stride} / padding "
                         f"{padding}")
    conv_output_size(h, kh, sh, ph)
    conv_output_size(wd, kw, sw, pw)
    for name, t in (("scale", scale), ("shift", shift)):
        check_kernel_operand(kernel, name, t, x.device, torch.float32, 1)
        if t.numel() != o:
            raise ValueError(f"{kernel}: {name} must hold {o} values")
    args = (n, c, h, wd, o, kh, kw, stride, padding)
    plan = _resolve(
        kernel, "conv_block",
        _conv_identity(*args, x.dtype), args,
        lambda p: lambda: _launch_forward(x, w, scale, shift, stride,
                                          padding, activation, out_dtype,
                                          p, count=False),
        args + (x.dtype,))
    return _launch_forward(x, w, scale, shift, stride, padding, activation,
                           out_dtype, plan)


def _launch_forward(x, w, scale, shift, stride, padding, activation,
                    out_dtype, plan, count=True):
    """One launch of the forward kernel with ``plan`` (``("wide", tile_o,
    tile_px)`` or ``("direct", splits)``), on checked operands. Adds to
    the launch count unless ``count`` is False (the tuner's timing
    launches)."""
    kernel = "conv_block"
    n, c, h, wd = (int(v) for v in x.shape)
    o, _, kh, kw = (int(v) for v in w.shape)
    (sh, sw), (ph, pw) = stride, padding
    oh = conv_output_size(h, kh, sh, ph)
    ow = conv_output_size(wd, kw, sw, pw)
    out = torch.empty((n, o, oh, ow), dtype=out_dtype, device=x.device)
    lib = _build.load()
    wt = taps = scratch = None
    splits, tile_o, tile_px, k_pad = 1, 0, 0, 0
    if plan[0] == "wide":
        tile_o, tile_px = plan[1], plan[2]  # a tile the build lacks: refused
        k_pad = -(-c * kh * kw // WIDE_K_SLICE) * WIDE_K_SLICE
        o_pad = -(-o // tile_o) * tile_o
        wt = torch.empty(k_pad * o_pad, dtype=torch.float32,
                         device=x.device)
        taps = _device_tap_table((c, h, wd, kh, kw, k_pad), x.device)
    elif plan[0] == "direct":
        splits = plan[1]
        tiling.check_splits(kernel, c * kh * kw, splits)
        scratch = _build.split_scratch(splits, out.numel(), x.device)
    else:
        raise ValueError(f"{kernel}: unknown plan {plan}")
    rc = lib.dl4j_conv_block(
        x.data_ptr(), w.data_ptr(), None if wt is None else wt.data_ptr(),
        None if taps is None else taps.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype], n, c, h,
        wd, o, kh, kw, sh, sw, ph, pw,
        oh, ow, EPILOGUE_CODES[activation], splits, ROUTE_CODES[plan[0]],
        tile_o, tile_px, k_pad,
        _build.current_stream_handle(x.device),
    )
    _build.check(rc, kernel)
    if count:
        tag = dispatch.DTYPE_TAGS[x.dtype]
        dispatch.note_launch(kernel, tag if out_dtype == x.dtype
                             else f"{tag}->f32")
    return out


# --- the backward kernels and their plain versions -------------------------


def conv_bwd_data_reference(dacc, w, x_hw, stride=(1, 1), padding=(0, 0)):
    """dL/dx of ``conv2d(x, w)`` for the f32 gradient ``dacc`` of its
    output, in plain PyTorch: the GEMM ``wᵀ · dacc`` into im2col
    columns, scattered back onto the image by ``F.fold`` (col2im)."""
    stride, padding = _pair(stride), _pair(padding)
    n, o, oh, ow = (int(v) for v in dacc.shape)
    _, c, kh, kw = (int(v) for v in w.shape)
    acc = acc_dtype(dacc.dtype)
    cols = torch.matmul(w.to(acc).reshape(o, c * kh * kw).t(),
                        dacc.to(acc).reshape(n, o, oh * ow))
    return F.fold(cols, output_size=tuple(int(v) for v in x_hw),
                  kernel_size=(kh, kw), stride=stride, padding=padding)


def conv_bwd_w_reference(x, dacc, w_shape, stride=(1, 1), padding=(0, 0)):
    """dL/dW (f32, OIHW) of ``conv2d(x, w)`` for the f32 gradient
    ``dacc`` of its output, in plain PyTorch: im2col (``F.unfold``),
    then one GEMM ``dacc · colsᵀ`` over the batch and the pixels."""
    stride, padding = _pair(stride), _pair(padding)
    o, c, kh, kw = (int(v) for v in w_shape)
    n = int(dacc.shape[0])
    acc = acc_dtype(dacc.dtype)
    cols = F.unfold(x.to(acc), (kh, kw), padding=padding, stride=stride)
    g = dacc.to(acc).reshape(n, o, -1)
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


# The resident route of conv_bwd_data (csrc/conv_bwd.cu): a block holds
# one image's gradient map, a group of at most RESIDENT_MAX_GROUP input
# channels' weights and the group's dx (channels padded to 4) in shared
# memory, which must fit in the H100's 232,448 bytes a block. Groups
# below RESIDENT_MIN_GROUP channels (of a layer with more) stage each
# gradient map many times: at stride 1 such a group takes the resident
# route only where it still does RESIDENT_QUAD_MIN_SUMS multiply-adds a
# staged float (batch 128 on an H100 80GB HBM3 at 700 W,
# scripts/torch_route_ab.py --sweep: AlexNet's conv5 at 13 x 13, c 384
# -> o 256, 4-channel groups at 29.7: 2.65 ms, the implicit GEMM 3.20;
# ResNet-50's 3 x 3 at 7 x 7, c 512, 4-channel groups at 20.8: 2.40
# against 2.59; VGG-16's 3 x 3 at 4 x 4 and 2 x 2, 8-channel groups at
# 13.1 and 3.8: the GEMM 1.00-3.2x faster); at a larger stride the
# implicit GEMM multiplies
# stride² times the useful taps (zeros for the taps no output reaches),
# and any group that fits takes the resident route (ResNet-50's 3 x 3
# stride-2 conv at 14 x 14, c 512: 4-channel groups 2.41 ms, the GEMM
# 9.27). A block's threads are one per (channel quad, gradient pixel),
# in whole warps, repeated for up to kh*kw tap groups (each a run of the
# taps into a dx tile of its own), within RESIDENT_MAX_THREADS and the
# shared memory: the more threads, the more of each SM's latency hidden.
RESIDENT_SMEM_BYTES = BLOCK_SMEM_BYTES
RESIDENT_MAX_GROUP = 32
RESIDENT_MIN_GROUP = 16
RESIDENT_MAX_THREADS = 1024
# A block that does few sums a staged float (VGG-16's 8 x 8 convs: 44,
# 16-channel groups at 229 KB, one block an SM) is bound by its staging,
# which a second block on the SM hides: there 4-channel groups, two
# blocks an SM, ran 1.12-1.14x faster. At 57 (LeNet-5's conv2) and 92
# (VGG-16's 16 x 16 convs) the fewest groups stay ahead or within 6 %
# (scripts/torch_route_ab.py --sweep and --groups, PERF.md). The
# 4-channel groups must themselves do RESIDENT_QUAD_MIN_SUMS multiply-
# adds a staged float: at ResNet-50's 1 x 1 conv from 2048 channels at 7
# x 7 they would do 3.7, 512 blocks an image each staging its 100 KB
# gradient map, and ran 3.2x the 32-channel groups' time (VGG-16: 23).
RESIDENT_OVERLAP_SUMS = 48
RESIDENT_QUAD_MIN_SUMS = 16


class BwdDataRoute(NamedTuple):
    """``route`` is ``"resident"`` or ``"gemm"``; ``group`` (input
    channels a block), ``tap_groups``, ``threads`` (a block) and
    ``smem_bytes`` are the resident route's, 0 on the gemm route."""
    route: str
    group: int = 0
    tap_groups: int = 0
    threads: int = 0
    smem_bytes: int = 0


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def resident_smem_bytes(h: int, w: int, o: int, oh: int, ow: int, kh: int,
                        kw: int, group: int, tap_groups: int = 1) -> int:
    """Shared memory of a resident block: the gradient map (o·oh·ow f32,
    padded to 16 bytes), the group's weights (kh·kw·o f32 for each of
    its channels padded to 4) and a dx tile (h·w f32 a padded channel)
    for each tap group."""
    cgp = _round4(group)
    return 4 * (_round4(o * oh * ow) + kh * kw * o * cgp
                + tap_groups * cgp * h * w)


def _resident_plan(h, w, o, oh, ow, kh, kw, group) -> BwdDataRoute:
    items = _round4(group) // 4 * oh * ow  # (channel quad, pixel)
    per = min(RESIDENT_MAX_THREADS, -(-items // 32) * 32)
    tap_groups = max(1, min(kh * kw, RESIDENT_MAX_THREADS // per))
    while (tap_groups > 1 and resident_smem_bytes(
            h, w, o, oh, ow, kh, kw, group, tap_groups)
           > RESIDENT_SMEM_BYTES):
        tap_groups -= 1
    return BwdDataRoute("resident", group, tap_groups, tap_groups * per,
                        resident_smem_bytes(h, w, o, oh, ow, kh, kw, group,
                                            tap_groups))


def _sums_per_staged(group, o, oh, ow, khw) -> float:
    """Multiply-adds a resident dx block does for each float it stages
    (the image's gradient map and the group's weights)."""
    return group * oh * ow * khw * o / (o * oh * ow + khw * o * group)


def conv_bwd_data_route(n: int, c: int, h: int, w: int, o: int, kh: int,
                        kw: int, stride=(1, 1), padding=(0, 0)
                        ) -> BwdDataRoute:
    """The kernel route of dL/dx for an ``[n, c, h, w]`` input under
    ``[o, c, kh, kw]`` weights: resident with the fewest channel groups
    whose working set fits (and as many tap groups as then fit; at
    stride 1 a group of fewer than RESIDENT_MIN_GROUP channels only
    where it does RESIDENT_QUAD_MIN_SUMS multiply-adds a staged float),
    else the implicit GEMM. Where that plan's block holds its SM alone and does
    fewer than RESIDENT_OVERLAP_SUMS multiply-adds a float it stages,
    and 4-channel groups would keep two blocks on an SM while doing at
    least RESIDENT_QUAD_MIN_SUMS, it takes the 4-channel groups: the
    second block's staging then overlaps the first one's sums. Decided
    from the shape alone."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    oh = conv_output_size(h, kh, sh, ph)
    ow = conv_output_size(w, kw, sw, pw)
    groups = -(-c // RESIDENT_MAX_GROUP)
    while True:
        group = -(-c // groups)
        padded = _round4(group)
        if (resident_smem_bytes(h, w, o, oh, ow, kh, kw, group)
                <= RESIDENT_SMEM_BYTES):
            break
        if padded == 4:
            return BwdDataRoute("gemm")
        groups = -(-c // (padded - 4))  # the next smaller padded group
    if (sh * sw == 1 and padded < min(_round4(c), RESIDENT_MIN_GROUP)
            and _sums_per_staged(group, o, oh, ow, kh * kw)
            < RESIDENT_QUAD_MIN_SUMS):
        return BwdDataRoute("gemm")
    plan = _resident_plan(h, w, o, oh, ow, kh, kw, group)
    sums = group * oh * ow * kh * kw * o
    staged = o * oh * ow + kh * kw * o * group  # gradient map, weights
    alone = 2 * (plan.smem_bytes + 1024) > SM_SMEM_BYTES
    if group > 4 and alone and sums < RESIDENT_OVERLAP_SUMS * staged:
        quad = _resident_plan(h, w, o, oh, ow, kh, kw, -(-c // -(-c // 4)))
        if (2 * (quad.smem_bytes + 1024) <= SM_SMEM_BYTES
                and _sums_per_staged(quad.group, o, oh, ow, kh * kw)
                >= RESIDENT_QUAD_MIN_SUMS):
            return quad
    return plan


# The image-resident route of conv_bwd_w (csrc/conv_bwd.cu): a block
# holds two images' x slabs (a group of input channels) and gradient
# maps in shared memory, the next in flight while this one is summed,
# and a thread owns one (output-channel quad, tap row, channel) item of
# dW: 4 × k sums in registers, for square kernels up to BWD_W_MAX_K. A
# block takes at most BWD_W_MAX_THREADS (its __launch_bounds__ keeps two
# blocks an SM: BWD_W_REGISTERS a thread). Items a block beyond the
# channel group are split over pixel groups (runs of gradient rows, a
# divisor of oh, added in order at the end). The images are cut into
# chunks, one a block, for about one wave of blocks, as long as the
# chunks' f32 partial sums stay within BWD_W_MAX_SCRATCH bytes.
BWD_W_MAX_THREADS = 384
BWD_W_MAX_K = 5
BWD_W_MAX_SCRATCH = 16 << 20
# Where the channel groups alone fill the grid, the chunks collapse and
# each block walks tens of images in series: VGG-16's 3 x 3 convs at c
# 128-512 and batch 128 (43-128 images a block) ran 1.14-4.24x the
# implicit GEMM's time there, LeNet-5's (1-4 images a block) 0.45x
# (scripts/torch_route_ab.py --sweep, PERF.md). Past this many images a
# block, the implicit GEMM.
BWD_W_MAX_IMAGES = 16


class BwdWRoute(NamedTuple):
    """``route`` is ``"image_resident"`` or ``"gemm"``; the rest are the
    image-resident route's (0 on the gemm route): input channels a
    block (``group``), ``pixel_groups``, ``threads`` and ``smem_bytes``
    a block, and the images a block (``images_per_chunk``) with the
    ``chunks`` they make."""
    route: str
    group: int = 0
    pixel_groups: int = 0
    threads: int = 0
    smem_bytes: int = 0
    images_per_chunk: int = 0
    chunks: int = 0


def bwd_w_smem_bytes(h: int, w: int, o: int, oh: int, ow: int, k: int,
                     group: int, pixel_groups: int = 1) -> int:
    """Shared memory of an image-resident dW block: two staging buffers,
    each an x slab of ``group`` channels at the odd stride ``h·w | 1``
    (padded to 16 bytes) and ``o`` gradient maps at a stride of
    ``oh·ow`` padded to 4 floats plus 4; after the image loop the same
    memory takes the pixel groups' sums where there is more than one
    (pixel_groups × items × 4·k f32, items = ceil(o / 4)·k·group), else
    the block's dW slice (o·group·k² f32) on its way out."""
    stage = 2 * (_round4(group * ((h * w) | 1)) + o * (_round4(oh * ow) + 4))
    red = pixel_groups * (-(-o // 4) * k * group) * 4 * k
    out = o * group * k * k
    return 4 * max(stage, red if pixel_groups > 1 else out)


def conv_bwd_w_route(n: int, c: int, h: int, w: int, o: int, kh: int,
                     kw: int, stride=(1, 1), padding=(0, 0)) -> BwdWRoute:
    """The kernel route of dL/dW for an ``[n, c, h, w]`` input under
    ``[o, c, kh, kw]`` weights: image-resident (square kernels up to 5 ×
    5) with the fewest channel groups whose items fit a block and whose
    two staged images fit in shared memory, as long as a block walks at
    most BWD_W_MAX_IMAGES images; else the implicit GEMM. Decided from
    the shape alone."""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    oh = conv_output_size(h, kh, sh, ph)
    ow = conv_output_size(w, kw, sw, pw)
    k = kw
    per_channel = -(-o // 4) * k  # items a channel
    if kh != kw or k > BWD_W_MAX_K or per_channel > BWD_W_MAX_THREADS:
        return BwdWRoute("gemm")
    groups = -(-c // (BWD_W_MAX_THREADS // per_channel))
    while True:
        group = -(-c // groups)
        if bwd_w_smem_bytes(h, w, o, oh, ow, k, group) <= RESIDENT_SMEM_BYTES:
            break
        if group == 1:
            return BwdWRoute("gemm")
        groups = -(-c // (group - 1))
    items = per_channel * group
    pixel_groups = max(p for p in range(1, oh + 1) if oh % p == 0
                       and items * p <= BWD_W_MAX_THREADS
                       and bwd_w_smem_bytes(h, w, o, oh, ow, k, group, p)
                       <= RESIDENT_SMEM_BYTES)
    threads = -(-items * pixel_groups // 32) * 32
    smem = bwd_w_smem_bytes(h, w, o, oh, ow, k, group, pixel_groups)
    per_sm = max(1, min(SM_SMEM_BYTES // (smem + 1024),
                        SM_THREADS // threads,
                        SM_REGISTERS // (BWD_W_REGISTERS * threads)))
    chunks = max(1, min(n, -(-SM_COUNT * per_sm // groups),
                        BWD_W_MAX_SCRATCH // (4 * o * c * k * k)))
    per_chunk = -(-n // chunks)
    if per_chunk > BWD_W_MAX_IMAGES:
        return BwdWRoute("gemm")
    return BwdWRoute("image_resident", group, pixel_groups, threads, smem,
                     per_chunk, -(-n // per_chunk))


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
    args = (n, c, h, wd, o, kh, kw, geo[7:9], geo[9:11])
    plan = _resolve(kernel, "conv_bwd_data", _conv_identity(*args), args,
                    lambda p: lambda: _launch_bwd_data(dacc, w, geo, p,
                                                       count=False))
    return _launch_bwd_data(dacc, w, geo, plan)


def _launch_bwd_data(dacc, w, geo, plan, count=True):
    """One launch of dL/dx with ``plan`` (``("resident", group,
    tap_groups)`` or ``("gemm", splits)``) at the checked geometry
    ``geo``."""
    kernel = "conv_bwd_data"
    f32 = torch.float32
    n, c, h, wd, o, kh, kw = geo[:7]
    dx = torch.empty((n, c, h, wd), dtype=f32, device=dacc.device)
    lib = _build.load()
    stream = _build.current_stream_handle(dacc.device)
    if plan[0] == "resident":
        group, tap_groups = plan[1], plan[2]
        # the weights, transposed per channel group (one pass a call)
        wt = torch.empty(-(-c // group) * kh * kw * o * _round4(group),
                         dtype=f32, device=dacc.device)
        rc = lib.dl4j_conv_bwd_data_resident(
            dacc.data_ptr(), w.data_ptr(), wt.data_ptr(), dx.data_ptr(),
            *geo, group, tap_groups, stream)
    elif plan[0] == "gemm":
        splits = plan[1]
        tiling.check_splits(kernel, o * kh * kw, splits)
        scratch = _build.split_scratch(splits, dx.numel(), dacc.device)
        rc = lib.dl4j_conv_bwd_data(
            dacc.data_ptr(), w.data_ptr(), dx.data_ptr(),
            None if scratch is None else scratch.data_ptr(), *geo, splits,
            stream)
    else:
        raise ValueError(f"{kernel}: unknown plan {plan}")
    _build.check(rc, kernel)
    if count:
        dispatch.note_launch(kernel)
    return dx


def conv_bwd_w(x: torch.Tensor, dacc: torch.Tensor, w_shape,
               stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """dL/dW (f32 OIHW ``w_shape``) from the input ``x`` (f32, bf16 or
    f16: the kernels convert it as they stage it) and the f32
    pre-epilogue gradient ``dacc``: the CUDA kernel for a CUDA ``x``,
    the plain version for a CPU one."""
    if not dispatch.is_kernel_tensor(x):
        return conv_bwd_w_reference(x, dacc, w_shape, stride, padding)
    kernel = "conv_bwd_w"
    f32 = torch.float32
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {x.dtype}")
    check_kernel_operand(kernel, "x", x, x.device, x.dtype, 4)
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
    args = (n, c, h, wd, o, kh, kw, geo[7:9], geo[9:11])
    plan = _resolve(kernel, "conv_bwd_w", _conv_identity(*args, x.dtype),
                    args,
                    lambda p: lambda: _launch_bwd_w(x, dacc, geo, p,
                                                    count=False))
    return _launch_bwd_w(x, dacc, geo, plan)


def _launch_bwd_w(x, dacc, geo, plan, count=True):
    """One launch of dL/dW with ``plan`` (``("image_resident", group,
    pixel_groups, images_per_chunk)`` or ``("gemm", splits)``) at the
    checked geometry ``geo``."""
    kernel = "conv_bwd_w"
    n, c, h, wd, o, kh, kw = geo[:7]
    oh, ow = geo[11], geo[12]
    dw = torch.empty((o, c, kh, kw), dtype=torch.float32, device=x.device)
    lib = _build.load()
    stream = _build.current_stream_handle(x.device)
    if plan[0] == "image_resident":
        group, pixel_groups, per_chunk = plan[1:]
        scratch = _build.split_scratch(-(-n // per_chunk), dw.numel(),
                                       x.device)
        rc = lib.dl4j_conv_bwd_w_resident(
            x.data_ptr(), dacc.data_ptr(), dw.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _build.DTYPE_CODES[x.dtype], *geo,
            group, pixel_groups, per_chunk, stream)
    elif plan[0] == "gemm":
        splits = plan[1]
        tiling.check_splits(kernel, n * oh * ow, splits,
                            tiling.MAX_DW_SPLITS)
        scratch = _build.split_scratch(splits, dw.numel(), x.device)
        rc = lib.dl4j_conv_bwd_w(
            x.data_ptr(), dacc.data_ptr(), dw.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _build.DTYPE_CODES[x.dtype], *geo, splits, stream)
    else:
        raise ValueError(f"{kernel}: unknown plan {plan}")
    _build.check(rc, kernel)
    if count:
        dispatch.note_launch(kernel, dispatch.DTYPE_TAGS[x.dtype])
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
        f32 = acc_dtype(x.dtype)
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
            # x in its own dtype: the kernel converts as it stages
            bwd_w = conv_bwd_w if kernels else conv_bwd_w_reference
            dw = bwd_w(x.contiguous(), dacc, w.shape, stride,
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
    scale, shift = _fold_epilogue(o, bias, bn_scale, bn_shift, x.device,
                                  acc_dtype(x.dtype))
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

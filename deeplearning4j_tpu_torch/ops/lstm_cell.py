"""The fused LSTM: one timestep (``csrc/lstm_cell.cu``) and the whole
sequence forward and backward (``csrc/lstm_seq.cu``), hand-written CUDA
kernels, each with its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/ops/lstm_cell.py``. Layouts are the
JAX package's: xproj ``[b, 4n]`` a step or ``[T, b, 4n]`` a sequence
(``x @ W + b``, gate column blocks i, f, o, g), h / c ``[b, n]``, RW
``[n, 4n]``, the peepholes pI / pF / pO ``[n]`` each.

- ``lstm_cell`` is one step (peepholes optional); ``lstm_cell_diff`` is
  the same step as a ``torch.autograd.Function`` whose backward
  recomputes through the plain cell (``lstm_cell_reference``), as the JAX
  package's ``_cell_bwd`` takes ``jax.vjp`` of ``_reference_cell``.
- ``lstm_sequence`` runs a whole sequence without peepholes or mask. As
  the JAX custom_vjp does, its forward writes c_seq only when a gradient
  is wanted (``lstm_seq_fwd(..., save_cseq=True)``); the backward builds
  h_{t-1} and c_{t-1}, runs ``lstm_seq_bwd`` in reverse time and forms
  dRW with one ``torch.matmul`` over the sequence.

Routing follows the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor the kernel. The cell has two kernel routes,
picked from the shape alone by ``lstm_cell_route``: ``latency`` (blocks
of 2 hidden units, every copy in flight before one wait) where a
block's h rows and RW columns fit 48 KB, ``slice`` (8 units a block,
the depth streamed) elsewhere. The sequence kernels have two routes,
picked from the shape alone by ``lstm_seq_route``: a thread-block
cluster owning a few batch rows for the whole sequence, RW's columns
resident across its blocks (n <= 256), else the cooperative grid split
by hidden units. A refused cluster launch raises; it never falls back.
Each launch's plan comes from ``ops/autotune.py`` ``resolve`` over
``ops/tiling.py``'s candidates: the route function's unless a tuning
cache holds a measured winner for the shape.
The kernels take float32 only; a bf16 / f16 CUDA tensor raises (ROADMAP.md queue 1, item 3: bf16 / f16 LSTM
kernels). The plain versions take every float type and compute in at
least float32, as the kernels accumulate.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import _build, autotune, dispatch, tiling
from deeplearning4j_tpu_torch.ops.conv_block import (
    check_kernel_operand,
    wants_grad,
)

Peepholes = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _check_kernel_dtype(kernel: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise NotImplementedError(
            f"{kernel}: {t.dtype} on the card arrives with the bf16 / f16 "
            "LSTM kernels (ROADMAP.md queue 1, item 3); run the LSTM "
            "in float32")


def _check_int32(kernel: str, *tensors) -> None:
    for t in tensors:
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{kernel}: {tuple(t.shape)} exceeds the "
                             "kernel's 32-bit sizes")


def _gates(z, c, peepholes: Peepholes):
    """The cell's nonlinearities on the pre-activation z [.., 4n]."""
    zi, zf, zo, zg = z.chunk(4, dim=-1)
    if peepholes is not None:
        p_i, p_f, p_o = peepholes
        zi = zi + c * p_i
        zf = zf + c * p_f
    i = torch.sigmoid(zi)
    f = torch.sigmoid(zf)
    g = torch.tanh(zg)
    c_new = f * c + i * g
    if peepholes is not None:
        zo = zo + c_new * p_o
    o = torch.sigmoid(zo)
    return o * torch.tanh(c_new), c_new


# --- one step (kernel 6) ------------------------------------------------------


def lstm_cell_reference(xproj, h, c, rw, peepholes: Peepholes = None):
    """The plain PyTorch version of one fused step, on any device: a
    copy of the JAX package's ``_reference_cell``, in at least f32.
    Returns ``(h_new, c_new)``."""
    ct = _compute_dtype(h)
    peeps = None if peepholes is None else tuple(p.to(ct) for p in peepholes)
    h_new, c_new = _gates(xproj.to(ct) + h.to(ct) @ rw.to(ct), c.to(ct),
                          peeps)
    return h_new.to(h.dtype), c_new.to(c.dtype)


# The cell's two kernel routes (csrc/lstm_cell.cu), picked from the
# shape alone by lstm_cell_route. The latency route: a block owns
# CELL_UNITS hidden units for up to CELL_ROWS batch rows, its h rows and
# RW columns staged at once in at most CELL_SMEM_BYTES of shared memory
# (no opt-in) by all its CELL_MAX_THREADS threads; rows x units x splits
# of them sum, splitting the depth CELL_MAX_SPLITS ways at most (the
# lanes of one warp). Elsewhere the slice route (8 units a block,
# the depth streamed in 32-deep slices).
CELL_ROUTE_CODES = {"slice": 0, "latency": 1}
CELL_UNITS = 2
CELL_ROWS = 32
CELL_MAX_THREADS = 256
CELL_MAX_SPLITS = 32
CELL_SMEM_BYTES = tiling.CELL_SMEM_BYTES


class CellRoute(NamedTuple):
    """``route`` is ``"latency"`` or ``"slice"``; the rest are the
    latency route's (0 on the slice route): batch ``rows`` and hidden
    ``units`` a block, the depth ``splits`` of a (row, unit), the grid
    (``unit_blocks`` x ``row_blocks``), a block's ``threads`` and its
    dynamic shared memory (``smem_bytes``)."""
    route: str
    rows: int = 0
    units: int = 0
    splits: int = 0
    unit_blocks: int = 0
    row_blocks: int = 0
    threads: int = 0
    smem_bytes: int = 0


def lstm_cell_smem_bytes(n: int, rows: int, units: int) -> int:
    """Dynamic shared memory of a latency block (csrc/lstm_cell.cu
    ``latency_smem_bytes``): ``rows`` h rows at a stride of n rounded up
    to 4 floats, then n depth rows of the block's 4 x units RW
    columns."""
    return 4 * (rows * _round4(n) + n * units * 4)


def latency_plan(b: int, n: int, rows: int, units: int) -> CellRoute:
    """The latency route's plan at (b, n) with ``rows`` batch rows and
    ``units`` hidden units a block: the most depth splits (a power of
    two up to CELL_MAX_SPLITS) that keep rows x units x splits within a
    block's CELL_MAX_THREADS."""
    splits = 1
    while (splits * 2 <= CELL_MAX_SPLITS
           and rows * units * splits * 2 <= CELL_MAX_THREADS):
        splits *= 2
    return CellRoute("latency", rows, units, splits, -(-n // units),
                     -(-b // rows), CELL_MAX_THREADS,
                     lstm_cell_smem_bytes(n, rows, units))


@functools.lru_cache(maxsize=256)
def lstm_cell_route(b: int, n: int) -> CellRoute:
    """The kernel route of one step at (b, n): ``"latency"`` with up to
    CELL_ROWS rows and CELL_UNITS units a block where its rows of h and
    columns of RW fit CELL_SMEM_BYTES, else ``"slice"``. Decided from
    the shape alone (and kept per shape: the per-step route asks at
    every timestep)."""
    plan = latency_plan(b, n, min(b, CELL_ROWS), CELL_UNITS)
    return plan if plan.smem_bytes <= CELL_SMEM_BYTES else CellRoute("slice")


def lstm_cell_plan(b: int, n: int) -> dict:
    """How the card would launch one step at (b, n): the route
    (``lstm_cell_route``) and, on the latency route, one block's shared
    memory and threads as the C source reckons them. Builds the
    kernels; needs a card."""
    route = lstm_cell_route(b, n)
    if route.route != "latency":
        return {"route": route.route}
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    rc = _build.load().dl4j_lstm_cell_plan(
        b, n, route.rows, route.units, route.splits, ctypes.byref(smem),
        ctypes.byref(threads))
    _build.check(rc, "lstm_cell_plan")
    return {"route": "latency", "smem_bytes": smem.value,
            "threads": threads.value}


def _kernel_cell(xproj, h, c, rw, peepholes: Peepholes):
    kernel = "lstm_cell"
    _check_kernel_dtype(kernel, h)
    dev = h.device
    b, n = (int(v) for v in h.shape)
    for name, t, shape in (("xproj", xproj, (b, 4 * n)), ("h", h, (b, n)),
                           ("c", c, (b, n)), ("rw", rw, (n, 4 * n))):
        check_kernel_operand(kernel, name, t, dev, torch.float32, 2)
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")
    peeps = (None, None, None)
    if peepholes is not None:
        for name, p in zip(("pI", "pF", "pO"), peepholes):
            check_kernel_operand(kernel, name, p, dev, torch.float32, 1)
            if p.numel() != n:
                raise ValueError(f"{kernel}: {name} must hold {n} values")
        peeps = tuple(p.data_ptr() for p in peepholes)
    _check_int32(kernel, xproj, rw)
    plan = autotune.resolve(
        kernel, {"b": b, "n": n},
        lambda: tiling.lstm_cell_heuristic(b, n),
        lambda: tiling.lstm_cell_candidates(b, n),
        lambda p: tiling.lstm_cell_prior(p, b, n),
        lambda p: lambda: _launch_cell(xproj, h, c, rw, peeps, p,
                                       count=False))
    return _launch_cell(xproj, h, c, rw, peeps, plan)


def _launch_cell(xproj, h, c, rw, peeps, plan, count=True):
    """One launch of the step with ``plan`` (``("latency", rows, units,
    splits)`` or ``("slice",)``) on checked operands; counted unless
    ``count`` is False (the tuner's timing launches)."""
    kernel = "lstm_cell"
    b, n = (int(v) for v in h.shape)
    if plan[0] not in CELL_ROUTE_CODES:
        raise ValueError(f"{kernel}: unknown plan {plan}")
    rows, units, splits = plan[1:] if plan[0] == "latency" else (0, 0, 0)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    rc = _build.load().dl4j_lstm_cell(
        xproj.data_ptr(), h.data_ptr(), c.data_ptr(), rw.data_ptr(), *peeps,
        h_out.data_ptr(), c_out.data_ptr(), b, n,
        CELL_ROUTE_CODES[plan[0]], rows, units, splits,
        _build.current_stream_handle(h.device))
    _build.check(rc, kernel)
    if count:
        dispatch.note_launch(kernel)
    return h_out, c_out


def lstm_cell(xproj: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              rw: torch.Tensor, peepholes: Peepholes = None):
    """One fused step ``(h_new, c_new)``: the CUDA kernel for a CUDA
    ``h``, the plain version for a CPU one. Not differentiable; see
    ``lstm_cell_diff``."""
    if dispatch.is_kernel_tensor(h):
        return _kernel_cell(xproj, h, c, rw, peepholes)
    return lstm_cell_reference(xproj, h, c, rw, peepholes)


class _CellFn(torch.autograd.Function):
    """The fused step; the backward recomputes through the plain cell
    and takes its vector-Jacobian product (the JAX ``_cell_bwd``)."""

    @staticmethod
    def forward(ctx, xproj, h, c, rw, p_i, p_f, p_o):
        ctx.save_for_backward(xproj, h, c, rw, p_i, p_f, p_o)
        peeps = None if p_i is None else (p_i, p_f, p_o)
        return lstm_cell(xproj, h, c, rw, peeps)

    @staticmethod
    def backward(ctx, g_h, g_c):
        saved = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in saved]
        xproj, h, c, rw, p_i, p_f, p_o = leaves
        peeps = None if p_i is None else (p_i, p_f, p_o)
        with torch.enable_grad():
            h_new, c_new = lstm_cell_reference(xproj, h, c, rw, peeps)
            wanted = [t for t, need in zip(leaves, ctx.needs_input_grad)
                      if need and t is not None]
            got = iter(torch.autograd.grad((h_new, c_new), wanted,
                                           (g_h, g_c), allow_unused=True))
        return tuple(next(got) if need and t is not None else None
                     for t, need in zip(leaves, ctx.needs_input_grad))


def lstm_cell_diff(xproj, h, c, rw, peepholes: Peepholes = None):
    """``lstm_cell`` with a gradient in every input (the peepholes
    included)."""
    peeps = (None, None, None) if peepholes is None else tuple(peepholes)
    if not wants_grad(xproj, h, c, rw, *peeps):
        return lstm_cell(xproj, h, c, rw, peepholes)
    return _CellFn.apply(xproj, h, c, rw, *peeps)


# --- the whole sequence (kernels 7 and 8) ----------------------------------------


def lstm_seq_fwd_reference(xproj, h0, c0, rw, save_cseq: bool = True):
    """The plain sequence forward: a loop over T of the reference cell,
    h and c carried in at least f32. Returns ``(h_seq, c_seq or None,
    hT, cT)`` in h0's dtype."""
    ct, dt = _compute_dtype(h0), h0.dtype
    h, c, rwf = h0.to(ct), c0.to(ct), rw.to(ct)
    hs, cs = [], []
    for t in range(int(xproj.shape[0])):
        h, c = _gates(xproj[t].to(ct) + h @ rwf, c, None)
        hs.append(h)
        cs.append(c)
    hseq = torch.stack(hs).to(dt)
    cseq = torch.stack(cs).to(dt) if save_cseq else None
    return hseq, cseq, h.to(dt), c.to(dt)


def _seq_dims(kernel, xproj, rw):
    T, b, four_n = (int(v) for v in xproj.shape)
    n = int(rw.shape[0])
    if four_n != 4 * n or tuple(rw.shape) != (n, 4 * n):
        raise ValueError(f"{kernel}: xproj {tuple(xproj.shape)} and rw "
                         f"{tuple(rw.shape)} do not form [T, b, 4n], [n, 4n]")
    if T == 0:
        raise ValueError(f"{kernel}: the sequence is empty")
    return T, b, n


def _check_seq_operands(kernel, dev, named):
    for name, t, shape in named:
        check_kernel_operand(kernel, name, t, dev, torch.float32, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")


def _barrier(dev) -> torch.Tensor:
    """The two zeroed words of device memory a grid-route launch's grid
    barrier uses (arrivals, generation)."""
    return torch.zeros(2, dtype=torch.int32, device=dev)


# The cluster route (csrc/lstm_seq.cu): C blocks a cluster (at most 8,
# the portable size), block k owning units [k U, (k+1) U), U = ceil(n /
# C); a cluster owns `rows` batch rows; each block keeps its units' 4
# gate columns of RW resident in shared memory. A block has 256 threads,
# and the backward's dh product gives a thread one depth row of the
# block's columns in registers: U <= 32 and n <= 256, so n <= 256 at C 8.
LSTM_CLUSTER = 8
LSTM_CLUSTER_MAX_UNITS = 32
LSTM_CLUSTER_ROWS = (1, 2, 4, 8)
# clusters a launch aims at: rows a cluster is the fewest that keep b
# within 8 clusters. The backward's 256 threads of 210-255 registers
# take an SM each, and fewer than 16 such clusters of 8 fit an H100 at
# once (scripts/torch_route_ab.py --rows times each rows a cluster)
LSTM_CLUSTER_SLOTS = 8
LSTM_CLUSTER_MAX_SPLITS = 16
LSTM_THREADS = 256
MAX_SMEM_BYTES = tiling.BLOCK_SMEM_BYTES  # a block's on an H100


class LstmSeqRoute(NamedTuple):
    """``route`` is ``"cluster"`` or ``"grid"``; the rest are the
    cluster route's (0 on the grid route): blocks a cluster
    (``cluster``), batch rows a cluster (``rows``), the ``clusters`` that
    cover b, and one block's dynamic shared memory (``smem_bytes``)."""
    route: str
    cluster: int = 0
    rows: int = 0
    clusters: int = 0
    smem_bytes: int = 0


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def lstm_cluster_blocks(n: int) -> int:
    """Blocks a cluster at width n: the fewest that keep U = ceil(n / 8)
    units a block, so that every block owns at least one unit (at n 13,
    7 blocks of 2 units, not 8 with the last one empty)."""
    return -(-n // -(-n // LSTM_CLUSTER))


def lstm_cluster_smem_bytes(n: int, cluster: int, rows: int,
                            bwd: bool) -> int:
    """Dynamic shared memory of one cluster block (csrc/lstm_seq.cu
    ``cluster_smem_floats``, which ``lstm_seq_plan`` reports on the card):
    the block's gate columns of RW (n rows at a stride of 4·(U | 1)
    floats), two h buffers (n × rows) and the gate product's partial sums
    (KS × rows × U × 4, KS = min(16, 256 // U, n) depth splits); backward
    also dz (rows × U × 4) and two buffers of dh partials (2 × C × rows ×
    U). U <= 32 bounds it: the largest plan (n 256, rows 8, backward)
    takes 204,800 bytes, under ``MAX_SMEM_BYTES`` (pinned by the tests),
    and the route rule needs no check of its own."""
    u = -(-n // cluster)
    ks = min(LSTM_CLUSTER_MAX_SPLITS, LSTM_THREADS // u, n)
    floats = n * 4 * (u | 1) + _round4(2 * n * rows) + ks * rows * u * 4
    if bwd:
        floats += rows * u * 4 + _round4(2 * cluster * rows * u)
    return 4 * floats


def lstm_seq_route(T: int, b: int, n: int, bwd: bool) -> LstmSeqRoute:
    """The kernel route of a whole-sequence launch at (T, b, n): the
    cluster route where a cluster's blocks can hold RW's columns (U <=
    32 at C 8), with ``lstm_cluster_blocks(n)`` blocks a cluster and the
    fewest rows a cluster (1, 2, 4, 8) that keep b within
    ``LSTM_CLUSTER_SLOTS`` clusters; else the grid route. Decided from
    the shape alone (T changes nothing: every step runs in the same
    cluster)."""
    del T
    if -(-n // LSTM_CLUSTER) > LSTM_CLUSTER_MAX_UNITS:
        return LstmSeqRoute("grid")
    c = lstm_cluster_blocks(n)
    rows = next((r for r in LSTM_CLUSTER_ROWS
                 if -(-b // r) <= LSTM_CLUSTER_SLOTS), LSTM_CLUSTER_ROWS[-1])
    return LstmSeqRoute("cluster", c, rows, -(-b // rows),
                        lstm_cluster_smem_bytes(n, c, rows, bwd))


def _route_args(plan, dev):
    """(barrier or None, cluster, rows) for the C entries of ``plan``
    (``("cluster", blocks, rows)`` or ``("grid",)``): the grid route's
    barrier words, or the cluster plan (no barrier)."""
    if plan[0] == "cluster":
        return None, plan[1], plan[2]
    if plan != ("grid",):
        raise ValueError(f"lstm_seq: unknown plan {plan}")
    return _barrier(dev), 0, 0


def _seq_plan(kernel, T, b, n, bwd, launch):
    """The sequence kernel's plan: ``autotune.resolve`` over tiling's
    candidates (``launch(plan)`` runs one uncounted launch)."""
    args = (T, b, n, bwd)
    return autotune.resolve(
        kernel, {"T": T, "b": b, "n": n},
        lambda: tiling.lstm_seq_heuristic(*args),
        lambda: tiling.lstm_seq_candidates(*args),
        lambda p: tiling.lstm_seq_prior(p, *args),
        lambda p: lambda: launch(p, False))


def _kernel_seq_fwd(xproj, h0, c0, rw, save_cseq: bool):
    kernel = "lstm_seq_fwd"
    _check_kernel_dtype(kernel, xproj)
    T, b, n = _seq_dims(kernel, xproj, rw)
    dev = xproj.device
    _check_seq_operands(kernel, dev, (
        ("xproj", xproj, (T, b, 4 * n)), ("rw", rw, (n, 4 * n)),
        ("h0", h0, (b, n)), ("c0", c0, (b, n))))
    _check_int32(kernel, xproj)

    def launch(plan, count=True):
        hseq = torch.empty((T, b, n), dtype=torch.float32, device=dev)
        cseq = torch.empty_like(hseq) if save_cseq else None
        hT = torch.empty((b, n), dtype=torch.float32, device=dev)
        cT = torch.empty_like(hT)
        bar, cluster, rows = _route_args(plan, dev)
        rc = _build.load().dl4j_lstm_seq_fwd(
            xproj.data_ptr(), rw.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hseq.data_ptr(), None if cseq is None else cseq.data_ptr(),
            hT.data_ptr(), cT.data_ptr(),
            None if bar is None else bar.data_ptr(),
            T, b, n, cluster, rows, _build.current_stream_handle(dev))
        _build.check(rc, kernel)
        if count:
            dispatch.note_launch(kernel)
        return hseq, cseq, hT, cT
    return launch(_seq_plan(kernel, T, b, n, False, launch))


def lstm_seq_fwd(xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                 rw: torch.Tensor, save_cseq: bool = True):
    """The whole-sequence forward in one launch for a CUDA ``xproj`` (the
    plain loop for a CPU one): ``(h_seq [T, b, n], c_seq or None, hT,
    cT)``. ``save_cseq=False`` is the inference variant, which writes no
    c_seq. Not differentiable; see ``lstm_sequence``."""
    if dispatch.is_kernel_tensor(xproj):
        return _kernel_seq_fwd(xproj, h0, c0, rw, save_cseq)
    return lstm_seq_fwd_reference(xproj, h0, c0, rw, save_cseq)


def lstm_seq_bwd_reference(xproj, hprev, cprev, cseq, rw, dhseq, dhT, dcT):
    """The plain reverse-time loop with the TPU kernel's formulas
    (``_seq_bwd_kernel``): recompute the gates from h_{t-1}, carry dh and
    dc, collect dgates. Returns ``(dgates [T, b, 4n], dh0, dc0)``, all in
    at least f32."""
    ct = _compute_dtype(xproj)
    rwf = rw.to(ct)
    dh, dc = dhT.to(ct), dcT.to(ct)
    T = int(xproj.shape[0])
    dgates = torch.empty(xproj.shape, dtype=ct, device=xproj.device)
    for t in range(T - 1, -1, -1):
        z = xproj[t].to(ct) + hprev[t].to(ct) @ rwf
        zi, zf, zo, zg = z.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
        g = torch.tanh(zg)
        tc = torch.tanh(cseq[t].to(ct))
        dht = dhseq[t].to(ct) + dh
        d_o = dht * tc
        dct = dht * o * (1.0 - tc * tc) + dc
        dgates[t] = torch.cat([
            (dct * g) * i * (1.0 - i),
            (dct * cprev[t].to(ct)) * f * (1.0 - f),
            d_o * o * (1.0 - o),
            (dct * i) * (1.0 - g * g),
        ], dim=-1)
        dc = dct * f
        dh = dgates[t] @ rwf.t()
    return dgates, dh, dc


def _kernel_seq_bwd(xproj, hprev, cprev, cseq, rw, dhseq, dhT, dcT):
    kernel = "lstm_seq_bwd"
    _check_kernel_dtype(kernel, xproj)
    T, b, n = _seq_dims(kernel, xproj, rw)
    dev = xproj.device
    seq = (T, b, n)
    _check_seq_operands(kernel, dev, (
        ("xproj", xproj, (T, b, 4 * n)), ("hprev", hprev, seq),
        ("cprev", cprev, seq), ("cseq", cseq, seq), ("rw", rw, (n, 4 * n)),
        ("dhseq", dhseq, seq), ("dhT", dhT, (b, n)), ("dcT", dcT, (b, n))))
    _check_int32(kernel, xproj)

    def launch(plan, count=True):
        dgates = torch.empty((T, b, 4 * n), dtype=torch.float32, device=dev)
        dh0 = torch.empty((b, n), dtype=torch.float32, device=dev)
        dc0 = torch.empty_like(dh0)
        bar, cluster, rows = _route_args(plan, dev)
        rc = _build.load().dl4j_lstm_seq_bwd(
            xproj.data_ptr(), hprev.data_ptr(), cprev.data_ptr(),
            cseq.data_ptr(), rw.data_ptr(), dhseq.data_ptr(), dhT.data_ptr(),
            dcT.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), None if bar is None else bar.data_ptr(), T, b, n,
            cluster, rows, _build.current_stream_handle(dev))
        _build.check(rc, kernel)
        if count:
            dispatch.note_launch(kernel)
        return dgates, dh0, dc0
    return launch(_seq_plan(kernel, T, b, n, True, launch))


def lstm_seq_bwd(xproj, hprev, cprev, cseq, rw, dhseq, dhT, dcT):
    """The whole-sequence backward in one launch for a CUDA ``xproj``
    (the plain loop for a CPU one): ``(dgates, dh0, dc0)``. ``hprev`` /
    ``cprev`` are h_{t-1} / c_{t-1} for t = 0 .. T-1."""
    if dispatch.is_kernel_tensor(xproj):
        return _kernel_seq_bwd(xproj, hprev, cprev, cseq, rw, dhseq, dhT,
                               dcT)
    return lstm_seq_bwd_reference(xproj, hprev, cprev, cseq, rw, dhseq, dhT,
                                  dcT)


def lstm_seq_plan(b: int, n: int, bwd: bool = False, T: int = 1) -> dict:
    """How the card would launch a sequence kernel at (T, b, n): the
    route (``lstm_seq_route``) and, on the cluster route, its plan, one
    block's shared memory as the C source reckons it and the clusters
    the card holds at once; on the grid route, the grid and whether RW's
    columns stay resident in shared memory. Builds the kernels; needs a
    card."""
    route = lstm_seq_route(T, b, n, bwd)
    lib = _build.load()
    if route.route == "cluster":
        smem, active = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.dl4j_lstm_cluster_plan(int(bwd), int(b), int(n),
                                        route.cluster, route.rows,
                                        ctypes.byref(smem),
                                        ctypes.byref(active))
        _build.check(rc, "lstm_seq_plan")
        return {"route": "cluster", "cluster": route.cluster,
                "rows": route.rows, "clusters": route.clusters,
                "smem_bytes": smem.value, "max_active_clusters": active.value}
    grid, resident = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.dl4j_lstm_seq_plan(int(bwd), int(b), int(n), ctypes.byref(grid),
                                ctypes.byref(resident))
    _build.check(rc, "lstm_seq_plan")
    return {"route": "grid", "grid": grid.value,
            "resident": bool(resident.value)}


class _SequenceFn(torch.autograd.Function):
    """The whole-sequence LSTM with the JAX custom_vjp's backward."""

    @staticmethod
    def forward(ctx, xproj, h0, c0, rw):
        hseq, cseq, hT, cT = lstm_seq_fwd(xproj, h0, c0, rw, save_cseq=True)
        ctx.save_for_backward(xproj, h0, c0, rw, hseq, cseq)
        return hseq, hT, cT

    @staticmethod
    def backward(ctx, dhseq, dhT, dcT):
        xproj, h0, c0, rw, hseq, cseq = ctx.saved_tensors
        T, b, four_n = (int(v) for v in xproj.shape)
        n = four_n // 4
        f32 = torch.float32
        hprev = torch.cat([h0[None].to(hseq.dtype), hseq[:-1]]).contiguous()
        cprev = torch.cat([c0[None].to(cseq.dtype), cseq[:-1]]).contiguous()
        dgates, dh0, dc0 = lstm_seq_bwd(
            xproj, hprev, cprev, cseq, rw, dhseq.contiguous(),
            dhT.to(f32).contiguous(), dcT.to(f32).contiguous())
        drw = None
        if ctx.needs_input_grad[3]:
            # the weight gradient: one matmul over the whole sequence
            drw = torch.matmul(hprev.reshape(T * b, n).t().to(dgates.dtype),
                               dgates.reshape(T * b, four_n)).to(rw.dtype)
        return (dgates.to(xproj.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype),
                drw)


def lstm_sequence(xproj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  rw: torch.Tensor):
    """Whole-sequence fused LSTM (no peephole, no mask): xproj ``[T, b,
    4n]`` (``x @ W + b`` precomputed), h0 / c0 ``[b, n]``, rw ``[n, 4n]``.
    Returns ``(h_seq [T, b, n], hT, cT)``, differentiable in all four
    inputs. Without a gradient it runs the c_seq-free forward."""
    _seq_dims("lstm_sequence", xproj, rw)
    if not wants_grad(xproj, h0, c0, rw):
        hseq, _, hT, cT = lstm_seq_fwd(xproj, h0, c0, rw, save_cseq=False)
        return hseq, hT, cT
    return _SequenceFn.apply(xproj, h0, c0, rw)

"""The H100's budgets, and every plan each tuned kernel can launch.

Counterpart of ``deeplearning4j_tpu/ops/tiling.py``, re-derived for
Hopper. The TPU module budgets VMEM and picks divisor blocks; here a
plan is bounded by a block's shared memory, the SM's register file and
the kernels' 32-bit offsets, and it names a kernel route with that
route's own knobs. One module owns those budgets and, for each tuned
family, three things:

- the **heuristic**: today's route function (``conv_block_route``,
  ``conv_bwd_data_route``, ``conv_bwd_w_route``, ``matmul_route``,
  ``lstm_cell_route``, ``lstm_seq_route``, left unchanged in their
  modules) with the split-K count of the C library's former rule
  (``plan_splits`` / ``plan_dw_splits``, now ``direct_splits`` and kin
  here, the one rule), written as a plan;
- the **candidates**: every plan the kernel takes at run time that fits
  the budgets. Search and heuristic share these formulas, so they never
  disagree about what fits: the heuristic's plan is always a candidate
  (``tests/test_torch_tiling.py``);
- a **cost prior**: the routes' own cost models (``_wide_cost``,
  ``_sums_per_staged``, the wave count of a grid), which the tuner
  (``ops/autotune.py``) ranks candidates by before it measures. A prior
  only orders the search; measurement decides.

A plan is a tuple whose first item is the route and whose other items
are ints, so that the tuner's cache stores it as JSON:

- ``conv_block``: ``("wide", tile_o, tile_px)`` or ``("direct", splits)``;
- ``conv_bwd_data``: ``("resident", group, tap_groups)`` or
  ``("gemm", splits)``;
- ``conv_bwd_w``: ``("image_resident", group, pixel_groups,
  images_per_chunk)`` (the chunks are its split of the batch) or
  ``("gemm", splits)``;
- ``matmul_block`` (and its residual variant): ``("wide", 1)``,
  ``("tiled", splits)`` or, at most ``SKINNY_MAX_M`` rows,
  ``("skinny", splits)``;
- ``lstm_cell``: ``("latency", rows, units, splits)`` or ``("slice",)``;
- ``lstm_seq_fwd`` / ``lstm_seq_bwd``: ``("cluster", blocks, rows)`` or
  ``("grid",)``.

Flash attention is not tuned: its tile (``FLASH_BLOCK_Q`` x
``FLASH_BLOCK_K``) is a compile-time constant of its kernel, so
``attention_candidates`` lists that one plan (ROADMAP.md §2 queues the
templated blocks).
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Sequence, Tuple

import torch

Plan = Tuple

# --- the card's budgets (NVIDIA H100 SXM) ----------------------------------

SM_COUNT = 132
BLOCK_SMEM_BYTES = 232_448  # a block's shared memory (227 KB, opt-in)
SM_SMEM_BYTES = 233_472  # an SM's shared memory for blocks (228 KB)
SM_THREADS = 2048
SM_REGISTERS = 65_536  # 32-bit registers an SM
THREAD_MAX_REGISTERS = 255
# the image-resident dW kernel's __launch_bounds__(384, 2): 65,536 /
# (2 x 384) registers a thread (csrc/conv_bwd.cu)
BWD_W_REGISTERS = 85
# the LSTM cell's latency route stays within the 48 KB a block takes
# without an opt-in (csrc/lstm_cell.cu kLatencySmemBytes)
CELL_SMEM_BYTES = 48 * 1024
# the sequence kernels' cluster blocks keep 1 KB of the block's most
# for the card (csrc/lstm_seq.cu kClusterSmemCap)
LSTM_CLUSTER_SMEM_CAP = BLOCK_SMEM_BYTES - 1024
# the flash kernel's budget: a block's most at 256 threads, half an SM
# less 1 KB at 128 (two blocks an SM)
FLASH_SMEM_BYTES = BLOCK_SMEM_BYTES
INT32_MAX = 2 ** 31 - 1

# --- split-K: the rule the C library applied before, now here ---------------
# (csrc/common.cuh: the grid's z extent). A reduction of k_len is cut
# into `splits` chunks of k_chunk_for(k_len, splits), a multiple of the
# kernels' 16-deep k slice, when the output has too few tiles to keep
# TARGET_BLOCKS blocks in flight; the dW GEMM cuts its n * oh * ow
# reduction the same way, each chunk at least MIN_R_PER_SPLIT deep.
TARGET_BLOCKS = 2 * SM_COUNT
MIN_K_PER_SPLIT = 64
SKINNY_MIN_K_PER_SPLIT = 32  # the skinny route's chunks read w alone
MAX_SPLITS = 32
K_SLICE = 16
MIN_R_PER_SPLIT = 128
MAX_DW_SPLITS = 1024
GEMM_TILE = 64  # the direct / gemm / tiled routes' 64 x 64 output tile
# the split counts a search tries beside the heuristic's (normalised to
# the counts the chunking can give: no empty chunk)
SPLIT_OPTIONS = (1, 2, 4, 8, 16, 32)
DW_SPLIT_OPTIONS = (1, 4, 16, 64, 256, 1024)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_chunk_for(k_len: int, splits: int) -> int:
    return _cdiv(_cdiv(k_len, splits), K_SLICE) * K_SLICE


def chunks_of(k_len: int, splits: int) -> int:
    """The chunks a reduction of ``k_len`` cut ``splits`` ways makes
    (the kernels' grid z)."""
    return _cdiv(k_len, k_chunk_for(k_len, splits))


def plan_splits(tiles: int, k_len: int,
                min_k: int = MIN_K_PER_SPLIT) -> int:
    """The split-K count for ``tiles`` output tiles over a reduction of
    ``k_len`` (``csrc/common.cuh``'s former ``plan_splits``), each chunk
    at least ``min_k`` deep."""
    if tiles >= TARGET_BLOCKS or k_len < 2 * min_k:
        return 1
    s = max(1, min(_cdiv(TARGET_BLOCKS, tiles), k_len // min_k, MAX_SPLITS))
    return chunks_of(k_len, s)


def plan_dw_splits(tiles: int, r_len: int) -> int:
    """The dW GEMM's split count (``csrc/common.cuh``'s former
    ``plan_dw_splits``): about two waves of blocks, each chunk at least
    MIN_R_PER_SPLIT deep, at most MAX_DW_SPLITS."""
    if tiles >= TARGET_BLOCKS or r_len < 2 * MIN_R_PER_SPLIT:
        return 1
    s = max(1, min(_cdiv(TARGET_BLOCKS, tiles), r_len // MIN_R_PER_SPLIT,
                   MAX_DW_SPLITS))
    return chunks_of(r_len, s)


def split_ok(k_len: int, splits: int, cap: int = MAX_SPLITS) -> bool:
    """Whether the kernels take ``splits`` over ``k_len``: 1, or up to
    ``cap`` chunks none of which is empty."""
    return splits == 1 or (1 < splits <= cap and k_len > 0
                           and chunks_of(k_len, splits) == splits)


def check_splits(kernel: str, k_len: int, splits: int,
                 cap: int = MAX_SPLITS) -> None:
    """Raise unless the kernels take ``splits`` over ``k_len``."""
    if not split_ok(k_len, splits, cap):
        raise ValueError(f"{kernel}: {splits} splits of a {k_len}-deep "
                         f"reduction is outside the kernel's range (1, or "
                         f"2..{cap} non-empty chunks)")


def _split_choices(k_len: int, heuristic: int, options, cap) -> List[int]:
    out = {heuristic}
    for s in options:
        if s <= cap and k_len >= s:
            out.add(chunks_of(k_len, s) if s > 1 else 1)
    return sorted(v for v in out if split_ok(k_len, v, cap))


def direct_tiles(n: int, o: int, oh: int, ow: int) -> int:
    return _cdiv(n * oh * ow, GEMM_TILE) * _cdiv(o, GEMM_TILE)


def direct_splits(n: int, c: int, o: int, kh: int, kw: int, oh: int,
                  ow: int) -> int:
    """The conv forward's direct route split count."""
    return plan_splits(direct_tiles(n, o, oh, ow), c * kh * kw)


def data_tiles(n: int, c: int, h: int, w: int) -> int:
    return _cdiv(n * h * w, GEMM_TILE) * _cdiv(c, GEMM_TILE)


def data_splits(n: int, c: int, h: int, w: int, o: int, kh: int,
                kw: int) -> int:
    """The dx implicit GEMM's split count."""
    return plan_splits(data_tiles(n, c, h, w), o * kh * kw)


def weight_tiles(c: int, o: int, kh: int, kw: int) -> int:
    return _cdiv(c * kh * kw, GEMM_TILE) * _cdiv(o, GEMM_TILE)


def weight_splits(n: int, c: int, o: int, kh: int, kw: int, oh: int,
                  ow: int) -> int:
    """The dW implicit GEMM's split count."""
    return plan_dw_splits(weight_tiles(c, o, kh, kw), n * oh * ow)


def matmul_tiles(m: int, n: int) -> int:
    return _cdiv(m, GEMM_TILE) * _cdiv(n, GEMM_TILE)


def matmul_splits(m: int, k: int, n: int) -> int:
    """The dense kernel's tiled route split count."""
    return plan_splits(matmul_tiles(m, n), k)


def skinny_blocks(n: int) -> int:
    return _cdiv(n, _mod("matmul_block").SKINNY_COLS)


def skinny_splits(m: int, k: int, n: int) -> int:
    """The dense kernel's skinny route split count: the tiled rule's two
    waves of blocks, each chunk at least SKINNY_MIN_K_PER_SPLIT deep.
    Fitted to ``scripts/torch_dense_m1_ab.py`` on an H100 80GB HBM3 at
    700 W: AlexNet's 4096-column layers at m 1 fastest at 16 splits (17
    by this rule; 32 was 10% slower), LeNet's 500 columns at 25 (chunks
    of 32) and a sampler's 768 at 32."""
    return plan_splits(skinny_blocks(n), k, SKINNY_MIN_K_PER_SPLIT)


def fits_registers(threads: int, regs_per_thread: int,
                   blocks: int = 1) -> bool:
    return (regs_per_thread <= THREAD_MAX_REGISTERS
            and blocks * threads * regs_per_thread <= SM_REGISTERS)


def _waves(blocks: int, per_sm: int) -> int:
    """Rounds of ``SM_COUNT`` x ``per_sm`` slots a grid of ``blocks``
    takes."""
    return _cdiv(max(blocks, 1), SM_COUNT * max(per_sm, 1))


def _gemm_prior(tiles: int, k_len: int, splits: int, out_numel: int
                ) -> float:
    """A 64 x 64 tiled route's wave-quantised multiply-adds (two blocks
    an SM), plus the finish pass's reads of the partial sums."""
    chunk = k_chunk_for(k_len, splits)
    work = _waves(tiles * splits, 2) * GEMM_TILE * GEMM_TILE * chunk
    return float(work + (out_numel * splits if splits > 1 else 0))


def _mod(name: str):
    return importlib.import_module(f"deeplearning4j_tpu_torch.ops.{name}")


def _conv_dims(h, w, kh, kw, stride, padding):
    cb = _mod("conv_block")
    (sh, sw), (ph, pw) = cb._pair(stride), cb._pair(padding)
    return (cb.conv_output_size(h, kh, sh, ph),
            cb.conv_output_size(w, kw, sw, pw))


# --- conv forward -------------------------------------------------------------


def conv_fwd_heuristic(n, c, h, w, o, kh, kw, stride=(1, 1),
                       padding=(0, 0), dtype=None) -> Plan:
    """``conv_block_route``'s plan (with the direct route's split
    count)."""
    cb = _mod("conv_block")
    route = cb.conv_block_route(n, c, h, w, o, kh, kw, cb._pair(stride),
                                cb._pair(padding),
                                torch.float32 if dtype is None else dtype)
    if route.route == "wide":
        return ("wide", route.tile_o, route.tile_px)
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    return ("direct", direct_splits(n, c, o, kh, kw, oh, ow))


def conv_fwd_candidates(n, c, h, w, o, kh, kw, stride=(1, 1),
                        padding=(0, 0)) -> List[Plan]:
    """Every wide tile whose ring and tap table fit a block (where the
    tap table's offsets fit int32), then the direct route at each split
    count it takes."""
    cb = _mod("conv_block")
    ph = cb._pair(padding)[0]
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    k_len = c * kh * kw
    k_pad = _cdiv(k_len, cb.WIDE_K_SLICE) * cb.WIDE_K_SLICE
    out: List[Plan] = []
    if h + ph < cb.WIDE_PAD_TAP and c * h * w < 2 ** 31:
        out += [("wide", t[0], t[1]) for t in cb.WIDE_TILES
                if cb.conv_wide_smem_bytes(*t, k_pad) <= BLOCK_SMEM_BYTES]
    heur = direct_splits(n, c, o, kh, kw, oh, ow)
    out += [("direct", s) for s in
            _split_choices(k_len, heur, SPLIT_OPTIONS, MAX_SPLITS)]
    return out


def conv_fwd_prior(plan: Plan, n, c, h, w, o, kh, kw, stride=(1, 1),
                   padding=(0, 0)) -> float:
    cb = _mod("conv_block")
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    k_len = c * kh * kw
    if plan[0] == "wide":
        k_pad = _cdiv(k_len, cb.WIDE_K_SLICE) * cb.WIDE_K_SLICE
        return float(cb._wide_cost((plan[1], plan[2]), n * oh * ow, o,
                                   k_pad)[0])
    return _gemm_prior(direct_tiles(n, o, oh, ow), k_len, plan[1],
                       n * o * oh * ow)


# --- conv backward-data -----------------------------------------------------


def conv_bwd_data_heuristic(n, c, h, w, o, kh, kw, stride=(1, 1),
                            padding=(0, 0)) -> Plan:
    cb = _mod("conv_block")
    route = cb.conv_bwd_data_route(n, c, h, w, o, kh, kw, stride, padding)
    if route.route == "resident":
        return ("resident", route.group, route.tap_groups)
    return ("gemm", data_splits(n, c, h, w, o, kh, kw))


def _channel_groups(c: int, most: int) -> List[int]:
    """The distinct groups ``ceil(c / g)`` of at most ``most`` channels,
    largest first (the route rules' own group sizes)."""
    seen = []
    for g in range(_cdiv(c, most), c + 1):
        group = _cdiv(c, g)
        if group not in seen:
            seen.append(group)
    return seen


def conv_bwd_data_candidates(n, c, h, w, o, kh, kw, stride=(1, 1),
                             padding=(0, 0)) -> List[Plan]:
    """The resident route at each channel group whose working set fits a
    block (with as many tap groups as then fit), then the implicit GEMM
    at each split count it takes."""
    cb = _mod("conv_block")
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    out: List[Plan] = []
    for group in _channel_groups(c, cb.RESIDENT_MAX_GROUP):
        if (cb.resident_smem_bytes(h, w, o, oh, ow, kh, kw, group)
                > BLOCK_SMEM_BYTES or _cdiv(c, group) > 65535):
            continue
        plan = cb._resident_plan(h, w, o, oh, ow, kh, kw, group)
        if plan.smem_bytes <= BLOCK_SMEM_BYTES:
            out.append(("resident", group, plan.tap_groups))
    heur = data_splits(n, c, h, w, o, kh, kw)
    out += [("gemm", s) for s in
            _split_choices(o * kh * kw, heur, SPLIT_OPTIONS, MAX_SPLITS)]
    return out


def conv_bwd_data_prior(plan: Plan, n, c, h, w, o, kh, kw, stride=(1, 1),
                        padding=(0, 0)) -> float:
    cb = _mod("conv_block")
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    if plan[0] == "resident":
        group, tap_groups = plan[1], plan[2]
        smem = cb.resident_smem_bytes(h, w, o, oh, ow, kh, kw, group,
                                      tap_groups)
        per_sm = max(1, SM_SMEM_BYTES // (smem + 1024))
        blocks = n * _cdiv(c, group)
        sums = group * oh * ow * kh * kw * o
        # a block that does few sums a staged float waits on its staging
        staged = cb._sums_per_staged(group, o, oh, ow, kh * kw)
        return float(_waves(blocks, per_sm) * sums
                     * (1.0 + cb.RESIDENT_OVERLAP_SUMS / max(staged, 1e-9)))
    return _gemm_prior(data_tiles(n, c, h, w), o * kh * kw, plan[1],
                       n * c * h * w)


# --- conv backward-weights --------------------------------------------------


def conv_bwd_w_heuristic(n, c, h, w, o, kh, kw, stride=(1, 1),
                         padding=(0, 0)) -> Plan:
    cb = _mod("conv_block")
    route = cb.conv_bwd_w_route(n, c, h, w, o, kh, kw, stride, padding)
    if route.route == "image_resident":
        return ("image_resident", route.group, route.pixel_groups,
                route.images_per_chunk)
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    return ("gemm", weight_splits(n, c, o, kh, kw, oh, ow))


def _image_resident_plan(n, c, h, w, o, oh, ow, k, group
                         ) -> Optional[Plan]:
    """The image-resident plan at ``group`` channels a block, by the
    route's own rules for its pixel groups and chunks (None where the
    group does not fit)."""
    cb = _mod("conv_block")
    items = _cdiv(o, 4) * k * group
    if (items > cb.BWD_W_MAX_THREADS
            or cb.bwd_w_smem_bytes(h, w, o, oh, ow, k, group)
            > BLOCK_SMEM_BYTES or _cdiv(c, group) > 65535):
        return None
    pixel_groups = max(p for p in range(1, oh + 1) if oh % p == 0
                       and items * p <= cb.BWD_W_MAX_THREADS
                       and cb.bwd_w_smem_bytes(h, w, o, oh, ow, k, group, p)
                       <= BLOCK_SMEM_BYTES)
    threads = _cdiv(items * pixel_groups, 32) * 32
    if not fits_registers(threads, BWD_W_REGISTERS):
        return None
    smem = cb.bwd_w_smem_bytes(h, w, o, oh, ow, k, group, pixel_groups)
    per_sm = max(1, min(SM_SMEM_BYTES // (smem + 1024),
                        SM_THREADS // threads,
                        SM_REGISTERS // (BWD_W_REGISTERS * threads)))
    chunks = max(1, min(n, _cdiv(SM_COUNT * per_sm, _cdiv(c, group)),
                        cb.BWD_W_MAX_SCRATCH // (4 * o * c * k * k)))
    return ("image_resident", group, pixel_groups, _cdiv(n, chunks))


def conv_bwd_w_candidates(n, c, h, w, o, kh, kw, stride=(1, 1),
                          padding=(0, 0)) -> List[Plan]:
    """The image-resident route (square kernels up to BWD_W_MAX_K) at
    each channel group whose items and two staged images fit a block,
    then the implicit GEMM at each split count it takes."""
    cb = _mod("conv_block")
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    out: List[Plan] = []
    per_channel = _cdiv(o, 4) * kw
    if (kh == kw and kw <= cb.BWD_W_MAX_K
            and per_channel <= cb.BWD_W_MAX_THREADS
            and n * c * h * w <= INT32_MAX and n * o * oh * ow <= INT32_MAX):
        for group in _channel_groups(c, cb.BWD_W_MAX_THREADS // per_channel):
            plan = _image_resident_plan(n, c, h, w, o, oh, ow, kw, group)
            if plan is not None:
                out.append(plan)
    heur = weight_splits(n, c, o, kh, kw, oh, ow)
    out += [("gemm", s) for s in _split_choices(
        n * oh * ow, heur, DW_SPLIT_OPTIONS, MAX_DW_SPLITS)]
    return out


def conv_bwd_w_prior(plan: Plan, n, c, h, w, o, kh, kw, stride=(1, 1),
                     padding=(0, 0)) -> float:
    oh, ow = _conv_dims(h, w, kh, kw, stride, padding)
    macs = n * oh * ow * o * c * kh * kw
    if plan[0] == "image_resident":
        group, per_chunk = plan[1], plan[3]
        blocks = _cdiv(c, group) * _cdiv(n, per_chunk)
        # two blocks an SM (the kernel's launch bounds)
        return float(_waves(blocks, 2) * macs / blocks)
    return _gemm_prior(weight_tiles(c, o, kh, kw), n * oh * ow, plan[1],
                       o * c * kh * kw)


# --- the dense kernel -------------------------------------------------------


def matmul_heuristic(m: int, k: int, n: int) -> Plan:
    route = _mod("matmul_block").matmul_route(m, n)
    if route == "wide":
        return ("wide", 1)
    if route == "skinny":
        return ("skinny", skinny_splits(m, k, n))
    return ("tiled", matmul_splits(m, k, n))


def matmul_candidates(m: int, k: int, n: int) -> List[Plan]:
    """The wide route (it takes any shape; it never splits), the tiled
    route at each split count it takes, and, at most ``SKINNY_MAX_M``
    rows, the skinny route at each of its split counts."""
    plans = [("wide", 1)] + [("tiled", s) for s in
                             _split_choices(k, matmul_splits(m, k, n),
                                            SPLIT_OPTIONS, MAX_SPLITS)]
    if m <= _mod("matmul_block").SKINNY_MAX_M:
        plans += [("skinny", s) for s in
                  _split_choices(k, skinny_splits(m, k, n), SPLIT_OPTIONS,
                                 MAX_SPLITS)]
    return plans


def matmul_prior(plan: Plan, m: int, k: int, n: int) -> float:
    mb = _mod("matmul_block")
    if plan[0] == "wide":
        to, tn = mb.WIDE_TILE
        return float(_waves(_cdiv(m, to) * _cdiv(n, tn), 1) * to * tn * k)
    if plan[0] == "skinny":
        # a block's columns times its chunk, four rows' worth of work
        # (it reads w once; its rows are registers), eight blocks an SM
        chunk = k_chunk_for(k, plan[1])
        work = (_waves(skinny_blocks(n) * plan[1], 8) * mb.SKINNY_COLS
                * chunk * 4)
        return float(work + (m * n * plan[1] if plan[1] > 1 else 0))
    return _gemm_prior(matmul_tiles(m, n), k, plan[1], m * n)


# --- the LSTM cell ----------------------------------------------------------

CELL_ROW_OPTIONS = (1, 2, 4, 8, 16, 32)
CELL_UNIT_OPTIONS = (1, 2, 4, 8)


def lstm_cell_heuristic(b: int, n: int) -> Plan:
    lc = _mod("lstm_cell")
    r = lc.lstm_cell_route(b, n)
    if r.route == "latency":
        return ("latency", r.rows, r.units, r.splits)
    return ("slice",)


def lstm_cell_candidates(b: int, n: int) -> List[Plan]:
    """The latency route at each (rows, units) whose h rows and RW
    columns fit CELL_SMEM_BYTES (the depth splits by the route's own
    rule), then the slice route."""
    lc = _mod("lstm_cell")
    out: List[Plan] = []
    rows_set = sorted({r for r in CELL_ROW_OPTIONS if r <= b}
                      | {min(b, lc.CELL_ROWS)})
    for rows in rows_set:
        for units in CELL_UNIT_OPTIONS:
            p = lc.latency_plan(b, n, rows, units)
            if (p.smem_bytes <= CELL_SMEM_BYTES and p.row_blocks <= 65535
                    and rows * units * p.splits <= lc.CELL_MAX_THREADS):
                out.append(("latency", rows, units, p.splits))
    return out + [("slice",)]


def lstm_cell_prior(plan: Plan, b: int, n: int) -> float:
    macs = 4 * b * n * n
    if plan[0] == "latency":
        _, rows, units, splits = plan
        blocks = _cdiv(n, units) * _cdiv(b, rows)
        per_sm = max(1, min(SM_THREADS // 256,
                            SM_SMEM_BYTES // (
                                _mod("lstm_cell").lstm_cell_smem_bytes(
                                    n, rows, units) + 1024)))
        return float(_waves(blocks, per_sm) * macs / blocks)
    return float(_waves(_cdiv(n, 8), 8) * macs / _cdiv(n, 8))


# --- the sequence kernels ---------------------------------------------------


def lstm_seq_heuristic(T: int, b: int, n: int, bwd: bool) -> Plan:
    lc = _mod("lstm_cell")
    r = lc.lstm_seq_route(T, b, n, bwd)
    if r.route == "cluster":
        return ("cluster", r.cluster, r.rows)
    return ("grid",)


def lstm_seq_candidates(T: int, b: int, n: int, bwd: bool) -> List[Plan]:
    """The cluster route at each cluster size whose blocks hold RW's
    columns (every block at least one unit, at most
    LSTM_CLUSTER_MAX_UNITS) and each rows a cluster its threads and
    shared memory take, then the cooperative grid route."""
    lc = _mod("lstm_cell")
    out: List[Plan] = []
    if n <= lc.LSTM_THREADS:
        for blocks in range(1, lc.LSTM_CLUSTER + 1):
            u = _cdiv(n, blocks)
            if u > lc.LSTM_CLUSTER_MAX_UNITS or (blocks - 1) * u >= n:
                continue
            for rows in lc.LSTM_CLUSTER_ROWS:
                if (rows * u <= lc.LSTM_THREADS
                        and lc.lstm_cluster_smem_bytes(n, blocks, rows, bwd)
                        <= LSTM_CLUSTER_SMEM_CAP):
                    out.append(("cluster", blocks, rows))
    return out + [("grid",)]


def lstm_seq_prior(plan: Plan, T: int, b: int, n: int, bwd: bool) -> float:
    lc = _mod("lstm_cell")
    macs = T * 4 * b * n * n * (2 if bwd else 1)
    if plan[0] == "cluster":
        _, blocks, rows = plan
        clusters = _cdiv(b, rows)
        slots = max(1, SM_COUNT // blocks)
        return float(_cdiv(clusters, slots) * macs / clusters)
    return float(macs / min(SM_COUNT, _cdiv(n, 8)))


# --- attention (not tuned) --------------------------------------------------


def attention_candidates(t: int, d: int, element_size: int = 4
                         ) -> List[Tuple[int, int]]:
    """The flash kernel's one tile, (FLASH_BLOCK_Q, FLASH_BLOCK_K): its
    blocks are compile-time constants, so there is nothing to search
    until they are templated (ROADMAP.md §2)."""
    fa = _mod("flash_attention")
    fa.flash_smem_plan(d, element_size)  # raises outside the kernel's d
    return [(fa.FLASH_BLOCK_Q, fa.FLASH_BLOCK_K)]


# --- the families, for the tuner and the tests --------------------------------

FAMILIES = {
    "conv_block": (conv_fwd_heuristic, conv_fwd_candidates, conv_fwd_prior),
    "conv_bwd_data": (conv_bwd_data_heuristic, conv_bwd_data_candidates,
                      conv_bwd_data_prior),
    "conv_bwd_w": (conv_bwd_w_heuristic, conv_bwd_w_candidates,
                   conv_bwd_w_prior),
    "matmul_block": (matmul_heuristic, matmul_candidates, matmul_prior),
    "lstm_cell": (lstm_cell_heuristic, lstm_cell_candidates,
                  lstm_cell_prior),
    "lstm_seq": (lstm_seq_heuristic, lstm_seq_candidates, lstm_seq_prior),
}


def plan_tag(plan: Sequence) -> str:
    """A plan as one string, e.g. ``wide:96x256`` (``grid`` without
    knobs)."""
    knobs = "x".join(str(int(v)) for v in plan[1:])
    return f"{plan[0]}:{knobs}" if knobs else str(plan[0])

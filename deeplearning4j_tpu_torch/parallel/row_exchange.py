"""The row exchange of a table whose rows are sharded over the ranks,
built from ``all_reduce`` alone.

Counterpart of what GSPMD inserts around the JAX trainer's
``P("data", None)`` embedding table (``deeplearning4j_tpu/parallel/
trainer.py`` ``_row_sharded_embedding_param``). Rank ``i`` of ``N``
holds rows ``[i·V/N, (i+1)·V/N)`` of a ``[V, D]`` table (the layout of
``embeddings/table.py``). Gloo has ``all_reduce`` on CUDA tensors but
no ``all_gather``, so every exchange here is one ``all_reduce`` of a
``[N, ...]`` buffer in which each rank wrote its own slot and left the
others at ``-0.0`` (``stack_ranks``). The sum is exact: ``x + (-0.0)``
is ``x`` for every float ``x``, signed zeros, infinities and NaN
included, whatever the order of the additions. So an NCCL world and a
gloo world of several ranks on one card both run it, bit for bit the
same.

- ``gather_rows``: the rows a rank's ids name, from their owners
  (differentiable). Forward: the ids of every rank are stacked, each
  rank writes the rows it owns into their slots, one sum gives every
  rank the rows: bitwise the unsharded gather. Backward: each rank's
  row gradients are stacked the same way, and each owner folds every
  occurrence of its rows (duplicates summed by ``embeddings/sparse.py``
  ``dedup_segment_sum``, so a Zipf batch's hot rows take one add each)
  into a dense ``[V/N, D]`` gradient of its shard.
- ``gather_table`` / ``shard_rows``: the whole table from its shards
  (a checkpoint's layout) and a rank's shard of a whole table.
- ``sum_ranks``: a differentiable sum over the ranks (a shard's L1/L2
  penalty term, the batch statistics of a synchronous step).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.embeddings import sparse


def world() -> Tuple[int, int]:
    """``(ranks, this rank)`` of the default group, ``(1, 0)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def stack_ranks(local: torch.Tensor, n: int, rank: int,
                group=None) -> torch.Tensor:
    """Every rank's ``local`` (the same shape and dtype on each rank)
    as one ``[n, *local.shape]`` tensor on every rank: slot ``rank``
    written here, the others ``-0.0`` (0 for integers), one
    ``all_reduce`` over ``group`` (default: the default group; ``n``
    and ``rank`` are within it) sums. Exact (module docstring)."""
    if n == 1:
        return local.unsqueeze(0)
    fill = -0.0 if local.is_floating_point() else 0
    buf = torch.full((n, *local.shape), fill, dtype=local.dtype,
                     device=local.device)
    buf[rank] = local
    dist.all_reduce(buf, group=group)
    return buf


class _SumRanks(torch.autograd.Function):
    """Sum over the ranks, differentiable: the gradient of each rank's
    input is the sum over the ranks of the output's gradients (the loss
    is the sum of the ranks' weighted losses)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (default: the default
    group), on every rank; its gradient is the ranks' gradients summed
    (``_SumRanks``)."""
    return _SumRanks.apply(t, group)


def _owned_rows(shard: torch.Tensor, ids: torch.Tensor, rank: int):
    """``(owned [..], local row [..])`` of ids against this rank's
    shard."""
    rows = shard.shape[0]
    local = ids - rank * rows
    owned = (local >= 0) & (local < rows)
    return owned, local.clamp(0, rows - 1)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, ids, n, rank):
        all_ids = stack_ranks(ids, n, rank)                   # [n, m]
        owned, local = _owned_rows(shard, all_ids, rank)
        mine = torch.where(owned[..., None], shard[local],
                           shard.new_full((), -0.0))          # [n, m, D]
        if n > 1:
            dist.all_reduce(mine)
        ctx.save_for_backward(all_ids)
        ctx.n, ctx.rank, ctx.rows = n, rank, shard.shape[0]
        return mine[rank]

    @staticmethod
    def backward(ctx, g):
        (all_ids,) = ctx.saved_tensors
        n, rank, rows = ctx.n, ctx.rank, ctx.rows
        d = g.shape[-1]
        all_g = stack_ranks(g.contiguous(), n, rank)          # [n, m, D]
        uids, summed, _ = sparse.dedup_segment_sum(
            all_ids.reshape(-1), all_g.reshape(-1, d))
        local = uids - rank * rows
        ok = (local >= 0) & (local < rows)
        upd = torch.where(ok[:, None], summed, summed.new_zeros(()))
        grad = g.new_zeros((rows, d)).index_add_(
            0, local.clamp(0, rows - 1), upd)
        return grad, None, None, None


def gather_rows(shard: torch.Tensor, ids: torch.Tensor, n: int,
                rank: int) -> torch.Tensor:
    """The ``[m, D]`` rows of the global table that this rank's ids
    ``[m]`` name (every rank passes the same ``m``), each from the rank
    that owns it; the gradient of the result reaches each owner's
    ``shard`` (``[V/n, D]``) as a dense gradient of its rows."""
    return _GatherRows.apply(shard, ids.reshape(-1).long(), n, rank)


def gather_table(shard: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """The whole ``[n·rows, ...]`` table from every rank's shard, on
    every rank, bit for bit (a collective)."""
    if n == 1:
        return shard.clone()
    return stack_ranks(shard, n, rank).reshape(n * shard.shape[0],
                                              *shard.shape[1:])


def shard_rows(full: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s rows ``[rank·V/n, (rank+1)·V/n)`` of ``full``
    (a copy: nothing else of the table stays referenced)."""
    rows = full.shape[0] // n
    return full[rank * rows:(rank + 1) * rows].clone()


class RankSplit(sparse.BatchSplit):
    """A batch split over the ``n`` ranks of the default group: rank
    ``r`` computes the contiguous rows ``[r·B/n, (r+1)·B/n)`` of every
    ``[B, ...]`` batch array (``B`` a multiple of ``n``), and the row
    gradients of every rank come back through ``stack_ranks``, each part
    laid out as one process lays it out (rank 0's rows, then rank 1's,
    ...), so every rank folds the same global occurrence list in the
    same order into its replica. The unmasked count is summed over the
    ranks (an exact integer), the loss too."""

    def __init__(self, n: int, rank: int):
        self.n, self.rank = int(n), int(rank)

    def rows(self, a):
        m = a.shape[0] // self.n
        return a[self.rank * m:(self.rank + 1) * m]

    def _sum(self, t):
        t = t.reshape(1).clone()
        dist.all_reduce(t)
        return t[0]

    def count(self, mask):
        return self._sum(mask.sum()).clamp_min(1.0)

    def total(self, loss):
        return self._sum(loss)

    def occurrences(self, *parts):
        ids, grads = [], []
        for i, g in parts:
            ids.append(stack_ranks(i.contiguous(), self.n,
                                   self.rank).reshape(-1))
            g = g.reshape(i.numel(), *g.shape[i.dim():]).contiguous()
            grads.append(stack_ranks(g, self.n, self.rank).reshape(
                -1, *g.shape[1:]))
        return torch.cat(ids), torch.cat(grads)

"""Sparse embedding-gradient machinery: gradients with respect to the
gathered rows, duplicate ids folded by sort and segment sum.

Counterpart of ``deeplearning4j_tpu/embeddings/sparse.py``. The
gradient is taken with respect to the GATHERED rows only (batch-sized,
never ``[V, D]``), duplicate ids are folded into one summed row per
unique id, and the update adds those rows back to the table.

The fold is bitwise repeatable on every device. A Zipf corpus sends
tens of thousands of updates a batch into the most frequent rows, and
``index_add_`` on CUDA sums duplicates with atomics in no fixed order.
Here the occurrences are sorted by id (a stable sort) and summed by a
segmented inclusive scan whose association is fixed by the positions
alone (Hillis-Steele inside chunks of 32 rows, then over the chunks:
five elementwise passes over the rows), so every duplicate group adds
in the same tree on every run. The row update
then adds one summed row per id; the other positions of its group add
exact ``+0.0`` to the same row, and a float plus ``+0.0`` does not
depend on the order of the additions. Shapes stay static (``N`` slots,
no host synchronisation), as in the JAX package.

Everything here is plain tensor math with no collective; the
rank-aware exchange lives in ``embeddings/table.py``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

#: Sentinel id of the padded slots of a deduplicated id vector.
#: Negative, so no shard ever owns it.
PAD_ID = -1


#: Rows a chunk of the two-level segmented scan (``_segmented_scan``).
_SCAN_CHUNK = 32


def _local_scan(x: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum along dim 1 of ``x [m, c, ...]`` within
    runs of equal ``keys [m, c]`` (Hillis-Steele: ``log2(c)`` passes; the
    association depends on the positions only)."""
    c = x.shape[1]
    zero = x.new_zeros(())
    bcast = (slice(None), slice(None)) + (None,) * (x.dim() - 2)
    s = 1
    while s < c:
        same = (keys[:, s:] == keys[:, :-s])[bcast]
        y = torch.empty_like(x)
        y[:, :s] = x[:, :s]
        torch.add(x[:, s:], torch.where(same, x[:, :-s], zero),
                  out=y[:, s:])
        x = y
        s *= 2
    return x


def _segmented_scan(vals: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Inclusive sum of ``vals [N, ...]`` within runs of equal ``keys
    [N]`` (sorted, so a run is contiguous): position ``i`` ends up with
    the sum of its run up to ``i``, the last position of a run with the
    run's total. Two levels: a scan inside chunks of ``_SCAN_CHUNK``
    rows, then (recursively) over the chunks' last rows, whose running
    sums carry into the next chunk's head of the same run. The order of
    the additions depends on the positions only: repeatable bit for
    bit, in ``log2(chunk)`` passes over the rows instead of
    ``log2(N)``."""
    n = vals.shape[0]
    c = _SCAN_CHUNK
    if n <= c:
        return _local_scan(vals[None], keys[None])[0]
    m = -(-n // c)
    pad = m * c - n
    rest = vals.shape[1:]
    x = torch.cat([vals, vals.new_zeros((pad, *rest))]).reshape(m, c, *rest)
    k = torch.cat([keys, (keys[-1] + 1).expand(pad)]).reshape(m, c)
    local = _local_scan(x, k)
    carry = _segmented_scan(local[:, -1], k[:, -1])   # [m, ...]
    prev = torch.cat([carry.new_zeros((1, *rest)), carry[:-1]])
    prev_key = torch.cat([k[:1, 0] - 1, k[:-1, -1]])
    bcast = (slice(None), slice(None)) + (None,) * len(rest)
    cont = (k == prev_key[:, None])[bcast]
    out = local + torch.where(cont, prev[:, None], local.new_zeros(()))
    return out.reshape(m * c, *rest)[:n]


def sorted_row_sums(ids: torch.Tensor, grads: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sorted ids [N], run totals [N, D], last [N])``: the
    occurrences sorted by id (stable), each position holding the running
    sum of its id's rows; ``last`` marks the position that holds an id's
    total. Ids arrive in any integer dtype and are widened on their
    device."""
    ids = ids.reshape(-1).long()
    sid, order = torch.sort(ids, stable=True)
    sums = _segmented_scan(grads.index_select(0, order), sid)
    last = torch.ones_like(sid, dtype=torch.bool)
    last[:-1] = sid[1:] != sid[:-1]
    return sid, sums, last


def sgd_rows_(table: torch.Tensor, ids, grads, alpha) -> torch.Tensor:
    """``table[id] -= alpha * sum of the id's gradient rows``, in place,
    for occurrence lists ``ids [...]`` / ``grads [..., D]`` (the dense
    scatter-add semantics of the JAX steps, summed repeatably)."""
    d = table.shape[1:]
    sid, sums, last = sorted_row_sums(ids, grads.reshape(-1, *d))
    bcast = (slice(None),) + (None,) * len(d)
    upd = torch.where(last[bcast], sums * (-alpha), sums.new_zeros(()))
    table.index_add_(0, sid, upd.to(table.dtype))
    return table


def dedup_segment_sum(ids, grads):
    """Fold duplicate ids: ``(unique_ids, summed_grads, n_unique)``.

    ``ids``: int ``[N]``; ``grads``: ``[N, D]`` per-occurrence gradient
    rows. Fixed shapes (``[N]`` / ``[N, D]``): slot ``j < n_unique``
    holds the j-th unique id (ascending) and the sum of its
    occurrences' rows; slots ``>= n_unique`` hold ``PAD_ID`` and zeros.
    ``n_unique`` is a 0-d tensor on the ids' device. The result is a
    pure function of (ids, grads), whatever the world size."""
    n = ids.shape[0]
    sid, sums, last = sorted_row_sums(ids, grads)
    first = torch.ones_like(last)
    first[1:] = last[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    summed = torch.zeros_like(grads).index_add_(
        0, seg, torch.where(last[:, None], sums, sums.new_zeros(())))
    uids = torch.full((n,), PAD_ID, dtype=torch.long, device=sid.device)
    uids.scatter_(0, seg, sid)
    return uids, summed, first.sum()


def rows_grad(loss_of_rows: Callable, *rows):
    """``(loss, grads)`` of a scalar loss over GATHERED rows
    (``[B, D]``, ``[B, K, D]``, ...): autograd with respect to the rows,
    never through the table gather."""
    leaves = [r.detach().requires_grad_(True) for r in rows]
    with torch.enable_grad():
        loss = loss_of_rows(*leaves)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def flatten_occurrences(ids, grads):
    """Collapse leading batch dims: ``[..., D]`` gradient rows and
    matching ``[...]`` ids into flat ``[N]`` / ``[N, D]`` occurrence
    lists ready for :func:`dedup_segment_sum`."""
    d = grads.shape[-1]
    return ids.reshape(-1), grads.reshape(-1, d)


def apply_rows_dense(table, uids, summed, alpha):
    """Unsharded sparse SGD apply, in place: ``table[uid] -= alpha *
    summed[uid]`` for the deduplicated rows. ``PAD_ID`` slots add exact
    zeros at a clamped index. The single-process twin of the owner
    update in ``table.py``. Returns ``table``."""
    ok = (uids >= 0) & (uids < table.shape[0])
    idx = uids.clamp(0, table.shape[0] - 1)
    upd = torch.where(ok[:, None], summed * (-alpha),
                      summed.new_zeros(())).to(table.dtype)
    return table.index_add_(0, idx, upd)

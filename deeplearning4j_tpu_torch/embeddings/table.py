"""``ShardedEmbeddingTable``: embedding rows sharded over the ranks of
the data-parallel world, with a collective lookup and owner-only
sparse updates.

Counterpart of ``deeplearning4j_tpu/embeddings/table.py``. The JAX
package shards the rows ``P("data", None)`` over a device mesh; here
the mesh is the port's (``parallel/mesh.py``: one process a rank, NCCL
for a table on the card, gloo for one on the CPU), and rank ``i`` of
``N`` holds rows ``[i·V'/N, (i+1)·V'/N)`` of the table padded to
``V' = ceil(V/N)·N`` rows, and nothing else.

- **Lookup** gathers only OWNED rows on each rank (other ids give
  exact ``+0.0``) and sums over the ranks in one ``all_reduce``: every
  term but the owner's is ``+0.0``, so the result equals an unsharded
  gather bit for bit, in any order of summation and at any width.
- **Update** folds the per-occurrence gradients by id
  (``sparse.dedup_segment_sum``, replicated math: the same on every
  rank) and adds each deduplicated row on its owner only, so every row
  is rewritten once, by the rank that holds it, from world-independent
  arithmetic: a checkpoint written at one width resumes bitwise at
  another.

This module is the package's one collective site; Word2Vec and
DeepWalk compose the fused steps below. Batch math is replicated (ids
and gradients identical on every rank): the subsystem scales table
memory with the world, not batch compute. The JAX package's metric
instruments are plain counters here (``gauges()``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from deeplearning4j_tpu_torch.embeddings import sparse
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, build_mesh

# -- the gauges (plain counters) ----------------------------------------

_GAUGES: Dict[str, object] = {
    "embedding_shard_bytes": 0,      # table bytes on this rank
    "embedding_rows_touched": 0,     # unique rows of the last update
    "embedding_lookup_ms": [],       # lookup wall times, to completion
    "embedding_scatter_ms": [],      # sparse-update wall times
}


def gauges() -> dict:
    """A copy of the gauges (the JAX package's ``embedding_*``
    metrics)."""
    return {k: (list(v) if isinstance(v, list) else v)
            for k, v in _GAUGES.items()}


def note_shard_bytes(nbytes: int) -> None:
    _GAUGES["embedding_shard_bytes"] = int(nbytes)


def note_rows_touched(n: int) -> None:
    _GAUGES["embedding_rows_touched"] = int(n)


def note_lookup_ms(ms: float) -> None:
    _GAUGES["embedding_lookup_ms"].append(float(ms))


def note_scatter_ms(ms: float) -> None:
    _GAUGES["embedding_scatter_ms"].append(float(ms))


# -- per-rank primitives ---------------------------------------------------


def _owned(local_table, ids, rank: int):
    """``(local index, owned mask)`` of ``ids`` against this rank's
    rows."""
    shard = local_table.shape[0]
    local = ids.long() - rank * shard
    own = (local >= 0) & (local < shard)
    return local.clamp(0, shard - 1), own


def _exchange(rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.backend is not None and mesh.data > 1:
        dist.all_reduce(rows)
    return rows


def _local_rows(local_table, ids, rank: int):
    idx, own = _owned(local_table, ids, rank)
    return torch.where(own[..., None], local_table[idx],
                       local_table.new_zeros(()))


def owned_rows(local_table, ids, mesh: Mesh):
    """``table[ids]`` from the row shards: each rank gathers the rows it
    owns, masks the others to exact ``0.0``, and one ``all_reduce``
    sums over the ranks (bitwise the unsharded gather). ``ids`` may be
    any integer shape; the result appends the row dim."""
    return _exchange(_local_rows(local_table, ids, mesh.rank), mesh)


def _owned_rows_many(local_table, id_sets, mesh: Mesh) -> List[torch.Tensor]:
    """``owned_rows`` of several id tensors in ONE collective."""
    d = local_table.shape[1]
    parts = [_local_rows(local_table, ids.reshape(-1), mesh.rank)
             for ids in id_sets]
    flat = _exchange(torch.cat(parts), mesh)
    out, off = [], 0
    for ids in id_sets:
        n = ids.numel()
        out.append(flat[off:off + n].reshape(*ids.shape, d))
        off += n
    return out


def scatter_owned(local_table, uids, deltas, rank: int):
    """Add ``deltas[j]`` to row ``uids[j]`` on its owner only, in place.
    ``uids`` come from ``sparse.dedup_segment_sum`` (unique, ``PAD_ID``
    padding), so every row is rewritten at most once — no cross-rank
    accumulation and no collective."""
    idx, own = _owned(local_table, uids, rank)
    upd = torch.where(own[:, None], deltas, deltas.new_zeros(()))
    return local_table.index_add_(0, idx, upd.to(local_table.dtype))


def _sparse_apply_(local_table, ids, grads, alpha, rank: int):
    """Dedup (replicated) + owner scatter; returns the unique count (a
    0-d tensor)."""
    uids, summed, n = sparse.dedup_segment_sum(ids, grads)
    scatter_owned(local_table, uids, summed * (-alpha), rank)
    return n


def sg_ns_step(s0, s1n, centers, contexts, negs, mask, alpha, mesh: Mesh):
    """Fused skip-gram negative-sampling step over sharded syn0 /
    syn1neg, in place: collective lookup -> replicated loss and gradient
    over the GATHERED rows only (``nlp/word2vec.py``'s ``_ns_step_raw``
    objective, collision mask included) -> dedup -> owner scatter.
    Returns ``(loss, rows_touched)`` as 0-d tensors."""
    v, u_pos, u_neg = (
        _owned_rows_many(s0, [centers], mesh)
        + _owned_rows_many(s1n, [contexts, negs], mesh))
    nvalid = (negs != contexts[:, None]).to(v.dtype)

    def loss_fn(v_, up_, un_):
        pos = F.logsigmoid((v_ * up_).sum(-1))
        neg_dot = torch.bmm(un_, v_.unsqueeze(-1)).squeeze(-1)
        neg = (nvalid * F.logsigmoid(-neg_dot)).sum(-1)
        return -(mask * (pos + neg)).sum() / mask.sum().clamp_min(1.0)

    loss, (gv, gp, gn) = sparse.rows_grad(loss_fn, v, u_pos, u_neg)
    n0 = _sparse_apply_(s0, centers, gv, alpha, mesh.rank)
    ids1, rows1 = sparse.flatten_occurrences(
        torch.cat([contexts, negs.reshape(-1)]),
        torch.cat([gp, gn.reshape(-1, gn.shape[-1])]))
    n1 = _sparse_apply_(s1n, ids1, rows1, alpha, mesh.rank)
    return loss, n0 + n1


def hs_graph_step(s0, s1, centers, codes, points, pmask, alpha, mesh: Mesh):
    """Fused hierarchical-softmax step over sharded vertex vectors /
    inner-node weights, graph sign convention (``graph/deepwalk.py``
    ``_hs_graph_step``: loss per node -log sigmoid((2·bit-1)·dot)), in
    place. Returns ``(loss, rows_touched)``."""
    (v,) = _owned_rows_many(s0, [centers], mesh)
    (u,) = _owned_rows_many(s1, [points], mesh)
    sign = 2.0 * codes - 1.0
    denom = (pmask > 0).any(1).sum().clamp_min(1).to(v.dtype)

    def loss_fn(v_, u_):
        x = torch.bmm(u_, v_.unsqueeze(-1)).squeeze(-1)
        return -(pmask * F.logsigmoid(sign * x)).sum() / denom

    loss, (gv, gu) = sparse.rows_grad(loss_fn, v, u)
    n0 = _sparse_apply_(s0, centers, gv, alpha, mesh.rank)
    ids1, rows1 = sparse.flatten_occurrences(points, gu)
    n1 = _sparse_apply_(s1, ids1, rows1, alpha, mesh.rank)
    return loss, n0 + n1


def default_mesh(device=None) -> Mesh:
    """The initialised world's mesh, or a world of this one process on
    ``device`` (default ``"cuda"``, raising without a card)."""
    if dist.is_available() and dist.is_initialized():
        return build_mesh()
    return build_mesh(device=resolve_device(device))


def check_mesh(mesh: Mesh, device: torch.device) -> None:
    """A table on the card talks over NCCL, one on the CPU over gloo;
    a world of several ranks needs a group (``DistributedTrainer``'s
    rule)."""
    if mesh.backend is None:
        if mesh.data != 1:
            raise ValueError("a mesh of several ranks needs a group")
        return
    want = "nccl" if device.type == "cuda" else "gloo"
    if mesh.backend != want:
        raise RuntimeError(f"a {device.type} table needs a {want} group, "
                           f"the world was formed with {mesh.backend}")


# -- the table ----------------------------------------------------------


class ShardedEmbeddingTable:
    """A ``[V, D]`` embedding table row-sharded over the mesh's ranks.

    ``V`` is zero-padded up to a multiple of the world (pad rows are
    never owned by a valid id, so they are inert); queries and
    checkpoints see the canonical unpadded rows. ``self.table`` is this
    rank's ``[V'/N, D]`` shard on the mesh's device (``device`` names it
    for a world of one process).
    """

    def __init__(self, vocab: int, dim: int, *, mesh=None,
                 dtype=torch.float32, seed: int = 12345, rows=None,
                 device=None):
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self.device = self.mesh.device
        check_mesh(self.mesh, self.device)
        self.n_shards = int(self.mesh.data)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.padded_vocab = -(-self.vocab // self.n_shards) * self.n_shards
        self.dtype = dtype
        if rows is None:
            # word2vec resetWeights convention: U(-0.5, 0.5)/dim
            rng = np.random.RandomState(seed)
            rows = ((rng.rand(self.vocab, self.dim) - 0.5) / self.dim)
        self.table = self._place(rows)

    @classmethod
    def zeros(cls, vocab: int, dim: int, *, mesh=None, dtype=torch.float32,
              device=None) -> "ShardedEmbeddingTable":
        return cls(vocab, dim, mesh=mesh, dtype=dtype, device=device,
                   rows=np.zeros((vocab, dim), np.float32))

    @classmethod
    def from_rows(cls, rows, *, mesh=None, device=None
                  ) -> "ShardedEmbeddingTable":
        rows = np.asarray(rows)
        return cls(rows.shape[0], rows.shape[1], mesh=mesh, device=device,
                   dtype=torch.from_numpy(rows[:0]).dtype, rows=rows)

    # -- placement / persistence ---------------------------------------

    @property
    def shard_rows(self) -> int:
        return self.padded_vocab // self.n_shards

    def _place(self, rows) -> torch.Tensor:
        rows = np.asarray(rows)
        if rows.shape != (self.vocab, self.dim):
            raise ValueError(
                f"rows shape {rows.shape} != ({self.vocab}, {self.dim})")
        host = torch.zeros((self.padded_vocab, self.dim), dtype=self.dtype)
        host[: self.vocab] = torch.from_numpy(np.array(rows)).to(self.dtype)
        lo = self.mesh.rank * self.shard_rows
        placed = host[lo:lo + self.shard_rows].to(self.device).contiguous()
        note_shard_bytes(self.shard_bytes(placed))
        return placed

    def shard_bytes(self, table=None) -> int:
        """Bytes of this rank's row shard (``embedding_shard_bytes``;
        ~1/N of ``replicated_bytes``)."""
        t = self.table if table is None else table
        return int(t.numel() * t.element_size())

    def replicated_bytes(self) -> int:
        """Bytes a replicated copy of the (padded) table would pin on
        every rank."""
        return self.padded_vocab * self.dim * torch.empty(
            (), dtype=self.dtype).element_size()

    def to_host(self) -> np.ndarray:
        """Canonical unpadded host rows, the world-independent form a
        checkpoint stores. On several ranks an all-gather: every rank
        calls it."""
        t = self.table
        if self.mesh.backend is not None and self.n_shards > 1:
            parts = [torch.empty_like(t) for _ in range(self.n_shards)]
            dist.all_gather(parts, t.contiguous())
            t = torch.cat(parts)
        return t[: self.vocab].cpu().numpy().copy()

    def restore_rows(self, rows) -> None:
        """Place canonical host rows onto THIS table's ranks (the width
        they were written at does not matter)."""
        self.table = self._place(rows)

    # -- ops ------------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        t = ids if torch.is_tensor(ids) else torch.from_numpy(
            np.ascontiguousarray(ids))
        return t.to(self.device).long()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lookup(self, ids) -> torch.Tensor:
        """``table[ids]`` (canonical rows, any id shape) through the
        owned-rows gather and one all-reduce: bitwise the unsharded
        gather."""
        t0 = time.perf_counter()
        out = owned_rows(self.table, self._ids(ids), self.mesh)
        self._sync()
        note_lookup_ms((time.perf_counter() - t0) * 1000.0)
        return out

    def apply_sparse_grads(self, ids, grads, lr) -> int:
        """SGD row update from per-occurrence gradients: dedup + segment
        sum + owner scatter-add. Returns (and gauges) the unique rows
        touched. ``ids``/``grads`` may carry extra leading dims."""
        g = grads if torch.is_tensor(grads) else torch.from_numpy(
            np.asarray(grads))
        ids, g = sparse.flatten_occurrences(self._ids(ids),
                                            g.to(self.device, self.dtype))
        t0 = time.perf_counter()
        n = _sparse_apply_(self.table, ids, g, float(lr), self.mesh.rank)
        touched = int(n)
        note_scatter_ms((time.perf_counter() - t0) * 1000.0)
        note_rows_touched(touched)
        return touched

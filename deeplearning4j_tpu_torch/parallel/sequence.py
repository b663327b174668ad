"""Sequence parallelism: plain attention and ring attention over a
``seq`` axis of ranks.

Counterpart of ``deeplearning4j_tpu/parallel/sequence.py``.
``attention`` is the materialized reference (the whole ``[t, t]`` score
matrix) that the flash-attention kernel must match, the path ``mha``
takes under a key mask, and the recompute behind the kernel's backward
at short sequences. Its constants are the JAX package's: the scale is
``1 / sqrt(d)`` in q's dtype, applied to the scores, and masked scores
are filled with -1e9, not -inf.

``ring_attention`` is the JAX schedule with one rank a time shard: each
rank holds its ``[b, h, t_local, d]`` q, k, v (and its ``[b, t_local]``
key mask), computes the score tile against the K/V block it holds,
folds it into the online softmax (running max ``m`` from ``2 x NEG``,
denominator ``l``, numerator ``o``; causal positions from the source
block's offset), and passes the block (its mask with it) to the next
rank of the ring; after ``axis_size`` blocks ``o / max(l, 1e-20)`` is
softmax attention over the whole sequence. Each hop is an autograd
Function whose backward is the reverse hop (what JAX's ``lax.scan``
autodiff of ``ppermute`` gives): ``batch_isend_irecv`` on NCCL, on gloo
the all-reduce of zero-filled buffers (``row_exchange.stack_ranks``;
gloo has no point-to-point on CUDA tensors). The per-hop products stay
``torch.einsum``, as the JAX ring computes them outside any Pallas
kernel: the flash kernel returns a normalized output, not the ``(m, l,
o)`` partials the ring folds.

``build_seq_mesh(data, seq)`` lays the world out as JAX's ``(data,
seq)`` mesh (rank ``r`` at ``(r // seq, r % seq)``), forms every seq
group and installs the mesh: an attention layer with ``seq_axis`` and
``seq_axis_size > 1`` takes its ring from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

NEG = -1e9  # masked-score fill; exp(NEG - m) underflows to exactly 0


def neg_fill(s: torch.Tensor) -> torch.Tensor:
    """NEG in the scores' dtype, converted as JAX converts the Python
    float it fills with: in f16 it overflows to -inf (torch's
    ``masked_fill`` would refuse the number), which the softmax takes as
    a zero weight all the same. A CPU scalar tensor whatever the scores'
    device: ``masked_fill`` reads its value on the host, and reading a
    CUDA one would wait for the card, which a CUDA-graph capture (the
    scan path's chunk) refuses."""
    return torch.tensor(NEG, dtype=torch.float32).to(s.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over the key axis; ``mask`` is the ``[b, t]``
    validity of the keys (> 0: valid)."""
    scale = 1.0 / torch.sqrt(torch.full((), float(q.shape[-1]),
                                        dtype=q.dtype, device=q.device))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    t = q.shape[2]
    if causal:
        above = torch.ones((t, t), dtype=torch.bool,
                           device=q.device).triu(1)
        s = s.masked_fill(above, neg_fill(s))
    if mask is not None:
        s = s.masked_fill((mask <= 0)[:, None, None, :], neg_fill(s))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


@dataclass(frozen=True)
class SeqMesh:
    """The ``(data, seq)`` layout of the world: this rank's place on
    both axes (None off the mesh, where ``data * seq`` is below the
    world size) and its ``seq`` group."""

    data: int
    seq: int
    rank: int
    group: Any = None
    axis_name: str = "seq"

    @property
    def shape(self) -> dict:
        return {"data": self.data, self.axis_name: self.seq}

    @property
    def seq_index(self) -> Optional[int]:
        return (self.rank % self.seq if self.rank < self.data * self.seq
                else None)

    @property
    def data_index(self) -> Optional[int]:
        return (self.rank // self.seq if self.rank < self.data * self.seq
                else None)


_installed = {"mesh": None}


def build_seq_mesh(data: int = 1, seq: Optional[int] = None,
                   devices=None) -> SeqMesh:
    """The ``(data, seq)`` mesh for context parallelism over the
    initialised world (JAX ``build_seq_mesh``: by default every rank on
    ``seq``), installed for the attention layers of this process. Every
    rank must call it (it forms the groups); ``devices`` (a rank count)
    stands in for the world size."""
    world = (dist.get_world_size() if dist.is_available()
             and dist.is_initialized() else 1)
    n = int(devices) if devices is not None else world
    if seq is None:
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        seq = n // data
    if data * seq > n:
        raise ValueError(f"data({data}) x seq({seq}) > {n} devices")
    rank = dist.get_rank() if world > 1 else 0
    group = None
    if world > 1:
        for i in range(data):
            g = dist.new_group([i * seq + j for j in range(seq)])
            if rank // seq == i and rank < data * seq:
                group = g
    mesh = SeqMesh(data=int(data), seq=int(seq), rank=rank, group=group)
    _installed["mesh"] = mesh
    return mesh


def seq_mesh(axis_name: str, axis_size: int) -> SeqMesh:
    """The installed mesh whose ``axis_name`` axis has ``axis_size``
    ranks; raises without one."""
    mesh = _installed["mesh"]
    if mesh is None or mesh.axis_name != axis_name:
        raise RuntimeError(
            f"ring attention over the sequence axis {axis_name!r} needs "
            "the seq mesh of this process: call build_seq_mesh(data, seq) "
            "on every rank first")
    if mesh.seq != int(axis_size) or mesh.seq_index is None:
        raise ValueError(
            f"seq_axis_size={axis_size} but this rank's {axis_name!r} axis "
            f"has {mesh.seq} ranks" if mesh.seq_index is not None else
            f"rank {mesh.rank} is off the {mesh.shape} seq mesh")
    return mesh


def ring_hop(t: torch.Tensor, group, n: int, index: int,
             shift: int = 1) -> torch.Tensor:
    """Every rank's ``t`` moved ``shift`` places along the ring of the
    ``n`` ranks of ``group`` (``index``: this rank's place): rank ``i``
    receives rank ``i - shift``'s. No gradient (``RingHop`` carries
    one)."""
    src, dst = (index - shift) % n, (index + shift) % n
    if dist.get_backend(group) == "nccl":
        # a dense receive buffer: ``empty_like`` would keep a transposed
        # operand's strides, which a receive of dense bytes ignores
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        ops = [dist.P2POp(dist.isend, t.contiguous(),
                          dist.get_global_rank(group, dst), group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, src), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    from deeplearning4j_tpu_torch.parallel.row_exchange import stack_ranks

    return stack_ranks(t.contiguous(), n, index, group=group)[src].clone()


class RingHop(torch.autograd.Function):
    """One hop forward around the ring; the backward hops back (the
    transpose of JAX's ``ppermute``)."""

    @staticmethod
    def forward(ctx, t, group, n, index):
        ctx.ring = (group, n, index)
        return ring_hop(t, group, n, index, 1)

    @staticmethod
    def backward(ctx, g):
        return ring_hop(g, *ctx.ring, -1), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "seq", axis_size: Optional[int] = None,
                   causal: bool = False,
                   mask: Optional[torch.Tensor] = None,
                   mesh: Optional[SeqMesh] = None) -> torch.Tensor:
    """Blockwise ring attention of this rank's time shard (JAX
    ``ring_attention``): q, k, v ``[b, h, t_local, d]``, ``mask``
    ``[b, t_local]`` or None, over the ``axis_name`` group of the
    installed seq mesh (or ``mesh``); returns this rank's ``[b, h,
    t_local, d]`` rows of softmax attention over every rank's keys.
    Differentiable (module docstring)."""
    if mesh is None:
        mesh = seq_mesh(axis_name, axis_size if axis_size is not None
                        else _installed["mesh"].seq if _installed["mesh"]
                        else 0)
    n, me = mesh.seq, mesh.seq_index
    tl = q.shape[2]
    scale = 1.0 / torch.sqrt(torch.full((), float(q.shape[-1]),
                                        dtype=q.dtype, device=q.device))
    ar = torch.arange(tl, device=q.device)
    q_pos = me * tl + ar
    o = torch.zeros_like(q)
    l = q.new_zeros(q.shape[:3] + (1,))
    # start far below any real score so the first correction is 0
    m = torch.full(q.shape[:3] + (1,), 2.0 * NEG, dtype=q.dtype,
                   device=q.device)
    k_cur, v_cur, mask_cur = k, v, mask
    for i in range(n):
        src = (me - i) % n
        s = torch.einsum("bhqd,bhkd->bhqk", q, k_cur) * scale
        if causal:
            k_pos = src * tl + ar
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], neg_fill(s))
        if mask_cur is not None:
            s = s.masked_fill((mask_cur <= 0)[:, None, None, :],
                              neg_fill(s))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v_cur)
        m = m_new
        del s, p
        if i + 1 < n:
            ring = (mesh.group, n, me)
            k_cur = RingHop.apply(k_cur, *ring)
            v_cur = RingHop.apply(v_cur, *ring)
            if mask_cur is not None:
                mask_cur = RingHop.apply(mask_cur, *ring)
    return o / torch.clamp(l, min=1e-20)


def ring_self_attention_sharded(mesh: SeqMesh, q, k, v,
                                causal: bool = False, mask=None,
                                seq_axis: str = "seq") -> torch.Tensor:
    """The whole ``[b, h, t, d]`` q, k, v (the same on every rank of the
    ``seq`` group) sharded on time over the group, ring attention on
    each shard, and the ``[b, h, t, d]`` result gathered on every rank
    (JAX ``ring_self_attention_sharded``); the gradients of q, k, v are
    the whole sequence's on every rank."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        copy_to_group,
        gather_along,
    )

    if seq_axis != mesh.axis_name:
        raise ValueError(f"mesh has no axis {seq_axis!r}")
    n, me = mesh.seq, mesh.seq_index
    tl = q.shape[2] // n

    def mine(a, dim):
        return copy_to_group(a, mesh.group).narrow(dim, me * tl, tl)

    out = ring_attention(mine(q, 2), mine(k, 2), mine(v, 2), causal=causal,
                         mask=None if mask is None else mask.narrow(
                             1, me * tl, tl), mesh=mesh)
    return gather_along(out, 2, mesh.group, n, me)

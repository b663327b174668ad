"""Expert parallelism: the Switch top-1 mixture-of-experts FFN, on one
device and with its experts sharded over the ranks of a
``torch.distributed`` world, tokens exchanged by ``all_to_all``.

Counterpart of ``deeplearning4j_tpu/parallel/expert.py``, with its
semantics: a softmax router, each token to its argmax expert, gated by
that expert's probability; an expert takes at most ``capacity =
max(ceil(n * capacity_factor / E), 1)`` tokens, in token order (the
position of a token in its expert's queue is a cumulative sum of the
routing one-hots); a token past capacity, or masked out, gets zero
output (the residual around the layer carries it). The expert FFN is
``relu(x @ w1 + b1) @ w2 + b2``.

Two formulations of the same function:
- ``moe_ffn_reference`` is the JAX package's dense one, kept as the
  plain version: ``[n, E, C]`` one-hot dispatch and combine tensors and
  two ``einsum``s (a TPU idiom; at 8,192 tokens, 4 experts and a
  capacity of 2,560 each tensor holds 335 MB in f32);
- ``moe_ffn`` (the main path) dispatches by slot index: token i goes to
  row ``expert * C + position`` of an ``[E * C + 1, d]`` buffer (the
  last row takes what is dropped) and comes back by a gather times its
  gate. Every sum of the dense ``einsum``s has exactly one nonzero term,
  so the two agree bit for bit on the CPU. Every shape is static (no
  ``nonzero``, no host read), so a CUDA graph captures it.

The position ``cumsum`` runs in the router logits' dtype, as in the JAX
package. Its values are small integers, exact in f32 in any order. In
bf16 / f16 they are not past 256, so there the sum follows XLA's CPU
order (``_cumsum_like_xla``: blocks of 16 summed in order, the block
totals scanned the same way, each block offset by the totals before it)
and reproduces the reference's slots, its shared slots included
(ROADMAP §3, faults of the reference).

``ExpertParallelMoE`` is the sharded runtime: one rank a device, the
experts stacked on axis 0 and split over the ranks, the tokens split by
rows; the capacity is per rank, as in the JAX package's shard_map.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# XLA's CPU compiler rewrites a long cumulative sum into blocks of this
# many elements (the reduce-window rewriter's base length)
_XLA_SCAN_BLOCK = 16


def moe_capacity(n_tokens: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Slots an expert takes: ``max(ceil(n * cf / E), 1)`` (JAX
    ``moe_ffn_reference``)."""
    return max(int(np.ceil(n_tokens * capacity_factor / n_experts)), 1)


def init_moe_params(gen: torch.Generator, d_model: int, d_hidden: int,
                    n_experts: int, dtype=torch.float32) -> dict:
    """``router [d, E]``, ``w1 [E, d, h]``, ``b1 [E, h]``, ``w2 [E, h,
    d]``, ``b2 [E, d]``: normals scaled by 1 / sqrt(fan-in), zero biases
    (JAX ``init_moe_params``; other numbers from the same seed)."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                / math.sqrt(fan_in)).to(dtype)

    return {
        "router": normal((d_model, n_experts), d_model),
        "w1": normal((n_experts, d_model, d_hidden), d_model),
        "b1": torch.zeros((n_experts, d_hidden), dtype=dtype),
        "w2": normal((n_experts, d_hidden, d_model), d_hidden),
        "b2": torch.zeros((n_experts, d_model), dtype=dtype),
    }


def _cumsum_like_xla(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over axis 0 with XLA's CPU order of additions,
    each rounded to ``x``'s dtype: blocks of ``_XLA_SCAN_BLOCK`` rows
    summed in order, the block totals scanned the same way, each block
    offset by the totals of the blocks before it."""
    n = int(x.shape[0])
    b = _XLA_SCAN_BLOCK
    if n <= b:
        rows = [x[0]]
        for i in range(1, n):
            rows.append(rows[-1] + x[i])
        return torch.stack(rows)
    pad = -(-n // b) * b - n
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    blocks = xp.reshape((-1, b) + tuple(x.shape[1:]))
    cols = [blocks[:, 0]]
    for j in range(1, b):
        cols.append(cols[-1] + blocks[:, j])
    within = torch.stack(cols, dim=1)
    before = _cumsum_like_xla(within[:, -1])
    before = torch.cat([before.new_zeros((1,) + tuple(before.shape[1:])),
                        before[:-1]])
    return (within + before[:, None]).reshape(xp.shape)[:n]


def _positions(onehot: torch.Tensor) -> torch.Tensor:
    """Each token's position in its expert's queue, ``sum(cumsum(onehot)
    * onehot, -1) - 1``, in ``onehot``'s dtype (-1 for a token routed
    nowhere)."""
    if onehot.dtype in (torch.float32, torch.float64):
        csum = torch.cumsum(onehot, dim=0)   # small integers: exact
    else:
        csum = _cumsum_like_xla(onehot)
    return (csum * onehot).sum(dim=-1) - 1.0


def _route(logits: torch.Tensor, capacity: int, token_mask=None):
    """(probs, expert index, gate, the masked routing one-hots, position,
    kept) of top-1 routing."""
    e = int(logits.shape[-1])
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argmax(probs, dim=-1)
    gate = probs.amax(dim=-1)
    onehot = (idx[:, None] == torch.arange(e, device=logits.device)
              ).to(logits.dtype)
    if token_mask is not None:
        onehot = onehot * token_mask[:, None].to(onehot.dtype)
    pos = _positions(onehot)
    keep = pos < capacity
    return probs, idx, gate, onehot, pos, keep


def switch_dispatch(logits: torch.Tensor, capacity: int,
                    token_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense top-1 dispatch (JAX ``switch_dispatch``): logits [n, E]
    -> (dispatch [n, E, C] one-hot, combine [n, E, C] gate-weighted,
    probs [n, E]). A masked token or one past capacity has an all-zero
    row."""
    probs, _, gate, onehot, pos, keep = _route(logits, capacity, token_mask)
    pos_oh = (pos.to(torch.int32)[:, None] == torch.arange(
        capacity, device=logits.device)).to(logits.dtype)
    dispatch = (onehot[:, :, None] * pos_oh[:, None, :]
                * keep[:, None, None].to(logits.dtype))
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, probs


def switch_route(logits: torch.Tensor, capacity: int,
                 token_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slot form of ``switch_dispatch``: (slot [n] int64, gate [n],
    probs [n, E]). A routed token's slot is ``expert * C + position``;
    a dropped or masked one's is ``E * C`` (the drop row)."""
    e = int(logits.shape[-1])
    probs, idx, gate, _, pos, keep = _route(logits, capacity, token_mask)
    routed = keep & (pos >= 0)
    slot = torch.where(routed, idx * capacity + pos.to(torch.int64),
                       torch.full_like(idx, e * capacity))
    return slot, gate, probs


def scatter_slots(x: torch.Tensor, slot: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """[n, d] tokens summed into their slots of a zero [n_slots, d]
    buffer (the drop row cut off): the dense dispatch ``einsum``'s
    ``"nd,nec->ecd"`` as ``[E * C, d]``."""
    buf = x.new_zeros((n_slots + 1, int(x.shape[1])))
    return buf.index_add(0, slot, x)[:n_slots]


def gather_slots(rows: torch.Tensor, slot: torch.Tensor,
                 gate: torch.Tensor) -> torch.Tensor:
    """Each token's slot row times its gate, zero for the drop row: the
    combine ``einsum``'s ``"ecd,nec->nd"``."""
    rows = torch.cat([rows, rows.new_zeros((1, int(rows.shape[1])))])
    return rows.index_select(0, slot) * gate[:, None]


def _expert_ffn(w1, b1, w2, b2, x):
    """[E, C, d] tokens through each expert's two-layer relu FFN."""
    h = torch.relu(torch.bmm(x, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def _moe_slots(params: dict, x: torch.Tensor, capacity_factor: float,
               token_mask=None, n_devices: int = 1, exchange=None):
    """Tokens ``x`` [n, d] through the slot-index MoE: ``(y, router
    logits)``. With ``n_devices`` ranks the expert rows travel to the
    ranks of their experts and back through ``exchange`` (an
    ``all_to_all`` over the first axis of [n_devices, ...]); ``params``
    then hold this rank's experts. On one device the reshapes around the
    FFN are views and the path is ``moe_ffn``'s, bit for bit."""
    nd = n_devices
    n, d = int(x.shape[0]), int(x.shape[1])
    e = int(params["router"].shape[1])
    el = e // nd
    cap = moe_capacity(n, capacity_factor, e)
    logits = x @ params["router"]
    slot, gate, _ = switch_route(logits, cap, token_mask)
    rows = scatter_slots(x, slot, e * cap).reshape(nd, el * cap, d)
    if exchange is not None:  # rows of each peer for this rank's experts
        rows = exchange(rows)
    rows = rows.reshape(nd, el, cap, d).transpose(0, 1).reshape(
        el, nd * cap, d)
    out = _expert_ffn(params["w1"], params["b1"], params["w2"],
                      params["b2"], rows)
    out = out.reshape(el, nd, cap, d).transpose(0, 1).reshape(
        nd, el * cap, d)
    if exchange is not None:
        out = exchange(out.contiguous())
    return gather_slots(out.reshape(e * cap, d), slot, gate), logits


def moe_ffn(params: dict, x: torch.Tensor, capacity_factor: float = 1.25,
            token_mask: Optional[torch.Tensor] = None,
            with_aux: bool = False):
    """The Switch MoE FFN of tokens ``x`` [n, d] by slot index (the main
    path; the module docstring). Masked tokens give zero and take no
    capacity. With ``with_aux`` also the load-balancing loss of the same
    router logits: ``(y, aux)``."""
    y, logits = _moe_slots(params, x, capacity_factor, token_mask)
    return (y, aux_load_balance_loss(logits)) if with_aux else y


def moe_ffn_reference(params: dict, x: torch.Tensor,
                      capacity_factor: float = 1.25,
                      token_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The dense-dispatch plain version (JAX ``moe_ffn_reference``)."""
    n = int(x.shape[0])
    e = int(params["router"].shape[1])
    cap = moe_capacity(n, capacity_factor, e)
    dispatch, combine, _ = switch_dispatch(x @ params["router"], cap,
                                           token_mask)
    expert_in = torch.einsum("nd,nec->ecd", x, dispatch)
    expert_out = _expert_ffn(params["w1"], params["b1"], params["w2"],
                             params["b2"], expert_in)
    return torch.einsum("ecd,nec->nd", expert_out, combine)


def aux_load_balance_loss(logits: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss ``E * sum_e f_e * p_e`` (f_e: the
    share of tokens routed to e, p_e: its mean router probability)."""
    probs = torch.softmax(logits, dim=-1)
    e = int(probs.shape[-1])
    assign = (torch.argmax(probs, dim=-1)[:, None] == torch.arange(
        e, device=logits.device)).to(probs.dtype)
    return e * torch.sum(assign.mean(dim=0) * probs.mean(dim=0))


# -- the sharded runtime ------------------------------------------------------


def build_expert_mesh(n_devices: Optional[int] = None, device=None):
    """The expert axis over the initialised ``torch.distributed`` world
    (JAX ``build_expert_mesh``): the port's ``Mesh`` of every rank (one
    rank a device, the world's); without a world, a mesh of this process
    on ``device``, which defaults to the card and raises without one.
    ``n_devices`` must equal the world size where given."""
    from deeplearning4j_tpu_torch.ops.dispatch import resolve_device
    from deeplearning4j_tpu_torch.parallel.mesh import build_mesh

    if not dist.is_initialized():
        device = resolve_device(device)
    m = build_mesh(device=device)
    if n_devices is not None and int(n_devices) != m.data:
        raise ValueError(f"build_expert_mesh: {n_devices} devices asked, "
                         f"the world has {m.data} ranks")
    return m


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` over the first axis ([world, ...]: chunk j to rank
    j, rank j's chunk into place j); its own adjoint."""

    @staticmethod
    def forward(ctx, x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous())
        return out


class ExpertParallelMoE:
    """Mesh-sharded Switch MoE (JAX ``ExpertParallelMoE``): the experts
    stacked on axis 0 and split over the ranks, the router replicated,
    the tokens split by rows; two ``all_to_all``s take each rank's
    expert inputs to the ranks of their experts and bring the outputs
    home. Every rank calls every method (they are collectives) with the
    same global tokens."""

    def __init__(self, mesh, n_experts: int, capacity_factor: float = 1.25):
        """``mesh``: ``build_expert_mesh()``'s (its ``data`` ranks form the
        expert axis; ``backend`` None: no group, one process)."""
        self.mesh = mesh
        self.n_devices = int(mesh.data)
        if n_experts % self.n_devices:
            raise ValueError(f"{n_experts} experts not divisible over "
                             f"{self.n_devices} devices")
        self.n_experts = int(n_experts)
        self.capacity_factor = capacity_factor

    @property
    def _collective(self) -> bool:
        return self.mesh.backend is not None

    def _local_rows(self, n: int):
        per = n // self.n_devices
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)

    def shard_params(self, params: dict) -> dict:
        """This rank's parameters: the whole router, its experts'
        slices of ``w1 b1 w2 b2``, on the mesh's device."""
        el = self.n_experts // self.n_devices
        mine = slice(self.mesh.rank * el, (self.mesh.rank + 1) * el)
        dev = self.mesh.device
        out = {"router": torch.as_tensor(params["router"]).to(dev).clone()}
        for k in ("w1", "b1", "w2", "b2"):
            out[k] = torch.as_tensor(params[k])[mine].to(dev).contiguous()
        return out

    def _apply_local(self, params: dict, x: torch.Tensor):
        """This rank's tokens [n_local, d] through the sharded MoE (JAX
        ``_build``'s ``local``): (y, this rank's router logits)."""
        return _moe_slots(params, x, self.capacity_factor,
                          n_devices=self.n_devices,
                          exchange=_AllToAll.apply if self._collective
                          else None)

    def _check_tokens(self, x) -> Tuple[torch.Tensor, int]:
        x = torch.as_tensor(x)
        n = int(x.shape[0])
        if n % self.n_devices:
            raise ValueError(f"{n} tokens not divisible by "
                             f"{self.n_devices} devices")
        return x.to(self.mesh.device), n

    def _gather(self, y: torch.Tensor) -> torch.Tensor:
        if not self._collective:
            return y
        parts = [torch.empty_like(y) for _ in range(self.n_devices)]
        dist.all_gather(parts, y.contiguous())
        return torch.cat(parts)

    def apply(self, params: dict, x) -> torch.Tensor:
        """The global tokens ``x`` [n, d] (n divisible by the rank
        count) through the sharded MoE; every rank gets the global
        output."""
        x, n = self._check_tokens(x)
        with torch.no_grad():
            return self._gather(self._apply_local(
                params, x[self._local_rows(n)])[0])

    def train_step(self, params: dict, x, targets, *, lr=0.05,
                   aux_weight: float = 0.01):
        """One synchronous SGD step of ``mean((moe(x) - targets)^2) +
        aux_weight * mean(each rank's load-balance loss)`` (JAX
        ``train_step``); gradients flow back through both exchanges, the
        router's summed over the ranks. Returns ``(new_params,
        loss)``."""
        x, n = self._check_tokens(x)
        tgt = torch.as_tensor(targets).to(self.mesh.device)
        rows = self._local_rows(n)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        y, logits = self._apply_local(p, x[rows])
        aux = aux_load_balance_loss(logits)
        d = int(x.shape[1])
        local = (((y - tgt[rows]) ** 2).sum() / (n * d)
                 + aux_weight * aux / self.n_devices)
        local.backward()
        loss = local.detach().clone()
        grad_router = p["router"].grad
        if self._collective:
            dist.all_reduce(loss)
            dist.all_reduce(grad_router)
        new = {k: (v - (lr * v.grad).to(v.dtype)).detach()
               for k, v in p.items()}
        return new, loss

"""Flash attention: ``softmax(q kᵀ / sqrt(d) [causal]) v`` as one
hand-written CUDA kernel (``csrc/flash_attention.cu``) with an online
softmax, so the ``[t, t]`` score matrix never reaches device memory.

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``. Layout is
the JAX package's: q, k, v ``[b, h, t, d]`` in, ``[b, h, t, d]`` out, in
the inputs' dtype (f32, bf16 or f16); scores and sums are f32. The TPU
package has two schedules behind ``flash_attention``, chosen by ``t * d
> _RESIDENT_TD_LIMIT`` (d the head dimension): K/V resident in VMEM, or
streamed block by block. Here both are one kernel template with two
entries, ``flash_attention`` and ``flash_attention_streamed``, each with
its own launch counter; they differ in one thing, as on the TPU: the
resident schedule scales q in its input dtype, the streamed one casts q
to f32 first (the same function for f32 inputs). The kernel takes any t
(it masks the ragged tile) and a head dimension up to
``MAX_HEAD_DIM``, and raises above it.

Routing, without fallbacks:
- ``flash_attention`` launches the kernel for a CUDA tensor and runs
  ``flash_attention_reference`` (the plain version: the same blockwise
  online softmax over 128-key blocks, with the same constants) for a
  CPU one.
- ``mha`` runs ``parallel.sequence.attention`` (the materialized
  reference) under a key mask on either device: the TPU kernels have no
  masked variant. Without a mask a CUDA tensor always launches the
  kernel, whatever t; a CPU tensor takes the plain flash version where
  the JAX package's ``attention_seq_ok`` admits t and the reference
  otherwise. Unlike the JAX ``mha``, nothing is caught: a launch the
  kernel refuses raises.

The backward is no kernel, as in the JAX package (``_flash_bwd``): up to
``_BWD_MATERIALIZE_T_LIMIT`` timesteps it is autograd of the reference
``attention``, recomputed; above it ``_blockwise_attention_bwd``, a loop
over key blocks with a logsumexp pre-pass that never builds ``[t, t]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.ops import _build, dispatch
from deeplearning4j_tpu_torch.ops.conv_block import wants_grad
from deeplearning4j_tpu_torch.ops.tiling import (
    FLASH_SMEM_BYTES,
    SM_SMEM_BYTES,
)
from deeplearning4j_tpu_torch.parallel.sequence import NEG, attention

# above this many K/V elements (t * d) a head takes the streamed TPU
# schedule (its resident K/V would overflow VMEM); here it picks the
# entry, and with it the rounding of the q scaling
_RESIDENT_TD_LIMIT = 8192 * 64
# above this many timesteps the backward runs blockwise instead of
# materializing [t, t] (16 MB a head at t 2048)
_BWD_MATERIALIZE_T_LIMIT = 2048
MAX_HEAD_DIM = 128
_BLOCK = 128  # the plain version's key block (the TPU kernels' default)


# The kernel's tile (csrc/flash_attention.cu Layout): 128 query rows and
# 64 keys a block, q and p rows padded by 4 f32, K and V rows by 16
# bytes; 128 threads (two blocks an SM) up to d 64, 256 (one) at d 128;
# a ring of two K/V stages where the SM's blocks still fit in its
# shared memory, else one K and one V buffer refilled in turn.
FLASH_BLOCK_Q = 128
FLASH_BLOCK_K = 64


class FlashPlan(NamedTuple):
    """``padded_d`` (32, 64 or 128), ``threads`` a block, K/V ``stages``
    and the dynamic shared memory a block takes, in bytes."""
    padded_d: int
    threads: int
    stages: int
    smem_bytes: int


def flash_smem_plan(d: int, element_size: int = 4) -> FlashPlan:
    """The flash kernel's plan at head dimension ``d`` for inputs of
    ``element_size`` bytes: q and p tiles in f32, then ``stages`` × (K
    tile, V tile) in the input type, two stages where the blocks an SM
    holds (two of 128 threads, or one of 256 at d 128) fit."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dimension {d} outside "
                         f"1..{MAX_HEAD_DIM}")
    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    threads = 256 if dp == 128 else 128
    budget = FLASH_SMEM_BYTES if threads == 256 else (
        SM_SMEM_BYTES // 2 - 1024)
    fixed = 4 * FLASH_BLOCK_Q * (dp + 4) + 4 * FLASH_BLOCK_Q * (
        FLASH_BLOCK_K + 4)
    tile = FLASH_BLOCK_K * (dp * element_size + 16)
    stages = 2 if fixed + 4 * tile <= budget else 1
    return FlashPlan(dp, threads, stages, fixed + 2 * stages * tile)


def pow2_divisor_leq(n: int, cap: int) -> int:
    """Largest power-of-two divisor of ``n`` that is <= cap (>= 1)."""
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


def attention_seq_ok(t: int) -> bool:
    """The JAX ``mha``'s eligibility for its kernel: the sequence must
    divide by the default (clamped) block size."""
    return t >= 8 and t % min(_BLOCK, t) == 0


def pick_attention_blocks(t: int):
    """(block_q, block_k): the TPU kernels' 128s, clamped to t."""
    return min(_BLOCK, t), min(_BLOCK, t)


def _streamed(t: int, d: int) -> bool:
    return t * d > _RESIDENT_TD_LIMIT


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def _scaled_q(q: torch.Tensor, streamed: bool) -> torch.Tensor:
    """q * scale in f32, rounded as the schedule rounds it: the
    resident one multiplies in q's dtype (the scalar rounded to it
    first, as JAX's weak-typed scalar is), the streamed one in f32."""
    scale = _scale(int(q.shape[-1]))
    if streamed:
        return q.float() * scale
    return (q * torch.tensor(scale, dtype=q.dtype)).float()


def _plain_forward(q, k, v, causal: bool, streamed: bool):
    """The blockwise online softmax in plain PyTorch. Under a causal
    mask a key block is folded into the rows at or after its first key
    only: for the rows before it every score is -1e9, so its update is
    exactly nothing (p = 0, the rescale exp(0) = 1)."""
    b, h, t, d = q.shape
    f32 = torch.float32
    qf = _scaled_q(q, streamed)
    kf, vf = k.to(f32), v.to(f32)
    m = torch.full((b, h, t, 1), 2.0 * NEG, dtype=f32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=f32, device=q.device)
    o = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    pos = torch.arange(t, device=q.device)
    bk = min(_BLOCK, t)
    for k0 in range(0, t, bk):
        r0 = k0 if causal else 0
        kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.matmul(qf[:, :, r0:], kb.transpose(-1, -2))
        if causal:
            s = s.masked_fill(pos[r0:, None] < pos[None, k0:k0 + bk], NEG)
        m_prev = m[:, :, r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_prev - m_new)
        l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(dim=-1, keepdim=True)
        o[:, :, r0:] = o[:, :, r0:] * corr + torch.matmul(p, vb)
        m[:, :, r0:] = m_new
    return (o / torch.clamp_min(l, 1e-20)).to(q.dtype)


def _kernel_forward(q, k, v, causal: bool, streamed: bool):
    kernel = "flash_attention_streamed" if streamed else "flash_attention"
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{kernel}: unsupported dtype {q.dtype}")
    for name, a in (("k", k), ("v", v)):
        if a.device != q.device or a.dtype != q.dtype:
            raise TypeError(f"{kernel}: {name} is {a.dtype} on {a.device}, "
                            f"q is {q.dtype} on {q.device}")
    b, h, t, d = (int(s) for s in q.shape)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head dimension {d} exceeds the "
                         f"kernel's maximum of {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    lib = _build.load()
    rc = getattr(lib, "dl4j_" + kernel)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b * h, t, d, int(causal), _scale(d),
        _build.current_stream_handle(q.device),
    )
    _build.check(rc, kernel)
    dispatch.note_launch(kernel, dispatch.DTYPE_TAGS[q.dtype])
    return out


def _use_blockwise_bwd(t: int) -> bool:
    return t > _BWD_MATERIALIZE_T_LIMIT


class _FlashFn(torch.autograd.Function):
    """The kernel (or its plain version) forward; the JAX package's
    backward: recompute through the reference, or blockwise."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kernels, streamed):
        fwd = _kernel_forward if kernels else _plain_forward
        out = fwd(q, k, v, causal, streamed)
        # only the blockwise backward reads the output
        keep = out if _use_blockwise_bwd(int(q.shape[2])) else None
        ctx.save_for_backward(q, k, v, keep)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        if out is not None:
            dq, dk, dv = _blockwise_attention_bwd(q, k, v, out, g,
                                                  ctx.causal)
        else:
            with torch.enable_grad():
                leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
                o = attention(*leaves, causal=ctx.causal)
                dq, dk, dv = torch.autograd.grad(o, leaves, g)
        return dq, dk, dv, None, None, None


def _blockwise_attention_bwd(q, k, v, out, do, causal: bool,
                             block_k: int = 512):
    """The flash-attention backward as a loop over key blocks (JAX
    ``_blockwise_attention_bwd``, a ``lax.scan`` there): a first pass
    builds each row's logsumexp L, then per block P_b = exp(Q K_bᵀ s -
    L), dV_b = P_bᵀ dO, dS_b = P_b (dO V_bᵀ - D), dQ += dS_b K_b, dK_b =
    dS_bᵀ Q. Peak memory O(t * block_k): [t, t] never materializes."""
    b, h, t, d = q.shape
    # a power-of-two divisor: block_k = t would rebuild [t, t]
    bk = pow2_divisor_leq(t, min(block_k, t))
    f32 = torch.float32
    scale = _scale(d)
    qf = q.to(f32) * scale
    dof = do.to(f32)
    pos = torch.arange(t, device=q.device)

    def scores(j):
        kb = k[:, :, j:j + bk].to(f32)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        if causal:
            s = s.masked_fill(pos[:, None] < pos[None, j:j + bk], NEG)
        return s, kb

    m = torch.full((b, h, t, 1), 2.0 * NEG, dtype=f32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=f32, device=q.device)
    for j in range(0, t, bk):
        s, _ = scores(j)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
            dim=-1, keepdim=True)
        m = m_new
    lse = m + torch.log(torch.clamp_min(l, 1e-20))
    dvec = (dof * out.to(f32)).sum(dim=-1, keepdim=True)  # rowsum(dO O)
    dq = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    dks, dvs = [], []
    for j in range(0, t, bk):
        s, kb = scores(j)
        vb = v[:, :, j:j + bk].to(f32)
        p = torch.exp(s - lse)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vb) - dvec)
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf))
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, dof))
    return ((dq * scale).to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def _flash(q, k, v, causal: bool, kernels: bool, streamed=None):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: q, k, v must share one [b, h, t, d] shape; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    t, d = int(q.shape[2]), int(q.shape[3])
    if streamed is None:
        streamed = _streamed(t, d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not wants_grad(q, k, v):
        fwd = _kernel_forward if kernels else _plain_forward
        return fwd(q, k, v, bool(causal), bool(streamed))
    return _FlashFn.apply(q, k, v, bool(causal), kernels, bool(streamed))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v ``[b, h, t, d]`` -> ``[b, h, t, d]``: the CUDA kernel
    (the resident or the streamed entry, by ``t * d``) for CUDA tensors,
    the plain version for CPU ones. Differentiable in q, k and v."""
    return _flash(q, k, v, causal, kernels=dispatch.is_kernel_tensor(q))


def flash_attention_reference(q, k, v, causal: bool = False, *,
                              streamed=None):
    """The plain version on any device (same blockwise arithmetic and
    constants, the same backward); ``streamed`` forces a schedule's q
    rounding (default: by ``t * d``, as the kernel)."""
    return _flash(q, k, v, causal, kernels=False, streamed=streamed)


def mha(q, k, v, causal: bool = False, mask=None):
    """Attention as the layers call it (routing in the module
    docstring); ``mask`` is the ``[b, t]`` key validity."""
    if mask is not None:
        return attention(q, k, v, causal=causal, mask=mask)
    if dispatch.is_kernel_tensor(q) or attention_seq_ok(int(q.shape[2])):
        return flash_attention(q, k, v, causal)
    return attention(q, k, v, causal=causal)

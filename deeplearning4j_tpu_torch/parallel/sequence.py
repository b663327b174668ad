"""Plain scaled-dot-product attention on ``[b, h, t, d]``.

Counterpart of ``deeplearning4j_tpu/parallel/sequence.py::attention``:
the materialized reference (the whole ``[t, t]`` score matrix) that the
flash-attention kernel must match, the path ``mha`` takes under a key
mask, and the recompute behind the kernel's backward at short
sequences. Its constants are the JAX package's: the scale is
``1 / sqrt(d)`` in q's dtype, applied to the scores, and masked scores
are filled with -1e9, not -inf. Ring attention (``ring_attention``, the
sequence-sharded schedule) arrives with the distribution slice.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1e9  # masked-score fill; exp(NEG - m) underflows to exactly 0


def neg_fill(s: torch.Tensor) -> torch.Tensor:
    """NEG in the scores' dtype, converted as JAX converts the Python
    float it fills with: in f16 it overflows to -inf (torch's
    ``masked_fill`` would refuse the number), which the softmax takes as
    a zero weight all the same."""
    return torch.tensor(NEG, dtype=torch.float32,
                        device=s.device).to(s.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over the key axis; ``mask`` is the ``[b, t]``
    validity of the keys (> 0: valid)."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]),
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

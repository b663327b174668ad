"""Sequence parallelism, so far its materialized reference attention
(``sequence.attention``); ring attention arrives with the distribution
slice (ROADMAP)."""

from deeplearning4j_tpu_torch.parallel.sequence import attention

__all__ = ["attention"]

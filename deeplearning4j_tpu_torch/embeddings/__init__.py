"""Sharded embeddings: tables whose rows are a resource of the
data-parallel world.

Counterpart of ``deeplearning4j_tpu/embeddings``. Word2Vec, DeepWalk
and the engines' ``EmbeddingLayer`` store a ``[V, D]`` table; this
package shards its ROWS over the ranks of the ``torch.distributed``
world (one process a device, NCCL on the card, gloo on the CPU), so
vocabulary capacity grows with the world:

- ``sparse.py`` — the gradient discipline: differentiate with respect
  to the GATHERED rows, fold duplicate ids by sort + segmented sum
  (bitwise repeatable on the card). No collectives.
- ``table.py`` — ``ShardedEmbeddingTable`` + the fused steps:
  collective lookup (owned rows + an all-reduce of exact zeros,
  bitwise equal to unsharded at any width) and owner-only scatter-add
  updates. The package's one collective site.
- ``word2vec.py`` / ``deepwalk.py`` — ``ShardedWord2Vec`` and
  ``ShardedDeepWalk``: the single-device trainers' recipes on sharded
  storage, with resumable fits and canonical-row checkpoints in the
  JAX package's formats.

The engine-side twin is ``nn/layers/feedforward.py``'s
``SparseEmbeddingLayer``.
"""

from deeplearning4j_tpu_torch.embeddings.sparse import (
    PAD_ID,
    apply_rows_dense,
    dedup_segment_sum,
    flatten_occurrences,
    rows_grad,
)
from deeplearning4j_tpu_torch.embeddings.table import (
    ShardedEmbeddingTable,
    gauges,
    note_lookup_ms,
    note_rows_touched,
    note_scatter_ms,
    note_shard_bytes,
)

# The trainers build on nlp/ and graph/, which build on sparse.py: they
# load on first use, so importing either side first works.
_TRAINERS = {
    "ShardedDeepWalk": "deepwalk",
    "ShardedGraphLookupTable": "deepwalk",
    "ShardedLookupTable": "word2vec",
    "ShardedWord2Vec": "word2vec",
}


def __getattr__(name):
    if name in _TRAINERS:
        import importlib

        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.embeddings.{_TRAINERS[name]}")
        return getattr(mod, name)
    raise AttributeError(name)

__all__ = [
    "PAD_ID",
    "ShardedDeepWalk",
    "ShardedEmbeddingTable",
    "ShardedGraphLookupTable",
    "ShardedLookupTable",
    "ShardedWord2Vec",
    "apply_rows_dense",
    "dedup_segment_sum",
    "flatten_occurrences",
    "gauges",
    "note_lookup_ms",
    "note_rows_touched",
    "note_scatter_ms",
    "note_shard_bytes",
    "rows_grad",
]

"""Cluster-scale NLP training — the dl4j-spark-nlp analog (reference
``spark/dl4j-spark-nlp``: ``TextPipeline.java:1`` accumulator-built
vocab, ``spark/models/embeddings/word2vec/Word2Vec.java:1``
map-partitions training with accumulator-merged updates,
``glove/Glove.java`` + ``CoOccurrenceCalculator``).

Counterpart of ``deeplearning4j_tpu/parallel/cluster_nlp.py``. Where
Spark shards sentences across executors and merges per-partition vocab
counters and parameter updates over the shuffle network, here

- the **vocab build** counts partitions of the corpus independently
  and merges them (the accumulator pattern, on a host thread pool), and
- the **training batch is split over the ranks** of the port's mesh
  (``parallel/mesh.py``; the JAX package shards it over the mesh's
  ``data`` axis): rank ``r`` computes the loss and row gradients of its
  contiguous rows of each batch; the per-occurrence row gradients of
  every rank come back through the ``all_reduce``-only exchange
  (``parallel/row_exchange.RankSplit``), laid out as one process lays
  them out, and every rank folds the same global list in the same
  order into its replicated tables. So the ranks' tables stay equal,
  and equal single-process training on the same batches: each
  occurrence's gradient is computed the same way from the same rows,
  and the fold sums them in the one-process order.

The batch size rounds up to a multiple of the ranks, as in the JAX
package. The cluster Word2Vec trains on the host-pair routes (chunked
or per batch); the device-generation route stays single-process.
"""

from __future__ import annotations

from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Sequence

import numpy as np

from deeplearning4j_tpu_torch.embeddings import sparse
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors, Word2Vec
from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
from deeplearning4j_tpu_torch.parallel.row_exchange import RankSplit


class TextPipeline:
    """Partitioned vocab construction (reference ``TextPipeline.java``:
    tokenize + per-partition word counts merged through Spark
    accumulators). Counting runs one task per partition and merges the
    partial Counters — the accumulator merge — so behavior matches the
    reference pipeline shape; on one host the tasks run on a thread
    pool (corpus IO dominates; the merge semantics are what carry to
    multi-host)."""

    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory=None, n_partitions: int = 4):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory
        self.n_partitions = max(int(n_partitions), 1)

    def _tokens_of(self, sentence) -> List[str]:
        if isinstance(sentence, str):
            if self.tokenizer_factory is not None:
                return self.tokenizer_factory.create(
                    sentence
                ).get_tokens()
            return sentence.split()
        return list(sentence)

    def build_vocab(self, sentences: Iterable) -> VocabCache:
        corpus = [self._tokens_of(s) for s in sentences]
        parts = [
            corpus[i::self.n_partitions] for i in range(self.n_partitions)
        ]

        def count(part) -> Counter:
            c: Counter = Counter()
            for toks in part:
                c.update(toks)
            return c

        with ThreadPoolExecutor(max_workers=self.n_partitions) as ex:
            partials = list(ex.map(count, parts))
        merged: Counter = Counter()
        for c in partials:  # accumulator merge
            merged.update(c)
        cache = VocabCache()
        for word, n in sorted(
            merged.items(), key=lambda kv: (-kv[1], kv[0])
        ):
            if n >= self.min_word_frequency:
                cache.add(VocabWord(word, n))
        cache.total_word_count = sum(w.count for w in cache.words)
        return cache

    def to_id_sequences(self, sentences: Iterable,
                        cache: VocabCache) -> List[np.ndarray]:
        return [
            np.asarray(
                [cache.index_of(t) for t in self._tokens_of(s)
                 if t in cache],
                np.int32,
            )
            for s in sentences
        ]


def _rank_split(trainer, mesh) -> None:
    """The mesh of ``trainer`` (its device's world of one without a
    group), its batch size rounded up to a multiple of the ranks, and
    its split of each batch over them."""
    trainer.mesh = mesh if mesh is not None else build_mesh(
        device=trainer.device)
    dp = trainer.mesh.data
    if trainer.batch_size % dp:
        # round the batch up so it splits over the ranks
        trainer.batch_size += dp - trainer.batch_size % dp
    trainer._split = (RankSplit(dp, trainer.mesh.rank) if dp > 1
                      else sparse.LOCAL)


class _MeshBatchMixin:
    """Splits every batch over the mesh's ranks and keeps the tables
    replicated (every rank draws them from the same seed); the
    inherited steps fold the whole batch's row gradients on every
    rank."""

    # the chunked epoch runs the same split steps, so the bypassed
    # _apply_batch override is fine here
    scan_path_compatible = True

    def _init_mesh(self, mesh) -> None:
        _rank_split(self, mesh)
        self.device_epoch_gen = False  # the host-pair routes


class ClusterWord2Vec(_MeshBatchMixin, Word2Vec):
    """Data-parallel Word2Vec over the ranks of a mesh (reference
    ``spark/models/embeddings/word2vec/Word2Vec.java`` — Spark's
    FirstIterationFunction/SecondIterationFunction become one step a
    batch with the row exchange)."""

    def __init__(self, cache, sentences_ids, mesh=None, **kw):
        super().__init__(cache, sentences_ids, **kw)
        self._init_mesh(mesh)


class ClusterSequenceVectors(_MeshBatchMixin, SequenceVectors):
    """Rank-split generic SequenceVectors (DeepWalk-style callers)."""

    def __init__(self, cache, sequences: Sequence[np.ndarray],
                 mesh=None, **kw):
        super().__init__(cache, **kw)
        self._seqs = list(sequences)
        self._init_mesh(mesh)

    def _sequences(self):
        return iter(self._seqs)


class ClusterGlove(Glove):
    """Data-parallel GloVe (reference ``spark/glove/Glove.java`` +
    ``CoOccurrenceCalculator`` — the co-occurrence count is the host
    pass; each AdaGrad batch is split over the ranks and its row
    gradients folded whole on every rank)."""

    def __init__(self, cache, id_sequences, mesh=None, **kw):
        super().__init__(cache, id_sequences, **kw)
        _rank_split(self, mesh)

"""Similarity / nearest-word utilities over a trained embedding model
(reference ``models/embeddings/reader/impl/BasicModelUtils.java``,
``FlatModelUtils.java``, ``TreeModelUtils.java:1`` — the pluggable
``ModelUtils`` SPI behind ``wordsNearest``).

- ``FlatModelUtils``: exact brute-force cosine scan (one [V, D] @ [D]
  matvec on the host, exact).
- ``BasicModelUtils``: flat scan + the reference's extras
  (``words_nearest_sum`` analogy arithmetic, similarity).
- ``TreeModelUtils``: VPTree-backed approximate k-NN over normalized
  vectors (reference builds the tree once and searches it; right call
  for repeated queries over very large vocabs on host).

Counterpart of ``deeplearning4j_tpu/nlp/model_utils.py``: host numpy
over the port's models (``nlp/serializer._resolve`` reads a table on
any device back to the host).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree


def _resolve(model) -> Tuple:
    """(cache, matrix) from a trained model / lookup / pair (same duck
    typing as nlp.serializer)."""
    from deeplearning4j_tpu_torch.nlp.serializer import _resolve as r

    return r(model)


class BasicModelUtils:
    """Exact cosine utilities (reference ``BasicModelUtils.java``)."""

    def __init__(self, model=None):
        self.cache = None
        self._m = None
        self._norm = None
        if model is not None:
            self.init(model)

    def init(self, model) -> None:
        self.cache, m = _resolve(model)
        self._m = np.asarray(m, np.float32)
        norms = np.linalg.norm(self._m, axis=1, keepdims=True)
        self._norm = self._m / np.maximum(norms, 1e-12)

    def similarity(self, a: str, b: str) -> float:
        ia, ib = self.cache.index_of(a), self.cache.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        return float(self._norm[ia] @ self._norm[ib])

    def words_nearest(self, word_or_vec, n: int = 10,
                      exclude: Sequence[str] = ()) -> List[str]:
        if isinstance(word_or_vec, str):
            i = self.cache.index_of(word_or_vec)
            if i < 0:
                return []
            v = self._norm[i]
            exclude = set(exclude) | {word_or_vec}
        else:
            v = np.asarray(word_or_vec, np.float32)
            nv = np.linalg.norm(v)
            v = v / max(nv, 1e-12)
            exclude = set(exclude)
        sims = self._norm @ v
        order = np.argsort(-sims)
        out = []
        for idx in order:
            w = self.cache.word_at(int(idx))
            if w in exclude:
                continue
            out.append(w)
            if len(out) >= n:
                break
        return out

    def words_nearest_sum(self, positive: Sequence[str],
                          negative: Sequence[str] = (),
                          n: int = 10) -> List[str]:
        """king - man + woman analogy arithmetic (reference
        ``wordsNearestSum``)."""
        v = np.zeros((self._m.shape[1],), np.float32)
        for w in positive:
            i = self.cache.index_of(w)
            if i >= 0:
                v += self._norm[i]
        for w in negative:
            i = self.cache.index_of(w)
            if i >= 0:
                v -= self._norm[i]
        return self.words_nearest(
            v, n, exclude=list(positive) + list(negative)
        )


class FlatModelUtils(BasicModelUtils):
    """Alias — the flat scan IS the basic implementation here
    (reference keeps them separate because BasicModelUtils adds
    adagrad-aware lookups)."""


class TreeModelUtils(BasicModelUtils):
    """VPTree-backed nearest words (reference
    ``TreeModelUtils.java`` — builds the tree lazily on first query)."""

    def __init__(self, model=None, seed: int = 12345):
        self._tree: Optional[VPTree] = None
        self._seed = seed
        super().__init__(model)

    def init(self, model) -> None:
        super().init(model)
        self._tree = None

    def _ensure_tree(self) -> None:
        if self._tree is None:
            self._tree = VPTree(
                self._norm, similarity_function="cosinesimilarity",
                invert=True, seed=self._seed,
            )

    def words_nearest(self, word_or_vec, n: int = 10,
                      exclude: Sequence[str] = ()) -> List[str]:
        self._ensure_tree()
        if isinstance(word_or_vec, str):
            i = self.cache.index_of(word_or_vec)
            if i < 0:
                return []
            v = self._norm[i]
            exclude = set(exclude) | {word_or_vec}
        else:
            v = np.asarray(word_or_vec, np.float32)
            v = v / max(np.linalg.norm(v), 1e-12)
            exclude = set(exclude)
        # over-fetch to survive the exclusions, then filter
        k = min(n + len(exclude) + 1, self._norm.shape[0])
        idxs, _ = self._tree.search(v, k)
        out = []
        for idx in idxs:
            w = self.cache.word_at(int(idx))
            if w in exclude:
                continue
            out.append(w)
            if len(out) >= n:
                break
        return out

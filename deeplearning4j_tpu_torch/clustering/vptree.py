"""Vantage-point tree (reference ``clustering/vptree/VPTree.java``):
metric-space k-NN index used by the UI nearest-neighbor view and
``TreeModelUtils.wordsNearest``. Distances to candidate sets are
computed as vectorized numpy batches rather than the reference's
per-pair ``CounterMap`` accounting.

Counterpart of ``deeplearning4j_tpu/clustering/vptree.py``: host numpy,
the same code."""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

EUCLIDEAN = "euclidean"
COSINE = "cosinesimilarity"


@dataclass
class DataPoint:
    """Indexed point (reference ``clustering/sptree/DataPoint.java``)."""

    index: int
    point: np.ndarray


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


class VPTree:
    """VP-tree over items [N, D] (reference ``VPTree.java``;
    similarity 'euclidean' or 'cosinesimilarity' with ``invert``
    flipping sign so larger-similarity = nearer)."""

    def __init__(self, items, similarity_function: str = EUCLIDEAN,
                 invert: bool = False, seed: int = 12345):
        if isinstance(items, list) and items and isinstance(
            items[0], DataPoint
        ):
            self.items = np.stack([p.point for p in items]).astype(
                np.float64
            )
        else:
            self.items = np.asarray(items, np.float64)
        if similarity_function not in (EUCLIDEAN, COSINE):
            raise ValueError(
                f"unknown similarity {similarity_function!r}; expected "
                f"{EUCLIDEAN!r} or {COSINE!r}"
            )
        self.similarity_function = similarity_function
        self.invert = invert
        self._rng = np.random.RandomState(seed)
        if self.similarity_function == COSINE:
            norms = np.linalg.norm(self.items, axis=1, keepdims=True)
            self._normed = self.items / np.maximum(norms, 1e-12)
        self.root = self._build(np.arange(len(self.items)))

    # -- distances ------------------------------------------------------

    def _dist(self, idx: int, candidates: np.ndarray) -> np.ndarray:
        """Distance from item idx to a batch of item indices."""
        return self._dist_vec(self.items[idx], candidates)

    def _dist_vec(self, q: np.ndarray, candidates: np.ndarray) -> np.ndarray:
        pts = self.items[candidates]
        if self.similarity_function == EUCLIDEAN:
            d = np.linalg.norm(pts - q[None, :], axis=1)
        else:
            # cosine is already converted to a dissimilarity here, so
            # `invert` must NOT flip it again (smaller = more similar)
            qn = q / max(float(np.linalg.norm(q)), 1e-12)
            d = 1.0 - self._normed[candidates] @ qn
        if self.invert and self.similarity_function == EUCLIDEAN:
            d = -d
        return d

    def _dist_point(self, q: np.ndarray, idx: int) -> float:
        return float(self._dist_vec(q, np.asarray([idx]))[0])

    # -- build ----------------------------------------------------------

    def _build(self, indices: np.ndarray) -> Optional[_VPNode]:
        if len(indices) == 0:
            return None
        vp_pos = self._rng.randint(len(indices))
        vp = int(indices[vp_pos])
        rest = np.delete(indices, vp_pos)
        node = _VPNode(vp)
        if len(rest) == 0:
            return node
        d = self._dist(vp, rest)
        node.threshold = float(np.median(d))
        inside = rest[d < node.threshold]
        outside = rest[d >= node.threshold]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    # -- search ---------------------------------------------------------

    def search(self, target, k: int) -> Tuple[List[int], List[float]]:
        """(indices, distances) of the k nearest items (reference
        ``VPTree.search(DataPoint, k, results, distances)``)."""
        q = np.asarray(
            target.point if isinstance(target, DataPoint) else target,
            np.float64,
        )
        if self.invert or self.similarity_function == COSINE:
            # negated distance and 1-cos both violate the triangle
            # inequality, so the tree's pruning bounds don't hold —
            # rank the whole set vectorized instead (one matmul)
            d = self._dist_vec(q, np.arange(len(self.items)))
            order = np.argsort(d, kind="stable")[:k]
            return order.tolist(), d[order].tolist()
        heap: List[Tuple[float, int]] = []  # max-heap via negation
        tau = [np.inf]

        def visit(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist_point(q, node.index)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                visit(node.inside)
                if d + tau[0] >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        pairs = sorted([(-negd, i) for negd, i in heap], key=lambda t: t[0])
        return [i for _, i in pairs], [d for d, _ in pairs]

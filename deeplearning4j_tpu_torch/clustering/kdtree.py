"""KD-tree (reference ``clustering/kdtree/KDTree.java`` +
``HyperRect.java``): host-side spatial index for exact nearest
neighbors in low dimension.

Counterpart of ``deeplearning4j_tpu/clustering/kdtree.py``: host numpy,
the same code."""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class HyperRect:
    """Axis-aligned bounding box (reference ``HyperRect.java``)."""

    def __init__(self, lower: np.ndarray, upper: np.ndarray):
        self.lower = np.asarray(lower, np.float64)
        self.upper = np.asarray(upper, np.float64)

    @staticmethod
    def infinite(dims: int) -> "HyperRect":
        return HyperRect(np.full(dims, -np.inf), np.full(dims, np.inf))

    def contains(self, point: np.ndarray) -> bool:
        return bool(
            np.all(point >= self.lower) and np.all(point <= self.upper)
        )

    def min_distance(self, point: np.ndarray) -> float:
        clipped = np.clip(point, self.lower, self.upper)
        return float(np.linalg.norm(point - clipped))

    def get_lower(self, point: np.ndarray, dim: int) -> "HyperRect":
        upper = self.upper.copy()
        upper[dim] = point[dim]
        return HyperRect(self.lower, upper)

    def get_upper(self, point: np.ndarray, dim: int) -> "HyperRect":
        lower = self.lower.copy()
        lower[dim] = point[dim]
        return HyperRect(lower, self.upper)


class _Node:
    __slots__ = ("point", "left", "right")

    def __init__(self, point: np.ndarray):
        self.point = point
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


class KDTree:
    """Insert-based KD-tree with nn / knn queries (reference
    ``KDTree.java`` — ``insert``, ``nn``, ``knn``)."""

    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    def insert(self, point) -> None:
        point = np.asarray(point, np.float64)
        if point.shape[-1] != self.dims:
            raise ValueError(
                f"point dim {point.shape[-1]} != tree dim {self.dims}"
            )
        self.size += 1
        if self.root is None:
            self.root = _Node(point)
            return
        node, depth = self.root, 0
        while True:
            dim = depth % self.dims
            if point[dim] < node.point[dim]:
                if node.left is None:
                    node.left = _Node(point)
                    return
                node = node.left
            else:
                if node.right is None:
                    node.right = _Node(point)
                    return
                node = node.right
            depth += 1

    def nn(self, point) -> Tuple[float, np.ndarray]:
        """(distance, nearest point)."""
        res = self.knn(point, 1)
        return res[0]

    def knn(self, point, k: int) -> List[Tuple[float, np.ndarray]]:
        """k nearest as [(distance, point)] ascending."""
        point = np.asarray(point, np.float64)
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap via neg
        counter = [0]

        def visit(node: Optional[_Node], depth: int):
            if node is None:
                return
            d = float(np.linalg.norm(point - node.point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, counter[0], node.point))
                counter[0] += 1
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, counter[0], node.point))
                counter[0] += 1
            dim = depth % self.dims
            diff = point[dim] - node.point[dim]
            near, far = (
                (node.left, node.right) if diff < 0
                else (node.right, node.left)
            )
            visit(near, depth + 1)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far, depth + 1)

        visit(self.root, 0)
        return sorted([(-negd, p) for negd, _, p in heap],
                      key=lambda t: t[0])

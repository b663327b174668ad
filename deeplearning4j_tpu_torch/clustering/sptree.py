"""Space-partitioning tree (reference
``clustering/sptree/SpTree.java`` + ``Cell.java``): the Barnes-Hut
approximation structure behind ``BarnesHutTsne`` — each node stores a
center of mass; distant cells act as one superpoint when
width/distance < theta.

Counterpart of ``deeplearning4j_tpu/clustering/sptree.py``: host numpy,
as there, so the forces are the JAX package's bit for bit."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Cell:
    """Axis-aligned cell: center + half-width per dim (reference
    ``clustering/sptree/Cell.java``)."""

    def __init__(self, center: np.ndarray, width: np.ndarray):
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)

    def contains(self, point: np.ndarray) -> bool:
        return bool(np.all(np.abs(point - self.center) <= self.width))


class SPTree:
    """Reference ``SpTree.java``: build over data [N, D], then
    ``compute_non_edge_forces`` per point (repulsive term) and the
    static ``compute_edge_forces`` over the sparse P (attractive
    term)."""

    NODE_CAPACITY = 1

    def __init__(self, data: np.ndarray,
                 cell: Optional[Cell] = None,
                 indices: Optional[np.ndarray] = None):
        self.data = np.asarray(data, np.float64)
        n, d = self.data.shape
        self.dims = d
        if cell is None:
            mins = self.data.min(axis=0)
            maxs = self.data.max(axis=0)
            center = (mins + maxs) / 2.0
            width = (maxs - mins) / 2.0 + 1e-5
            cell = Cell(center, width)
        self.cell = cell
        self.children: List[Optional[SPTree]] = [None] * (2 ** d)
        self.is_leaf = True
        self.cum_size = 0
        self.center_of_mass = np.zeros(d)
        self.point_index = -1  # index stored at this leaf
        if indices is None:
            indices = np.arange(n)
        for i in indices:
            self.insert(int(i))

    # -- construction ---------------------------------------------------

    def _child_slot(self, point: np.ndarray) -> int:
        slot = 0
        for dim in range(self.dims):
            if point[dim] > self.cell.center[dim]:
                slot |= 1 << dim
        return slot

    def _child_cell(self, slot: int) -> Cell:
        half = self.cell.width / 2.0
        center = self.cell.center.copy()
        for dim in range(self.dims):
            center[dim] += half[dim] if (slot >> dim) & 1 else -half[dim]
        return Cell(center, half)

    def insert(self, index: int) -> bool:
        point = self.data[index]
        if not self.cell.contains(point):
            return False
        self.cum_size += 1
        # online center-of-mass update
        self.center_of_mass += (point - self.center_of_mass) / self.cum_size
        if self.is_leaf and self.point_index < 0:
            self.point_index = index
            return True
        # duplicate point: keep weight in cum_size, don't subdivide
        if self.is_leaf and np.array_equal(
            self.data[self.point_index], point
        ):
            return True
        if self.is_leaf:
            self._subdivide()
        return self._insert_child(index)

    def _subdivide(self) -> None:
        old = self.point_index
        self.is_leaf = False
        self.point_index = -1
        self._insert_child(old)

    def _insert_child(self, index: int) -> bool:
        slot = self._child_slot(self.data[index])
        if self.children[slot] is None:
            child = SPTree.__new__(SPTree)
            child.data = self.data
            child.dims = self.dims
            child.cell = self._child_cell(slot)
            child.children = [None] * (2 ** self.dims)
            child.is_leaf = True
            child.cum_size = 0
            child.center_of_mass = np.zeros(self.dims)
            child.point_index = -1
            self.children[slot] = child
        return self.children[slot].insert(index)

    # -- forces ---------------------------------------------------------

    def compute_non_edge_forces(self, index: int, theta: float,
                                neg_f: np.ndarray) -> float:
        """Accumulate the repulsive force on point ``index`` into
        ``neg_f``; returns this subtree's contribution to sum_Q
        (reference ``SpTree.computeNonEdgeForces``)."""
        if self.cum_size == 0:
            return 0.0
        point = self.data[index]
        if self.is_leaf and self.point_index == index \
                and self.cum_size == 1:
            return 0.0
        diff = point - self.center_of_mass
        dist2 = float(diff @ diff)
        max_width = float(np.max(self.cell.width * 2.0))
        if self.is_leaf or (
            dist2 > 0 and max_width / np.sqrt(dist2) < theta
        ):
            # treat cell as a single superpoint of weight cum_size
            weight = self.cum_size
            if self.is_leaf and self.point_index == index:
                weight -= 1  # exclude self from own leaf
                if weight == 0:
                    return 0.0
            q = 1.0 / (1.0 + dist2)
            qz = weight * q
            neg_f += qz * q * diff
            return qz
        total = 0.0
        for child in self.children:
            if child is not None:
                total += child.compute_non_edge_forces(index, theta, neg_f)
        return total

    @staticmethod
    def compute_edge_forces(data: np.ndarray, rows: np.ndarray,
                            cols: np.ndarray, vals: np.ndarray,
                            pos_f: np.ndarray) -> None:
        """Attractive term over sparse symmetric P in CSR (rows[n+1],
        cols, vals), vectorized (reference
        ``SpTree.computeEdgeForces``)."""
        n = data.shape[0]
        counts = rows[1:] - rows[:-1]
        src = np.repeat(np.arange(n), counts)
        diff = data[src] - data[cols]                   # [nnz, D]
        q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))   # [nnz]
        w = (vals * q)[:, None] * diff
        np.add.at(pos_f, src, w)


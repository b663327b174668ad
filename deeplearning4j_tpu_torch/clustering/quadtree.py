"""2-D quadtree (reference ``clustering/quadtree/QuadTree.java`` +
``Cell.java``): the dedicated two-dimensional Barnes-Hut structure
(the t-SNE paper's original formulation, arXiv:1301.3342) alongside
the d-dimensional ``SPTree``. Each node tracks a center of mass and a
cumulative size; distant quads act as one superpoint when
max(cell extent) / distance < theta.

Net-new vs the reference: ``knn`` best-first nearest-neighbour queries
over the same structure (the reference exposes KNN only through
KDTree/VPTree; a 2-D embedding viewer wants it here too).

Counterpart of ``deeplearning4j_tpu/clustering/quadtree.py``: host
numpy, as there, so the tree, its forces and its queries are the JAX
package's bit for bit.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

NODE_CAPACITY = 1  # reference QT_NODE_CAPACITY


class Cell:
    """Axis-aligned quad: center (x, y) + half-width / half-height
    (reference ``clustering/quadtree/Cell.java``)."""

    def __init__(self, x: float, y: float, hw: float, hh: float):
        self.x = float(x)
        self.y = float(y)
        self.hw = float(hw)
        self.hh = float(hh)

    def contains(self, point: np.ndarray) -> bool:
        # reference Cell.containsPoint: closed lower, open-ish upper
        # bounds via <=; symmetric about the center
        return bool(
            self.x - self.hw <= point[0] <= self.x + self.hw
            and self.y - self.hh <= point[1] <= self.y + self.hh
        )

    def min_sq_dist(self, point: np.ndarray) -> float:
        """Squared distance from ``point`` to the nearest point of the
        cell (0 inside) — the KNN pruning bound."""
        dx = max(abs(point[0] - self.x) - self.hw, 0.0)
        dy = max(abs(point[1] - self.y) - self.hh, 0.0)
        return dx * dx + dy * dy


class QuadTree:
    """Reference ``QuadTree.java``: build over data [N, 2], then
    ``compute_non_edge_forces`` (repulsive Barnes-Hut term) and
    ``compute_edge_forces`` (attractive term over sparse P)."""

    def __init__(self, data: np.ndarray,
                 cell: Optional[Cell] = None,
                 _fill: bool = True):
        data = np.asarray(data, np.float64)
        if data.ndim != 2 or data.shape[1] != 2:
            raise ValueError(
                f"QuadTree is 2-D only (reference QT_NO_DIMS=2); got "
                f"shape {data.shape}"
            )
        self.data = data
        if cell is None:
            mean = data.mean(axis=0)
            mins = data.min(axis=0)
            maxs = data.max(axis=0)
            # reference: half-extent = max one-sided spread + eps
            hw = max(maxs[0] - mean[0], mean[0] - mins[0]) + 1e-5
            hh = max(maxs[1] - mean[1], mean[1] - mins[1]) + 1e-5
            cell = Cell(mean[0], mean[1], hw, hh)
        self.boundary = cell
        self.nw: Optional[QuadTree] = None
        self.ne: Optional[QuadTree] = None
        self.sw: Optional[QuadTree] = None
        self.se: Optional[QuadTree] = None
        self.is_leaf = True
        self.size = 0
        self.cum_size = 0
        self.dup_weight = 0  # absorbed duplicates of the stored point
        self.center_of_mass = np.zeros(2)
        self.indices = np.full(NODE_CAPACITY, -1, np.int64)
        if _fill:
            for i in range(len(data)):
                self.insert(int(i))

    # -- construction ---------------------------------------------------

    def _child_for(self, point: np.ndarray) -> "QuadTree":
        """Pick the quadrant of ``point`` (reference ``findIndex``;
        the split is the cell CENTER — our cells store center +
        half-extent, so the reference's ``x + hw/2`` edge-convention
        arithmetic reduces to plain x/y here)."""
        left = point[0] <= self.boundary.x
        top = point[1] <= self.boundary.y
        if left:
            return self.nw if top else self.sw
        return self.ne if top else self.se

    def insert(self, new_index: int) -> bool:
        point = self.data[new_index]
        if not self.boundary.contains(point):
            return False
        # running center of mass (reference insert: incremental mean)
        self.cum_size += 1
        m1 = (self.cum_size - 1) / self.cum_size
        self.center_of_mass = (
            self.center_of_mass * m1 + point / self.cum_size
        )
        if self.is_leaf and self.size < NODE_CAPACITY:
            self.indices[self.size] = new_index
            self.size += 1
            return True
        # duplicate point: count it in cum_size/center but store once;
        # dup_weight rides along so subdivision doesn't strand the
        # absorbed mass at what becomes an internal node
        for i in range(self.size):
            if np.array_equal(self.data[self.indices[i]], point):
                self.dup_weight += 1
                return True
        if self.is_leaf:
            self._subdivide()
        if self._child_for(point).insert(new_index):
            return True
        # float boundary edge cases: try the remaining quads
        # (reference ``insertIntoOneOf``)
        return any(c.insert(new_index) for c in self._children())

    def _subdivide(self) -> None:
        b = self.boundary
        hw, hh = b.hw / 2, b.hh / 2
        mk = lambda cx, cy: QuadTree(
            self.data, Cell(cx, cy, hw, hh), _fill=False
        )
        self.nw = mk(b.x - hw, b.y - hh)
        self.ne = mk(b.x + hw, b.y - hh)
        self.sw = mk(b.x - hw, b.y + hh)
        self.se = mk(b.x + hw, b.y + hh)
        self.is_leaf = False
        # re-home the points stored at this node, carrying any
        # absorbed duplicate mass with the stored point (same
        # location, so the child's center of mass is unchanged)
        for i in range(self.size):
            idx = int(self.indices[i])
            child = self._child_for(self.data[idx])
            child.insert(idx)
            if self.dup_weight:
                child.cum_size += self.dup_weight
                child.dup_weight += self.dup_weight
        self.dup_weight = 0
        self.size = 0

    def _children(self) -> List["QuadTree"]:
        return [c for c in (self.nw, self.ne, self.sw, self.se)
                if c is not None]

    # -- validation / introspection -------------------------------------

    def is_correct(self) -> bool:
        for i in range(self.size):
            if not self.boundary.contains(self.data[self.indices[i]]):
                return False
        return self.is_leaf or all(
            c.is_correct() for c in self._children()
        )

    def depth(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + max(c.depth() for c in self._children())

    # -- Barnes-Hut forces (t-SNE) ---------------------------------------

    def compute_non_edge_forces(self, point_index: int, theta: float,
                                negative_force: np.ndarray) -> float:
        """Accumulate the repulsive force on ``point_index`` into
        ``negative_force`` ([2] array, mutated); returns this node's
        contribution to sum_Q (reference passes an AtomicDouble)."""
        if self.cum_size == 0:
            return 0.0
        weight = self.cum_size
        if (self.is_leaf and self.size == 1
                and self.indices[0] == point_index):
            # own leaf: exclude self but keep absorbed duplicates —
            # they are distinct points that still repel (same
            # ``weight = cum_size - 1`` discipline as SPTree;
            # the reference's early return drops them from sum_Q)
            weight -= 1
            if weight == 0:
                return 0.0
        buf = self.data[point_index] - self.center_of_mass
        dist_sq = float(buf @ buf)
        if self.is_leaf or (
            max(self.boundary.hh, self.boundary.hw)
            / np.sqrt(max(dist_sq, 1e-300)) < theta
        ):
            q = 1.0 / (1.0 + dist_sq)
            mult = weight * q
            sum_q = mult
            negative_force += buf * (mult * q)
            return sum_q
        return sum(
            c.compute_non_edge_forces(point_index, theta, negative_force)
            for c in self._children()
        )

    def compute_edge_forces(self, row_p: np.ndarray, col_p: np.ndarray,
                            val_p: np.ndarray, n: int,
                            pos_f: np.ndarray) -> None:
        """Attractive forces over the CSR sparse P (reference
        ``computeEdgeForces``); ``pos_f`` [N, 2] is accumulated in
        place. Delegates to the vectorized SPTree implementation —
        same t-SNE attractive term val·(y_i-y_j)/(1+d²). (The
        reference's QuadTree divides by d² with no +1, which blows up
        on near-duplicate points; its own SpTree and van der Maaten's
        original both use 1+d² — deliberate fix, not an omission.)"""
        from deeplearning4j_tpu_torch.clustering.sptree import SPTree

        row_p = np.asarray(row_p)
        if row_p.ndim != 1:
            raise ValueError("row_p must be a vector")
        SPTree.compute_edge_forces(
            self.data[:n], row_p, np.asarray(col_p),
            np.asarray(val_p), pos_f,
        )

    # -- KNN --------------------------------------------------------------

    def knn(self, point: np.ndarray, k: int = 1
            ) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest neighbours of ``point`` by best-first traversal
        with cell-distance pruning. Returns (indices, distances),
        nearest first."""
        point = np.asarray(point, np.float64)
        heap: List[Tuple[float, int, QuadTree]] = []
        tiebreak = 0
        heapq.heappush(heap, (0.0, tiebreak, self))
        best: List[Tuple[float, int]] = []  # (-dist_sq, index) max-heap
        while heap:
            bound, _, node = heapq.heappop(heap)
            if len(best) == k and bound > -best[0][0]:
                break
            if node.is_leaf:
                for i in range(node.size):
                    idx = int(node.indices[i])
                    diff = self.data[idx] - point
                    d = float(diff @ diff)
                    if len(best) < k:
                        heapq.heappush(best, (-d, idx))
                    elif d < -best[0][0]:
                        heapq.heapreplace(best, (-d, idx))
            else:
                for c in node._children():
                    if c.cum_size == 0:
                        continue
                    tiebreak += 1
                    heapq.heappush(
                        heap,
                        (c.boundary.min_sq_dist(point), tiebreak, c),
                    )
        out = sorted(((-d, i) for d, i in best))
        idxs = np.asarray([i for _, i in out], np.int64)
        dists = np.sqrt(np.asarray([d for d, _ in out]))
        return idxs, dists

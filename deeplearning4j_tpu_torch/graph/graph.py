"""Adjacency-list graph with a CSR view for vectorized walks
(reference ``graph/graph/Graph.java`` — same add-edge / degree /
random-neighbor API, but edges compile into CSR (offsets, targets,
weights) numpy arrays so that thousands of random walks are generated
in one vectorized sweep instead of per-step ``Random.nextInt`` calls).
Counterpart of ``deeplearning4j_tpu/graph/graph.py``, copied as it is.
"""

from __future__ import annotations

from typing import Generic, List, Optional, Sequence, TypeVar

import numpy as np

from deeplearning4j_tpu_torch.graph.api import (
    Edge,
    NoEdgeHandling,
    NoEdgesException,
    Vertex,
)

V = TypeVar("V")


class Graph(Generic[V]):
    """Graph with vertices indexed 0..n-1 (reference
    ``graph/graph/Graph.java``). Undirected edges are stored in both
    adjacency lists, matching the reference's behavior."""

    def __init__(self, n_vertices: int, allow_multiple_edges: bool = False,
                 vertex_values: Optional[Sequence[V]] = None):
        if n_vertices <= 0:
            raise ValueError("n_vertices must be positive")
        self.n_vertices = n_vertices
        self.allow_multiple_edges = allow_multiple_edges
        self._values: List[Optional[V]] = (
            list(vertex_values) if vertex_values is not None
            else [None] * n_vertices
        )
        if len(self._values) != n_vertices:
            raise ValueError("vertex_values length != n_vertices")
        self._adj: List[List[Edge]] = [[] for _ in range(n_vertices)]
        self._csr = None  # (offsets, targets, weights), built lazily
        self._weighted_tables = None  # (cum, base, totals), built lazily

    # -- construction ---------------------------------------------------

    def add_edge(self, from_idx: int, to_idx: int, weight: float = 1.0,
                 directed: bool = False) -> None:
        if not (0 <= from_idx < self.n_vertices
                and 0 <= to_idx < self.n_vertices):
            raise ValueError(
                f"edge ({from_idx},{to_idx}) out of range for "
                f"{self.n_vertices} vertices"
            )
        if self.allow_multiple_edges:
            add_fwd = True
            add_rev = not directed and from_idx != to_idx
        else:
            # dedupe each direction independently, so an earlier
            # directed edge doesn't swallow a later undirected
            # request's reverse half
            add_fwd = not any(
                ex.to_idx == to_idx for ex in self._adj[from_idx]
            )
            add_rev = (
                not directed and from_idx != to_idx
                and not any(
                    ex.to_idx == from_idx for ex in self._adj[to_idx]
                )
            )
        if add_fwd:
            self._adj[from_idx].append(
                Edge(from_idx, to_idx, weight, directed)
            )
        if add_rev:
            self._adj[to_idx].append(Edge(to_idx, from_idx, weight, False))
        if add_fwd or add_rev:
            self._csr = None
            self._weighted_tables = None

    def add_edges(self, edges: Sequence[Edge]) -> None:
        for e in edges:
            self.add_edge(e.from_idx, e.to_idx, e.weight, e.directed)

    # -- queries --------------------------------------------------------

    def num_vertices(self) -> int:
        return self.n_vertices

    def get_vertex(self, idx: int) -> Vertex[V]:
        return Vertex(idx, self._values[idx])

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def get_edges_out(self, idx: int) -> List[Edge]:
        return list(self._adj[idx])

    def get_connected_vertex_indices(self, idx: int) -> np.ndarray:
        return np.asarray(
            [e.to_idx for e in self._adj[idx]], dtype=np.int32
        )

    def degrees(self) -> np.ndarray:
        return np.asarray(
            [len(a) for a in self._adj], dtype=np.int32
        )

    def random_connected_vertex(self, idx: int,
                                rng: np.random.RandomState) -> int:
        adj = self._adj[idx]
        if not adj:
            raise NoEdgesException(f"vertex {idx} has no edges")
        return adj[rng.randint(len(adj))].to_idx

    # -- CSR view for vectorized walks ----------------------------------

    def csr(self):
        """(offsets[n+1], targets[E], weights[E]) int32/int32/float32 —
        the flat neighbor table every vectorized walk indexes into."""
        if self._csr is None:
            deg = self.degrees()
            offsets = np.zeros(self.n_vertices + 1, np.int64)
            np.cumsum(deg, out=offsets[1:])
            targets = np.empty(int(offsets[-1]), np.int32)
            weights = np.empty(int(offsets[-1]), np.float32)
            for i, adj in enumerate(self._adj):
                s = int(offsets[i])
                for j, e in enumerate(adj):
                    targets[s + j] = e.to_idx
                    weights[s + j] = e.weight
            self._csr = (offsets, targets, weights)
        return self._csr

    def weighted_sampling_tables(self):
        """(cum[E], base[n], totals[n]) float64 inverse-CDF tables for
        weighted neighbor sampling; cached per graph."""
        if self._weighted_tables is None:
            offsets, _, weights = self.csr()
            cum = np.cumsum(weights.astype(np.float64))
            lo, hi = offsets[:-1], offsets[1:]
            base = np.where(lo > 0, cum[np.maximum(lo - 1, 0)], 0.0)
            totals = np.where(hi > lo, cum[np.maximum(hi - 1, 0)] - base,
                              0.0)
            self._weighted_tables = (cum, base, totals)
        return self._weighted_tables


def generate_random_walks(
    graph: Graph, walk_length: int, starts: np.ndarray, seed: int,
    mode: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
    weighted: bool = False,
) -> np.ndarray:
    """Vectorized batch walk generation: [len(starts), walk_length+1]
    int32. All walks advance one step per loop iteration via fancy
    indexing into the CSR table (the vectorized replacement for the
    reference's per-walk ``RandomWalkIterator.next()`` /
    ``WeightedRandomWalkIterator.next()`` scalar loops).

    Disconnected vertices self-loop (SELF_LOOP_ON_DISCONNECTED) or
    raise (EXCEPTION_ON_DISCONNECTED), matching
    ``graph/api/NoEdgeHandling.java`` semantics."""
    offsets, targets, weights = graph.csr()
    deg = (offsets[1:] - offsets[:-1]).astype(np.int64)
    rng = np.random.RandomState(seed)
    n = len(starts)
    walks = np.empty((n, walk_length + 1), np.int32)
    walks[:, 0] = starts
    if walk_length == 0:
        return walks
    disconnected = deg == 0
    if mode is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED and np.any(
        disconnected[starts]
    ):
        raise NoEdgesException(
            "walk started at a vertex with no edges "
            "(NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)"
        )
    if weighted:
        cum, base, totals = graph.weighted_sampling_tables()
    cur = starts.astype(np.int64)
    for step in range(1, walk_length + 1):
        d = deg[cur]
        has_edge = d > 0
        if mode is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED and not np.all(
            has_edge
        ):
            raise NoEdgesException(
                "walk reached a vertex with no edges "
                "(NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)"
            )
        if weighted:
            u = rng.random_sample(n) * totals[cur] + base[cur]
            idx = np.searchsorted(cum, u, side="right")
            idx = np.minimum(idx, offsets[cur + 1] - 1)
            idx = np.maximum(idx, offsets[cur])
        else:
            # uniform neighbor choice; safe dummy for deg=0
            idx = offsets[cur] + (
                rng.random_sample(n) * np.maximum(d, 1)
            ).astype(np.int64)
        nxt = np.where(has_edge, targets[np.minimum(idx, len(targets) - 1)]
                       if len(targets) else cur, cur)
        walks[:, step] = nxt
        cur = nxt.astype(np.int64)
    return walks

"""Walk iterators (reference ``graph/iterator/RandomWalkIterator.java``,
``WeightedRandomWalkIterator.java``,
``graph/iterator/parallel/RandomWalkGraphIteratorProvider.java``).

Semantics preserved from the reference: one walk starts at every
vertex exactly once per epoch, starting order shuffled; walk of
length L contains L+1 vertices. Generation is batched (one vectorized
sweep fills every walk) — iteration just yields rows. Counterpart of
``deeplearning4j_tpu/graph/walks.py``, copied as it is."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import (
    NoEdgeHandling,
    VertexSequence,
)
from deeplearning4j_tpu_torch.graph.graph import Graph, generate_random_walks


class RandomWalkIterator:
    """Uniform random walks, one starting at each vertex of
    [first_vertex, last_vertex), order randomized (reference
    ``RandomWalkIterator.java``)."""

    weighted = False

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 mode: NoEdgeHandling =
                 NoEdgeHandling.EXCEPTION_ON_DISCONNECTED,
                 first_vertex: int = 0,
                 last_vertex: Optional[int] = None):
        self.graph = graph
        self._walk_length = walk_length
        self.seed = seed
        self.mode = mode
        self.first_vertex = first_vertex
        self.last_vertex = (
            last_vertex if last_vertex is not None else graph.num_vertices()
        )
        self._epoch = 0
        self.reset()

    def walk_length(self) -> int:
        return self._walk_length

    def reset(self) -> None:
        rng = np.random.RandomState(
            (self.seed + 7919 * self._epoch) & 0x7FFFFFFF
        )
        starts = np.arange(self.first_vertex, self.last_vertex,
                           dtype=np.int32)
        rng.shuffle(starts)
        self._walks = generate_random_walks(
            self.graph, self._walk_length, starts,
            seed=(self.seed + 104729 * self._epoch + 1) & 0x7FFFFFFF,
            mode=self.mode, weighted=self.weighted,
        )
        self._pos = 0
        self._epoch += 1

    def has_next(self) -> bool:
        return self._pos < len(self._walks)

    def next(self) -> VertexSequence:
        seq = VertexSequence(self.graph, self._walks[self._pos].tolist())
        self._pos += 1
        return seq

    def __iter__(self) -> Iterator[VertexSequence]:
        while self.has_next():
            yield self.next()

    def walks_array(self) -> np.ndarray:
        """The full [n_walks, L+1] int32 batch — the fast path DeepWalk
        trains from directly."""
        return self._walks


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional neighbor choice (reference
    ``WeightedRandomWalkIterator.java``)."""

    weighted = True


class RandomWalkGraphIteratorProvider:
    """Splits the vertex range into n roughly equal sub-ranges, one
    iterator each (reference
    ``RandomWalkGraphIteratorProvider.java``). With batched training
    the split exists for API parity and sharded walk generation."""

    iterator_cls = RandomWalkIterator

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 mode: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.mode = mode

    def get_graph_walk_iterators(self, n: int) -> List[RandomWalkIterator]:
        nv = self.graph.num_vertices()
        n = max(1, min(n, nv))
        bounds = np.linspace(0, nv, n + 1, dtype=np.int64)
        return [
            self.iterator_cls(
                self.graph, self.walk_length, seed=self.seed + i,
                mode=self.mode, first_vertex=int(bounds[i]),
                last_vertex=int(bounds[i + 1]),
            )
            for i in range(n)
            if bounds[i] < bounds[i + 1]
        ]


class WeightedRandomWalkGraphIteratorProvider(
    RandomWalkGraphIteratorProvider
):
    """Weighted variant (reference
    ``WeightedRandomWalkGraphIteratorProvider.java``)."""

    iterator_cls = WeightedRandomWalkIterator

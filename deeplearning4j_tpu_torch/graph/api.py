"""Graph primitives (reference ``deeplearning4j-graph``:
``graph/api/Vertex.java``, ``Edge.java``, ``IGraph.java``,
``NoEdgeHandling.java``, ``IVertexSequence.java``). Counterpart of
``deeplearning4j_tpu/graph/api.py``, copied as it is."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Generic, List, Optional, TypeVar

V = TypeVar("V")


class NoEdgeHandling(enum.Enum):
    """What a random walk does at a vertex with no (outgoing) edges
    (reference ``graph/api/NoEdgeHandling.java``)."""

    SELF_LOOP_ON_DISCONNECTED = "SELF_LOOP_ON_DISCONNECTED"
    EXCEPTION_ON_DISCONNECTED = "EXCEPTION_ON_DISCONNECTED"


class NoEdgesException(RuntimeError):
    """Walk hit a disconnected vertex under EXCEPTION_ON_DISCONNECTED
    (reference ``graph/exception/NoEdgesException.java``)."""


class ParseException(ValueError):
    """Malformed graph file line (reference
    ``graph/exception/ParseException.java``)."""


@dataclass(frozen=True)
class Vertex(Generic[V]):
    """A vertex: integer index + optional user value (reference
    ``graph/api/Vertex.java``)."""

    idx: int
    value: Optional[V] = None

    def vertex_id(self) -> int:
        return self.idx


@dataclass(frozen=True)
class Edge:
    """An edge, optionally directed and optionally weighted
    (reference ``graph/api/Edge.java`` — the generic edge value is a
    float weight here; unweighted edges carry weight 1.0)."""

    from_idx: int
    to_idx: int
    weight: float = 1.0
    directed: bool = False


class VertexSequence(Generic[V]):
    """A walk — sequence of vertices in a graph (reference
    ``graph/graph/VertexSequence.java``)."""

    def __init__(self, graph: Any, indices: List[int]):
        self._graph = graph
        self._indices = list(indices)

    def sequence_length(self) -> int:
        return len(self._indices)

    def indices(self) -> List[int]:
        return list(self._indices)

    def __iter__(self):
        for i in self._indices:
            yield self._graph.get_vertex(i)

    def __len__(self) -> int:
        return len(self._indices)

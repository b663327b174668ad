"""Graph file loaders (reference ``graph/data/GraphLoader.java``,
``DelimitedEdgeLineProcessor.java``, ``WeightedEdgeLineProcessor.java``,
``DelimitedVertexLoader.java``).

Counterpart of ``deeplearning4j_tpu/graph/loader.py``: the same host
code."""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.graph.api import Edge, ParseException
from deeplearning4j_tpu_torch.graph.graph import Graph


def _parse_edge_line(line: str, delim: str, weighted: bool,
                     directed: bool) -> Optional[Edge]:
    line = line.strip()
    if not line or line.startswith("#") or line.startswith("//"):
        return None
    parts = [p for p in line.split(delim) if p != ""]
    want = 3 if weighted else 2
    if len(parts) != want:
        raise ParseException(
            f"expected {want} fields delimited by {delim!r}: {line!r}"
        )
    f, t = int(parts[0]), int(parts[1])
    w = float(parts[2]) if weighted else 1.0
    return Edge(f, t, w, directed)


def load_undirected_graph_edge_list_file(
    path: str, n_vertices: int, delim: str = ",",
) -> Graph:
    """Edge list "from,to" per line → undirected graph (reference
    ``GraphLoader.loadUndirectedGraphEdgeListFile``)."""
    return _load(path, n_vertices, delim, weighted=False, directed=False)


def load_weighted_edge_list_file(
    path: str, n_vertices: int, delim: str = ",", directed: bool = False,
) -> Graph:
    """Edge list "from,to,weight" per line (reference
    ``GraphLoader.loadWeightedEdgeListFile``)."""
    return _load(path, n_vertices, delim, weighted=True, directed=directed)


def _load(path, n_vertices, delim, weighted, directed) -> Graph:
    g = Graph(n_vertices)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            e = _parse_edge_line(line, delim, weighted, directed)
            if e is not None:
                g.add_edge(e.from_idx, e.to_idx, e.weight, e.directed)
    return g


def load_vertex_values(path: str, delim: str = ":") -> List[str]:
    """"index<delim>value" lines → values ordered by index (reference
    ``DelimitedVertexLoader.java``)."""
    pairs = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            idx, _, val = line.partition(delim)
            if _ == "":
                raise ParseException(f"no delimiter {delim!r} in {line!r}")
            pairs.append((int(idx), val))
    pairs.sort()
    return [v for _, v in pairs]

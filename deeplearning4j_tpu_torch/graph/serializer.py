"""Save/load graph vectors (reference
``graph/models/loader/GraphVectorSerializer.java`` — tab-delimited
"index\\tv0\\tv1..." per line; loading reconstructs a query-only
GraphVectors).

Counterpart of ``deeplearning4j_tpu/graph/serializer.py``: the same
text format, so a file written by either package loads in the other.
``load_txt_vectors`` puts the vectors on ``device`` (default
``"cuda"``)."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.graph.deepwalk import (
    GraphVectorsImpl,
    InMemoryGraphLookupTable,
)

_DELIM = "\t"


def write_graph_vectors(model: GraphVectorsImpl, path: str) -> None:
    n = model.num_vertices()
    d = model.get_vector_size()
    vecs = model.lookup_table.get_vertex_vectors()
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            vec = vecs[i]
            f.write(
                str(i) + _DELIM
                + _DELIM.join(repr(float(vec[j])) for j in range(d)) + "\n"
            )


def load_txt_vectors(path: str, device=None) -> GraphVectorsImpl:
    from deeplearning4j_tpu_torch.graph.api import ParseException

    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(_DELIM)
            if len(parts) < 2:
                continue
            rows.append((int(parts[0]), [float(x) for x in parts[1:]]))
    if not rows:
        raise ParseException(f"no vector lines found in {path!r}")
    if len({len(v) for _, v in rows}) != 1:
        raise ParseException(f"ragged vector lengths in {path!r}")
    rows.sort()
    vectors = np.asarray([v for _, v in rows], np.float32)
    n, d = vectors.shape
    table = InMemoryGraphLookupTable(n, d, tree=None, learning_rate=0.01,
                                     device=device)
    table.load_numpy(vectors, np.zeros((max(n - 1, 1), d), np.float32))
    return GraphVectorsImpl(table)

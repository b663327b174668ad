"""``ShardedDeepWalk``: DeepWalk vertex embeddings on row-sharded
tables.

Counterpart of ``deeplearning4j_tpu/embeddings/deepwalk.py``.
``graph/deepwalk.py`` trains batched, but its vertex vectors and
inner-node weights are dense tables on one device. Here both become
:class:`ShardedEmbeddingTable` shards over the ranks and each batch
runs the fused hierarchical-softmax step from ``embeddings/table.py``
(collective lookup of the centers + path inner nodes, gradient with
respect to the gathered rows only, dedup + owner scatter) — the same
graph sign convention and batch-averaged loss as ``_hs_graph_step``.

The reference's single-pair ``iterate`` / ``vectors_and_gradients``
contract mutates host rows in place and does not compose with
row-sharded storage: those methods raise here.

Persistence is the JAX package's ``sharded-deepwalk-v1`` npz: canonical
host rows + vertex degrees (the Huffman tree rebuilds from them) +
the epoch counter, restoring at any world size bitwise, in either
package. ``fit`` continues the per-epoch walk seeds across calls
(``_epochs_done``), so a resumed run draws the walks the dead run never
got to.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from deeplearning4j_tpu_torch.embeddings.table import (
    ShardedEmbeddingTable,
    default_mesh,
    hs_graph_step,
    note_rows_touched,
)
from deeplearning4j_tpu_torch.embeddings.word2vec import write_on_rank0
from deeplearning4j_tpu_torch.graph.deepwalk import (
    DeepWalk,
    GraphHuffman,
    InMemoryGraphLookupTable,
)
from deeplearning4j_tpu_torch.graph.graph import Graph

_FORMAT = "sharded-deepwalk-v1"


class ShardedGraphLookupTable(InMemoryGraphLookupTable):
    """Graph lookup table whose vertex vectors and inner-node weights
    are row-sharded over the ranks. Initial rows come from the same RNG
    stream (same draw order) as the base class, so weights start
    bitwise identical."""

    def __init__(self, n_vertices: int, vector_size: int, tree,
                 learning_rate: float, seed: int = 12345, mesh=None):
        # No super().__init__: it allocates the dense host tables.
        self.n_vertices = n_vertices
        self._vector_size = vector_size
        self.tree = tree
        self.learning_rate = learning_rate
        self.mesh = mesh if mesh is not None else default_mesh()
        self.device = self.mesh.device
        rng = np.random.RandomState(seed)
        rows0 = (
            (rng.rand(n_vertices, vector_size) - 0.5) / vector_size
        ).astype(np.float32)
        rows1 = (
            (rng.rand(max(n_vertices - 1, 1), vector_size) - 0.5)
            / vector_size
        ).astype(np.float32)
        self.t0 = ShardedEmbeddingTable.from_rows(rows0, mesh=self.mesh)
        self.t1 = ShardedEmbeddingTable.from_rows(rows1, mesh=self.mesh)

    # base-class names resolve to the raw sharded device arrays
    @property
    def vertex_vectors(self):
        return self.t0.table

    @property
    def out_weights(self):
        return self.t1.table

    def get_vertex_vectors(self) -> np.ndarray:
        # canonical unpadded rows (the raw array carries vocab padding)
        return self.t0.to_host()

    def get_vector(self, idx: int) -> np.ndarray:
        return self.t0.lookup(np.array([idx], np.int64))[0].cpu().numpy()

    def vectors_and_gradients(self, first: int, second: int):
        raise NotImplementedError(
            "per-pair vectors_and_gradients mutates host rows in place "
            "and does not compose with row-sharded tables; use the "
            "dense InMemoryGraphLookupTable for gradient checks"
        )

    def iterate(self, first: int, second: int) -> None:
        raise NotImplementedError(
            "per-pair iterate does not compose with row-sharded "
            "tables; train through batch_update"
        )

    def batch_update(self, centers: np.ndarray, contexts: np.ndarray,
                     alpha: float) -> float:
        """Same contract as the base: one fused HS step for the
        (centers -> contexts) pair batch, returns mean loss — but the
        step is the sharded collective-lookup / owner-scatter one."""
        codes = self.tree.codes[contexts]
        points = self.tree.points[contexts]
        L = self.tree.codes.shape[1]
        pmask = (
            np.arange(L)[None, :] < self.tree.lengths[contexts][:, None]
        ).astype(np.float32)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        loss, touched = hs_graph_step(
            self.t0.table, self.t1.table,
            put(centers).long(), put(np.asarray(codes, np.float32)),
            put(points).long(), put(pmask), float(np.float32(alpha)),
            self.mesh,
        )
        note_rows_touched(int(touched))
        return float(loss)


class ShardedDeepWalk(DeepWalk):
    """DeepWalk whose tables shard over the ranks of the world. Same
    surface as :class:`DeepWalk` plus ``mesh``; adds
    ``save``/``restore`` (canonical rows, any-mesh restore) and
    continues epoch walk seeds across ``fit`` calls for resume."""

    def __init__(self, vector_size: int = 100, window_size: int = 2,
                 learning_rate: float = 0.01, seed: int = 12345,
                 batch_size: int = 2048, mesh=None, device=None):
        mesh = mesh if mesh is not None else default_mesh(device)
        super().__init__(vector_size=vector_size,
                         window_size=window_size,
                         learning_rate=learning_rate, seed=seed,
                         batch_size=batch_size, device=mesh.device)
        self.mesh = mesh
        self._epochs_done = 0
        self._degrees = None

    def initialize(self, graph_or_degrees) -> None:
        if isinstance(graph_or_degrees, Graph):
            degrees = graph_or_degrees.degrees()
        else:
            degrees = np.asarray(graph_or_degrees, np.int64)
        self._degrees = np.asarray(degrees, np.int64)
        tree = GraphHuffman(degrees)
        self.lookup_table = ShardedGraphLookupTable(
            len(degrees), self.vector_size, tree, self.learning_rate,
            seed=self.seed, mesh=self.mesh,
        )
        self._init_called = True

    def fit(self, graph: Graph, walk_length: int = 8,
            epochs: int = 1) -> None:
        """Like the base fit, but epoch seeds continue across calls
        (``seed + epochs_done``, ...): fit(e1) then fit(e2) — on this
        instance or on one restored from its checkpoint — walks the
        same ground as a single fit(e1+e2)."""
        if not self._init_called:
            self.initialize(graph)
        from deeplearning4j_tpu_torch.graph.api import NoEdgeHandling
        from deeplearning4j_tpu_torch.graph.graph import generate_random_walks

        n = graph.num_vertices()
        first = self._epochs_done
        for epoch in range(first, first + epochs):
            rng = np.random.RandomState(self.seed + epoch)
            starts = np.arange(n, dtype=np.int32)
            rng.shuffle(starts)
            walks = generate_random_walks(
                graph, walk_length, starts,
                seed=self.seed + 31 * epoch + 1,
                mode=NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
            )
            self.fit_walks(walks)
            self._epochs_done = epoch + 1

    # -- persistence -----------------------------------------------------

    def save(self, path: str) -> None:
        """Canonical host rows + degrees + epoch counter, written
        atomically by rank 0 (every rank calls it); restores at any
        width bitwise."""
        if not self._init_called:
            raise RuntimeError("nothing to save: not initialized")
        lt = self.lookup_table
        buf = io.BytesIO()
        np.savez(
            buf,
            format=_FORMAT,
            vertex_vectors=lt.t0.to_host(),
            out_weights=lt.t1.to_host(),
            degrees=self._degrees,
            epochs_done=self._epochs_done,
            meta=np.array([self.vector_size, self.window_size,
                           self.seed, self.batch_size], np.int64),
        )
        write_on_rank0(self.mesh, path, buf.getvalue())

    def restore(self, path: str) -> None:
        """Rebuild the Huffman tree from the checkpoint's degrees and
        place its rows onto THIS instance's ranks."""
        with np.load(path, allow_pickle=False) as z:
            if str(z["format"]) != _FORMAT:
                raise ValueError(f"not a {_FORMAT} checkpoint: {path}")
            meta = z["meta"]
            want = np.array([self.vector_size, self.window_size,
                             self.seed, self.batch_size], np.int64)
            if not np.array_equal(meta, want):
                raise ValueError(
                    f"checkpoint hyperparameters {meta.tolist()} do "
                    f"not match this trainer's {want.tolist()} "
                    "(vector/window/seed/batch)"
                )
            self.initialize(z["degrees"])
            self.lookup_table.t0.restore_rows(z["vertex_vectors"])
            self.lookup_table.t1.restore_rows(z["out_weights"])
            self._epochs_done = int(z["epochs_done"])

"""DeepWalk graph embeddings (reference
``graph/models/deepwalk/DeepWalk.java``, ``GraphHuffman.java``,
``graph/models/embeddings/InMemoryGraphLookupTable.java``,
``GraphVectorsImpl.java``).

Counterpart of ``deeplearning4j_tpu/graph/deepwalk.py``. The reference
trains per (vertex, context) pair — ``lookupTable.iterate(first,
second)`` does dot/sigmoid/axpy on one row at a time across N racing
threads. Here every epoch's walks are generated in one vectorized
sweep (the JAX package's numpy streams), skip-gram pairs are extracted
with numpy slicing, and one step per batch does gather → dot → sigmoid
→ row update over the hierarchical-softmax paths (padded to fixed
length), the gradient taken with respect to the gathered rows and
duplicates summed repeatably (``embeddings/sparse.py``). Updates within
a batch are averaged — synchronous large-batch SGD, as with Word2Vec.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.embeddings import sparse

from deeplearning4j_tpu_torch.graph.api import NoEdgeHandling
from deeplearning4j_tpu_torch.graph.graph import Graph, generate_random_walks
from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabWord
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


class GraphHuffman:
    """Huffman tree over vertex degrees for hierarchical softmax
    (reference ``GraphHuffman.java`` — degree plays the role word
    frequency plays in word2vec). Wraps the shared Huffman builder and
    exposes fixed-shape padded (codes, points, lengths) arrays for the
    batched step."""

    def __init__(self, vertex_degrees: np.ndarray):
        words = [
            VocabWord(str(i), max(int(d), 1), i)
            for i, d in enumerate(vertex_degrees)
        ]
        h = Huffman(words)
        h.build()
        self._words = words
        self.codes, self.points, self.lengths = h.padded_arrays()


    def get_code(self, vertex: int) -> List[int]:
        return list(self._words[vertex].code)

    def get_code_length(self, vertex: int) -> int:
        return int(self.lengths[vertex])

    def get_path_inner_nodes(self, vertex: int) -> List[int]:
        return list(self._words[vertex].points)


def _hs_graph_step(syn0, syn1, centers, codes, points, path_mask, alpha):
    """Batched HS update with the GRAPH sign convention (reference
    ``InMemoryGraphLookupTable.vectorsAndGradients``: per inner node,
    d(loss)/d(dot) = sigmoid(dot) - bit), in place: loss per node is
    -log sigmoid((2·bit − 1) · (v_center · syn1[point])). Returns the
    batch loss (a 0-d tensor)."""
    v = syn0[centers]                        # [B, D]
    u = syn1[points]                         # [B, L, D]
    sign = 2.0 * codes - 1.0
    denom = (path_mask > 0).any(1).sum().clamp_min(1).to(v.dtype)

    def loss_fn(v_, u_):
        x = torch.bmm(u_, v_.unsqueeze(-1)).squeeze(-1)
        return -(path_mask * F.logsigmoid(sign * x)).sum() / denom

    loss, (gv, gu) = sparse.rows_grad(loss_fn, v, u)
    sparse.sgd_rows_(syn0, centers, gv, alpha)
    sparse.sgd_rows_(syn1, points, gu, alpha)
    return loss


class InMemoryGraphLookupTable:
    """vertex_vectors [n, d] ('input') + out_weights [n-1, d] (inner
    binary-tree nodes) (reference ``InMemoryGraphLookupTable.java``).
    ``iterate``/``vectors_and_gradients`` keep the reference's
    single-pair contract (used by gradient-check tests); training goes
    through the batched step. Both tables live on ``device`` (default
    ``"cuda"``) from the start, drawn from the JAX package's
    ``RandomState(seed)`` stream."""

    def __init__(self, n_vertices: int, vector_size: int,
                 tree: Optional[GraphHuffman], learning_rate: float,
                 seed: int = 12345, device=None):
        self.n_vertices = n_vertices
        self._vector_size = vector_size
        self.tree = tree
        self.learning_rate = learning_rate
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        self.load_numpy(
            ((rng.rand(n_vertices, vector_size) - 0.5) / vector_size
             ).astype(np.float32),
            ((rng.rand(max(n_vertices - 1, 1), vector_size) - 0.5)
             / vector_size).astype(np.float32))

    def load_numpy(self, vertex_vectors, out_weights) -> None:
        """Adopt host tables (the JAX package's ``vertex_vectors`` /
        ``out_weights``), copied onto this table's device."""
        put = lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            self.device)
        self.vertex_vectors = put(vertex_vectors)
        self.out_weights = put(out_weights)

    def vector_size(self) -> int:
        return self._vector_size

    def get_vertex_vectors(self) -> np.ndarray:
        return self.vertex_vectors.cpu().numpy()

    def set_learning_rate(self, lr: float) -> None:
        self.learning_rate = lr

    def get_vector(self, idx: int) -> np.ndarray:
        return self.vertex_vectors[idx].cpu().numpy()

    @staticmethod
    def _sigmoid(x: float) -> float:
        return 1.0 / (1.0 + np.exp(-x))

    def vectors_and_gradients(self, first: int, second: int):
        """(vectors, gradients) lists: entry 0 is the input vertex
        vector + its accumulated gradient; entries i>0 are the inner
        nodes on ``second``'s path + their gradients (reference
        ``InMemoryGraphLookupTable.vectorsAndGradients`` — same
        contract, kept for numerical gradient checks)."""
        v = self.vertex_vectors[first].cpu().numpy()
        bits = self.tree.get_code(second)
        inner = self.tree.get_path_inner_nodes(second)
        vecs = [v]
        grads = [np.zeros_like(v)]
        for bit, node in zip(bits, inner):
            u = self.out_weights[node].cpu().numpy()
            s = self._sigmoid(float(np.dot(u, v)))
            grads.append(v * (s - bit))
            grads[0] = grads[0] + (s - bit) * u
            vecs.append(u)
        return vecs, grads

    def _set_row(self, attr: str, idx: int, value: np.ndarray) -> None:
        getattr(self, attr)[idx] = torch.from_numpy(
            np.asarray(value, np.float32))

    def iterate(self, first: int, second: int) -> None:
        """Single-pair SGD update (reference ``iterate``)."""
        vecs, grads = self.vectors_and_gradients(first, second)
        inner = self.tree.get_path_inner_nodes(second)
        self._set_row("vertex_vectors", first,
                      vecs[0] - self.learning_rate * grads[0])
        for i, node in enumerate(inner):
            self._set_row("out_weights", node,
                          vecs[i + 1] - self.learning_rate * grads[i + 1])

    def batch_update(self, centers: np.ndarray, contexts: np.ndarray,
                     alpha: float) -> float:
        """Batched HS update for pairs (centers→contexts) in one step;
        returns mean loss."""
        codes = self.tree.codes[contexts]
        points = self.tree.points[contexts]
        L = self.tree.codes.shape[1]
        pmask = (
            np.arange(L)[None, :] < self.tree.lengths[contexts][:, None]
        ).astype(np.float32)
        dev = self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        loss = _hs_graph_step(
            self.vertex_vectors, self.out_weights,
            put(centers).long(), put(codes), put(points).long(),
            put(pmask), float(np.float32(alpha)),
        )
        return float(loss)


class GraphVectorsImpl:
    """Query API over learned vertex vectors (reference
    ``GraphVectorsImpl.java``): similarity, nearest vertices."""

    def __init__(self, lookup_table: Optional[InMemoryGraphLookupTable]
                 = None):
        self.lookup_table = lookup_table

    def num_vertices(self) -> int:
        return self.lookup_table.n_vertices

    def get_vector_size(self) -> int:
        return self.lookup_table.vector_size()

    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self.lookup_table.get_vector(idx)

    def similarity(self, a: int, b: int) -> float:
        va = self.get_vertex_vector(a)
        vb = self.get_vertex_vector(b)
        denom = float(np.linalg.norm(va) * np.linalg.norm(vb))
        return float(np.dot(va, vb) / denom) if denom > 0 else 0.0

    def vertices_nearest(self, idx: int, top: int = 10) -> List[int]:
        vecs = self.lookup_table.get_vertex_vectors()
        norms = np.linalg.norm(vecs, axis=1)
        norms = np.where(norms == 0, 1.0, norms)
        sims = (vecs @ vecs[idx]) / (norms * norms[idx])
        sims[idx] = -np.inf
        order = np.argsort(-sims)
        return order[:top].tolist()


class DeepWalk(GraphVectorsImpl):
    """DeepWalk (Perozzi, Al-Rfou & Skiena 2014) — unsupervised vertex
    embeddings from random walks, trained skip-gram-style with
    hierarchical softmax (reference ``DeepWalk.java``; its thread pool
    is replaced by batched walk generation + one update per batch).
    ``device``: where the tables live (default ``"cuda"``)."""

    STATUS_UPDATE_FREQUENCY = 1000

    def __init__(self, vector_size: int = 100, window_size: int = 2,
                 learning_rate: float = 0.01, seed: int = 12345,
                 batch_size: int = 2048, device=None):
        super().__init__(None)
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.seed = seed
        self.batch_size = batch_size
        self._init_called = False

    # -- lifecycle ------------------------------------------------------

    def initialize(self, graph_or_degrees) -> None:
        """Build the degree-based Huffman tree + lookup table
        (reference ``DeepWalk.initialize``)."""
        if isinstance(graph_or_degrees, Graph):
            degrees = graph_or_degrees.degrees()
        else:
            degrees = np.asarray(graph_or_degrees, np.int64)
        tree = GraphHuffman(degrees)
        self.lookup_table = InMemoryGraphLookupTable(
            len(degrees), self.vector_size, tree, self.learning_rate,
            seed=self.seed, device=self.device,
        )
        self._init_called = True

    def set_learning_rate(self, lr: float) -> None:
        self.learning_rate = lr
        if self.lookup_table is not None:
            self.lookup_table.set_learning_rate(lr)

    # -- training -------------------------------------------------------

    def _pairs_from_walks(self, walks: np.ndarray):
        """Vectorized skip-gram pair extraction (reference
        ``DeepWalk.skipGram``: centers mid ∈ [window, len-window), all
        offsets ±window)."""
        W, L = walks.shape
        w = self.window_size
        cs, xs = [], []
        for mid in range(w, L - w):
            for pos in range(mid - w, mid + w + 1):
                if pos == mid:
                    continue
                cs.append(walks[:, mid])
                xs.append(walks[:, pos])
        if not cs:
            return (np.empty(0, np.int32),) * 2
        return (
            np.concatenate(cs).astype(np.int32),
            np.concatenate(xs).astype(np.int32),
        )

    def fit(self, graph: Graph, walk_length: int = 8,
            epochs: int = 1) -> None:
        """Generate one walk per vertex per epoch (uniform random,
        self-loop on disconnected — reference ``DeepWalk.fit(IGraph,
        int)``) and train on all resulting skip-gram pairs."""
        if not self._init_called:
            self.initialize(graph)
        n = graph.num_vertices()
        for epoch in range(epochs):
            rng = np.random.RandomState(self.seed + epoch)
            starts = np.arange(n, dtype=np.int32)
            rng.shuffle(starts)
            walks = generate_random_walks(
                graph, walk_length, starts,
                seed=self.seed + 31 * epoch + 1,
                mode=NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
            )
            self.fit_walks(walks)

    def fit_walks(self, walks: np.ndarray) -> float:
        """Train on a precomputed [n_walks, L+1] walk batch (the fast
        path ``fit_iterator`` and ``fit`` feed)."""
        if not self._init_called:
            raise RuntimeError(
                "DeepWalk not initialized (call initialize before fit)"
            )
        centers, contexts = self._pairs_from_walks(walks)
        if len(centers) == 0:
            raise ValueError(
                f"no skip-gram pairs: walk has {walks.shape[1]} vertices "
                f"but window_size={self.window_size} needs walks of at "
                f"least {2 * self.window_size + 1} (walk_length >= "
                f"{2 * self.window_size})"
            )
        # shuffle pairs so batches mix walk positions
        perm = np.random.RandomState(self.seed ^ 0x5EED).permutation(
            len(centers)
        )
        centers, contexts = centers[perm], contexts[perm]
        # clamp the batch to the pair count, then tile up to a full
        # multiple of B so every pair trains (small graphs produce far
        # fewer pairs than the default batch size)
        B = min(self.batch_size, len(centers))
        n_full = -(-len(centers) // B) * B
        centers = np.resize(centers, n_full)
        contexts = np.resize(contexts, n_full)
        total = 0.0
        nb = len(centers) // B
        for i in range(nb):
            total += self.lookup_table.batch_update(
                centers[i * B:(i + 1) * B], contexts[i * B:(i + 1) * B],
                self.learning_rate,
            )
        return total / max(nb, 1)

    def fit_iterator(self, iterator) -> None:
        """Train from a GraphWalkIterator (reference
        ``DeepWalk.fit(GraphWalkIterator)``); uses the iterator's
        batched walk array when available."""
        if not self._init_called:
            raise RuntimeError(
                "DeepWalk not initialized (call initialize before fit)"
            )
        if hasattr(iterator, "walks_array"):
            self.fit_walks(iterator.walks_array())
            while iterator.has_next():  # mark consumed
                iterator.next()
            return
        seqs = []
        while iterator.has_next():
            seqs.append(iterator.next().indices())
        if seqs:
            self.fit_walks(np.asarray(seqs, np.int32))

    # -- builder --------------------------------------------------------

    class Builder:
        """Reference ``DeepWalk.Builder`` (vectorSize/seed/
        learningRate/windowSize)."""

        def __init__(self):
            self._vector_size = 100
            self._seed = 12345
            self._learning_rate = 0.01
            self._window_size = 2
            self._batch_size = 2048
            self._device = None

        def vector_size(self, n): self._vector_size = n; return self
        def seed(self, n): self._seed = n; return self
        def learning_rate(self, x): self._learning_rate = x; return self
        def window_size(self, n): self._window_size = n; return self
        def batch_size(self, n): self._batch_size = n; return self
        def device(self, d): self._device = d; return self

        def build(self) -> "DeepWalk":
            return DeepWalk(
                vector_size=self._vector_size, seed=self._seed,
                learning_rate=self._learning_rate,
                window_size=self._window_size,
                batch_size=self._batch_size, device=self._device,
            )

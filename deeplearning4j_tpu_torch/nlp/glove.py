"""GloVe embeddings (reference: ``models/glove/Glove.java`` +
``models/glove/AbstractCoOccurrences.java`` — co-occurrence counting
host-side, then weighted-least-squares with per-parameter AdaGrad).

Counterpart of ``deeplearning4j_tpu/nlp/glove.py``: co-occurrence
triples (i, j, X_ij) are shuffled and packed into fixed-shape batches;
one step computes f(X)·(wᵢ·w̃ⱼ + bᵢ + b̃ⱼ − log X)² for the whole batch
and applies AdaGrad to the rows it touched (the gradient with respect
to the gathered rows, duplicates summed repeatably by
``embeddings/sparse.py``; an untouched row's AdaGrad update is zero),
replacing the reference's per-pair threaded updates. The counting and
the shuffles are the JAX package's numpy streams.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.embeddings import sparse

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


def _adagrad_rows_(table, hist, ids, grads, lr, eps=1e-8) -> None:
    """AdaGrad on the rows of ``table`` that ``ids`` touch, in place:
    ``h += g²; t -= lr·g/√(h + eps)`` with ``g`` each id's summed
    gradient (the dense update's value on those rows; the others stay
    as they are)."""
    sid, sums, last = sparse.sorted_row_sums(ids, grads)
    bcast = (slice(None),) + (None,) * (sums.dim() - 1)
    zero = sums.new_zeros(())
    hist.index_add_(0, sid, torch.where(last[bcast], sums * sums, zero))
    step = -lr * sums / torch.sqrt(hist[sid] + eps)
    table.index_add_(0, sid, torch.where(last[bcast], step, zero))


def _glove_step(state, rows, cols, logx, fx, mask, lr):
    """One AdaGrad batch, in place. state = (W, Wc, b, bc, hW, hWc, hb,
    hbc). Returns the batch loss (a 0-d tensor)."""
    W, Wc, b, bc, hW, hWc, hb, hbc = state

    def loss_fn(wi, wj, bi, bj):
        diff = (wi * wj).sum(-1) + bi + bj - logx
        return (mask * fx * diff * diff).sum()

    loss, (gwi, gwj, gbi, gbj) = sparse.rows_grad(
        loss_fn, W[rows], Wc[cols], b[rows], bc[cols])
    _adagrad_rows_(W, hW, rows, gwi, lr)
    _adagrad_rows_(Wc, hWc, cols, gwj, lr)
    _adagrad_rows_(b, hb, rows, gbi, lr)
    _adagrad_rows_(bc, hbc, cols, gbj, lr)
    return loss


class CoOccurrences:
    """Symmetric windowed co-occurrence counts with 1/distance
    weighting (reference ``AbstractCoOccurrences``)."""

    def __init__(self, cache: VocabCache, window: int = 5,
                 symmetric: bool = True):
        self.cache = cache
        self.window = window
        self.symmetric = symmetric
        self._counts: dict = defaultdict(float)

    def fit(self, id_sequences: Iterable[np.ndarray]) -> None:
        """Vectorized: for each offset d, pair ids[:-d] with ids[d:] in
        one slice, accumulate 1/d weights keyed by flat (i*V + j) via
        np.add.at-free bincount (unique+aggregate) — no per-token
        Python loop."""
        V = len(self.cache)
        w = self.window
        flush_at = 1 << 20  # bound peak memory to ~8MB of keys per flush
        keys_parts, vals_parts, pending = [], [], 0

        def flush():
            nonlocal keys_parts, vals_parts, pending
            if not keys_parts:
                return
            keys = np.concatenate(keys_parts)
            vals = np.concatenate(vals_parts)
            uniq, inv = np.unique(keys, return_inverse=True)
            sums = np.bincount(inv, weights=vals, minlength=len(uniq))
            for k, x in zip(uniq, sums):
                self._counts[(int(k) // V, int(k) % V)] += float(x)
            keys_parts, vals_parts, pending = [], [], 0

        for ids in id_sequences:
            ids = np.asarray(ids, np.int64)
            n = len(ids)
            for off in range(1, min(w, n - 1) + 1):
                a, b = ids[:-off], ids[off:]
                wt = np.full(len(a), 1.0 / off)
                keys_parts.append(a * V + b)
                vals_parts.append(wt)
                pending += len(a)
                if self.symmetric:
                    keys_parts.append(b * V + a)
                    vals_parts.append(wt)
                    pending += len(a)
                if pending >= flush_at:
                    flush()
        flush()

    def triples(self):
        n = len(self._counts)
        rows = np.empty(n, np.int32)
        cols = np.empty(n, np.int32)
        vals = np.empty(n, np.float32)
        for k, ((i, j), x) in enumerate(self._counts.items()):
            rows[k] = i
            cols[k] = j
            vals[k] = x
        return rows, cols, vals


class Glove:
    """GloVe trainer (reference ``Glove.java`` builder API)."""

    def __init__(self, cache: VocabCache, id_sequences: List[np.ndarray], *,
                 layer_size=100, window=5, learning_rate=0.05,
                 x_max=100.0, alpha=0.75, epochs=25, batch_size=1024,
                 seed=12345, symmetric=True, device=None):
        self.cache = cache
        self.layer_size = layer_size
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.co = CoOccurrences(cache, window=window, symmetric=symmetric)
        self.co.fit(id_sequences)
        v = len(cache)
        rng = np.random.RandomState(seed)
        init = lambda *s: ((rng.rand(*s) - 0.5) / layer_size).astype(
            np.float32)
        z = lambda *s: np.zeros(s, np.float32)
        self.load_state((
            init(v, layer_size), init(v, layer_size), init(v), init(v),
            z(v, layer_size), z(v, layer_size), z(v), z(v),
        ))
        self.syn0: Optional[np.ndarray] = None
        self._normalized: Optional[np.ndarray] = None
        self.last_loss = float("nan")

    def load_state(self, state) -> None:
        """Adopt ``(W, Wc, b, bc, hW, hWc, hb, hbc)`` host arrays (the
        JAX package's ``_state``), copied onto this trainer's device."""
        self._state = tuple(
            torch.from_numpy(np.array(a, np.float32)).to(self.device)
            for a in state)

    def state_numpy(self):
        """The eight state arrays on the host."""
        return tuple(t.cpu().numpy() for t in self._state)

    def _put(self, a):
        """Batch-array placement hook: ids widen to int64 on the device."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return t if t.is_floating_point() else t.long()

    def fit(self) -> "Glove":
        rows, cols, vals = self.co.triples()
        if len(rows) == 0:
            raise ValueError("Empty co-occurrence matrix")
        logx = np.log(vals).astype(np.float32)
        fx = np.minimum((vals / self.x_max) ** self.alpha, 1.0).astype(
            np.float32
        )
        B = self.batch_size
        rng = np.random.RandomState(self.seed)
        lr = float(np.float32(self.learning_rate))
        for _ in range(self.epochs):
            perm = rng.permutation(len(rows))
            epoch_losses = []
            for s in range(0, len(rows), B):
                sl = perm[s:s + B]
                mask = np.ones(B, np.float32)
                rb, cb = rows[sl], cols[sl]
                lb, fb = logx[sl], fx[sl]
                if len(sl) < B:
                    pad = B - len(sl)
                    mask[len(sl):] = 0.0
                    rb = np.pad(rb, (0, pad))
                    cb = np.pad(cb, (0, pad))
                    lb = np.pad(lb, (0, pad))
                    fb = np.pad(fb, (0, pad))
                loss = _glove_step(
                    self._state,
                    self._put(rb), self._put(cb),
                    self._put(lb), self._put(fb),
                    self._put(mask), lr,
                )
                epoch_losses.append(loss)  # device scalar; no sync
            self.last_loss = float(
                torch.stack(epoch_losses).sum()
            ) / max(len(rows), 1)
        # final vectors: W + Wc (standard GloVe practice)
        self.syn0 = (self._state[0].cpu().numpy()
                     + self._state[1].cpu().numpy())
        self._normalized = None
        return self

    # -- query (same surface as SequenceVectors) ----------------------------

    def _norm(self) -> np.ndarray:
        if self.syn0 is None:
            raise ValueError("Call fit() first")
        if self._normalized is None:
            n = np.linalg.norm(self.syn0, axis=1, keepdims=True)
            self._normalized = self.syn0 / np.maximum(n, 1e-12)
        return self._normalized

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.cache.index_of(word)
        return None if i < 0 else self.syn0[i]

    def similarity(self, a: str, b: str) -> float:
        ia, ib = self.cache.index_of(a), self.cache.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        m = self._norm()
        return float(m[ia] @ m[ib])

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        i = self.cache.index_of(word)
        if i < 0:
            return []
        m = self._norm()
        sims = m @ m[i]
        sims[i] = -np.inf
        return [
            self.cache.word_at(int(t)) for t in np.argsort(-sims)[:n]
        ]

    class Builder:
        def __init__(self):
            self._kw = {}
            self._min_word_frequency = 1
            self._iterator = None
            self._tokenizer = None

        def min_word_frequency(self, n):
            self._min_word_frequency = n; return self

        def layer_size(self, n): self._kw["layer_size"] = n; return self
        def window_size(self, n): self._kw["window"] = n; return self
        def learning_rate(self, x): self._kw["learning_rate"] = x; return self
        def x_max(self, x): self._kw["x_max"] = x; return self
        def alpha(self, x): self._kw["alpha"] = x; return self
        def epochs(self, n): self._kw["epochs"] = n; return self
        def batch_size(self, n): self._kw["batch_size"] = n; return self
        def seed(self, n): self._kw["seed"] = n; return self
        def symmetric(self, b): self._kw["symmetric"] = b; return self
        def device(self, d): self._kw["device"] = d; return self
        def iterate(self, it): self._iterator = it; return self
        def tokenizer_factory(self, tf): self._tokenizer = tf; return self

        def build(self) -> "Glove":
            if self._iterator is None:
                raise ValueError("iterate(sentence_iterator) is required")
            tf = self._tokenizer or DefaultTokenizerFactory()
            sentences = [tf.create(s).get_tokens() for s in self._iterator]
            cache = VocabConstructor(
                min_word_frequency=self._min_word_frequency
            ).build_vocab_from_tokens(sentences)
            ids = [
                np.asarray(cache.id_stream(t), np.int64) for t in sentences
            ]
            return Glove(cache, ids, **self._kw)

"""``ShardedWord2Vec``: the negative-sampling skip-gram path on
row-sharded tables.

Counterpart of ``deeplearning4j_tpu/embeddings/word2vec.py``. The
single-device ``nlp/word2vec.py`` trainer keeps dense ``[V, D]``
syn0/syn1neg on one device. This subclass keeps every piece of its
training recipe — vocab, subsampling, pair generation, negative
sampling, the lr schedule, batch padding, the loss itself — and swaps
ONLY the storage and step: tables live as
:class:`ShardedEmbeddingTable` shards over the ranks of the
``torch.distributed`` world and each batch runs the fused
collective-lookup -> rows-grad -> dedup -> owner-scatter step from
``embeddings/table.py``.

Differences from the base trainer, all deliberate:

- **Eligibility**: skip-gram + negative sampling only. CBOW and
  hierarchical softmax stay with the base ``Word2Vec`` (the
  constructor refuses them); the chunked and device-generation epoch
  routes are bypassed the same way (the sharded step is the fused
  step).
- **Resumable fit**: the epoch/offset/step/lr-schedule counters are
  state, checkpointed with the canonical host rows, so a run killed
  mid-epoch resumes bitwise, at any world size.
- **Data defense**: every batch passes an id-range gate before
  touching the tables; a batch with ids outside ``[0, V)`` is
  quarantined — counted on ``QUARANTINED`` (reason ``"label_range"``)
  and on the trainer — and skipped.

Persistence (``save``/``restore``) is the JAX package's
``sharded-word2vec-v1`` npz: canonical unpadded host rows and the fit
counters, so a checkpoint written by either package restores in the
other, at any world size.
"""

from __future__ import annotations

import io
import os

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.embeddings.table import (
    ShardedEmbeddingTable,
    default_mesh,
    note_rows_touched,
    sg_ns_step,
)
from deeplearning4j_tpu_torch.nlp.word2vec import InMemoryLookupTable, Word2Vec
from deeplearning4j_tpu_torch.util.model_serializer import atomic_write_bytes

_FORMAT = "sharded-word2vec-v1"

#: Batches refused by the id-range gate, by reason (every trainer of
#: this process).
QUARANTINED = {"label_range": 0}


def write_on_rank0(mesh, path, data: bytes) -> None:
    """Rank 0 writes ``data`` atomically; the others wait for it."""
    if mesh.rank == 0:
        atomic_write_bytes(os.fspath(path), data)
    if mesh.backend is not None and mesh.data > 1:
        dist.barrier()


class ShardedLookupTable(InMemoryLookupTable):
    """Drop-in lookup table whose syn0/syn1neg are row-sharded over the
    ranks. The dense ``[V, D]`` device tables of the base class never
    materialize — rows are drawn on host (same RNG stream as the base,
    so initial weights are bitwise identical) and placed shard by shard.
    """

    def __init__(self, cache, layer_size: int, seed: int = 12345,
                 use_hs: bool = False, negative: int = 5, mesh=None):
        # No super().__init__: it would allocate the dense tables this
        # class exists to avoid.
        self.cache = cache
        self.layer_size = layer_size
        self.use_hs = use_hs
        self.negative = negative
        self.mesh = mesh if mesh is not None else default_mesh()
        self.device = self.mesh.device
        v = len(cache)
        rng = np.random.RandomState(seed)
        rows0 = (
            (rng.rand(v, layer_size) - 0.5) / layer_size
        ).astype(np.float32)
        self.t0 = ShardedEmbeddingTable.from_rows(rows0, mesh=self.mesh)
        self.t1 = (
            ShardedEmbeddingTable.zeros(v, layer_size, mesh=self.mesh)
            if use_hs else None
        )
        self.t1n = (
            ShardedEmbeddingTable.zeros(v, layer_size, mesh=self.mesh)
            if negative > 0 else None
        )
        self._normalized = None

    # This rank's raw shards, under the base-class names.
    @property
    def syn0(self):
        return self.t0.table

    @property
    def syn1(self):
        return None if self.t1 is None else self.t1.table

    @property
    def syn1neg(self):
        return None if self.t1n is None else self.t1n.table

    def to_numpy(self):
        """Canonical host rows ``(syn0, None, syn1neg)`` (a collective
        on several ranks)."""
        return (self.t0.to_host(), None,
                None if self.t1n is None else self.t1n.to_host())

    def vector(self, word: str):
        i = self.cache.index_of(word)
        return None if i < 0 else self.t0.to_host()[i]

    def normalized(self) -> np.ndarray:
        # the canonical unpadded rows, gathered from every rank
        if self._normalized is None:
            m = self.t0.to_host()
            norms = np.linalg.norm(m, axis=1, keepdims=True)
            self._normalized = m / np.maximum(norms, 1e-12)
        return self._normalized


class ShardedWord2Vec(Word2Vec):
    """Word2Vec whose tables shard over the mesh's data axis.

    Same constructor surface as :class:`Word2Vec` plus:

    - ``mesh``: the port's mesh to shard over (default: the initialised
      world's, else a world of this process on ``device``).
    - ``checkpoint_path`` / ``checkpoint_every``: save canonical rows +
      fit counters every N steps during ``fit()`` (0 = only on demand).
    """

    def __init__(self, cache, sentences_ids, *, mesh=None,
                 checkpoint_path=None, checkpoint_every: int = 0, **kw):
        if kw.get("use_hierarchic_softmax"):
            raise ValueError(
                "ShardedWord2Vec supports negative sampling only; "
                "hierarchical softmax falls back to the single-device "
                "Word2Vec"
            )
        if kw.get("algorithm", "SkipGram") != "SkipGram":
            raise ValueError(
                "ShardedWord2Vec supports SkipGram only; CBOW falls "
                "back to the single-device Word2Vec"
            )
        self.mesh = mesh if mesh is not None else default_mesh(
            kw.get("device"))
        kw["device"] = self.mesh.device
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        # resumable-fit counters (all persisted by save())
        self._fit_epoch = 0
        self._fit_offset = 0
        self._fit_step = 0
        self._total_items = None
        self._quarantined = 0
        super().__init__(cache, sentences_ids, **kw)

    def _make_lookup(self):
        return ShardedLookupTable(
            self.cache, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative, mesh=self.mesh,
        )

    # -- data defense ----------------------------------------------------

    def _defend_batch(self, centers, contexts, mask) -> bool:
        """Id-range gate: any id outside ``[0, V)`` in a live slot
        quarantines the whole batch (count + skip). Returns True if the
        batch may train."""
        v = len(self.cache)
        live = mask > 0
        ok = True
        for ids in (centers, contexts):
            bad = (ids < 0) | (ids >= v)
            if bool(np.any(bad & live)):
                ok = False
                break
        if not ok:
            QUARANTINED["label_range"] += 1
            self._quarantined += 1
        return ok

    # -- training --------------------------------------------------------

    def _apply_batch(self, centers, contexts, mask, alpha, step):
        if not self._defend_batch(np.asarray(centers),
                                  np.asarray(contexts),
                                  np.asarray(mask)):
            return
        lk = self.lookup
        negs = self._sample_negatives(len(centers), step)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.mesh.device)
        self._last_loss, self._last_rows_touched = sg_ns_step(
            lk.t0.table, lk.t1n.table,
            put(centers).long(), put(contexts).long(), put(negs).long(),
            put(np.asarray(mask, np.float32)),
            float(np.float32(alpha)), self.mesh,
        )

    def fit(self) -> None:
        """Resumable mirror of the base per-batch fit loop: identical
        epoch seeds, padding, lr schedule, and negative-sampling step
        seeds — plus (epoch, offset, step) counters that persist
        through ``save``/``restore`` so a killed run continues exactly
        where it died. A completed fit resets the counters (repeated
        ``fit()`` calls replay from scratch, like the base class)."""
        B = self.batch_size
        lr0, lr_min = self.learning_rate, self.min_learning_rate
        total_items = self._total_items
        step = self._fit_step
        if self._fit_epoch > 0 and total_items is None:
            raise ValueError(
                "resume state names epoch "
                f"{self._fit_epoch} but carries no total_items — "
                "checkpoint predates the first epoch's pair count"
            )
        for epoch in range(self._fit_epoch, self.epochs):
            ep_seed = self.seed + 31 * epoch
            c, o = self._gen_pairs(ep_seed)
            n_items = len(c)
            if total_items is None:
                total_items = max(n_items * self.epochs, 1)
                self._total_items = total_items
            start = self._fit_offset if epoch == self._fit_epoch else 0
            for s in range(start, n_items, B):
                mask = np.ones(B, np.float32)
                cb, ob = c[s:s + B], o[s:s + B]
                if len(cb) < B:
                    pad = B - len(cb)
                    mask[len(cb):] = 0.0
                    cb = np.pad(cb, (0, pad))
                    ob = np.pad(ob, (0, pad))
                frac = min((step * B) / total_items, 1.0)
                alpha = max(lr0 * (1 - frac), lr_min)
                for _ in range(self.iterations):
                    self._apply_batch(cb, ob, mask, alpha, step)
                step += 1
                self._fit_step = step
                self._fit_offset = s + B
                if (self.checkpoint_every > 0 and self.checkpoint_path
                        and step % self.checkpoint_every == 0):
                    self.save(self.checkpoint_path)
            self._fit_epoch = epoch + 1
            self._fit_offset = 0
        if getattr(self, "_last_rows_touched", None) is not None:
            note_rows_touched(int(self._last_rows_touched))
        # fit complete: back to a fresh schedule, like the base class
        self._fit_epoch = 0
        self._fit_offset = 0
        self._fit_step = 0
        self._total_items = None
        if self.checkpoint_every > 0 and self.checkpoint_path:
            self.save(self.checkpoint_path)
        self.lookup.invalidate_norms()

    # -- persistence -----------------------------------------------------

    def save(self, path: str) -> None:
        """Canonical host rows + fit counters, written atomically by rank
        0 (every rank calls it: the rows are gathered). The rows are
        unpadded and world-independent: a checkpoint written at one
        width restores at another bitwise."""
        lk = self.lookup
        buf = io.BytesIO()
        np.savez(
            buf,
            format=_FORMAT,
            syn0=lk.t0.to_host(),
            syn1neg=lk.t1n.to_host(),
            fit_epoch=self._fit_epoch,
            fit_offset=self._fit_offset,
            fit_step=self._fit_step,
            total_items=(-1 if self._total_items is None
                         else self._total_items),
            meta=np.array([len(self.cache), self.layer_size,
                           self.negative, self.batch_size, self.epochs,
                           self.seed, self.window], np.int64),
        )
        write_on_rank0(self.mesh, path, buf.getvalue())

    def restore(self, path: str) -> None:
        """Load a checkpoint's rows onto THIS instance's ranks and adopt
        its fit counters. The width it was written at does not
        matter."""
        with np.load(path, allow_pickle=False) as z:
            if str(z["format"]) != _FORMAT:
                raise ValueError(
                    f"not a {_FORMAT} checkpoint: {path}"
                )
            meta = z["meta"]
            want = np.array([len(self.cache), self.layer_size,
                             self.negative, self.batch_size, self.epochs,
                             self.seed, self.window], np.int64)
            if not np.array_equal(meta, want):
                raise ValueError(
                    "checkpoint hyperparameters "
                    f"{meta.tolist()} do not match this trainer's "
                    f"{want.tolist()} (vocab/layer/negative/batch/"
                    "epochs/seed/window)"
                )
            lk = self.lookup
            lk.t0.restore_rows(z["syn0"])
            lk.t1n.restore_rows(z["syn1neg"])
            self._fit_epoch = int(z["fit_epoch"])
            self._fit_offset = int(z["fit_offset"])
            self._fit_step = int(z["fit_step"])
            ti = int(z["total_items"])
            self._total_items = None if ti < 0 else ti
        self.lookup.invalidate_norms()

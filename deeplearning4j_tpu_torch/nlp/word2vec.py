"""Word2Vec / SequenceVectors in PyTorch (reference:
``models/sequencevectors/SequenceVectors.java:161`` fit,
``models/word2vec/Word2Vec.java:31``, learning algorithms
``models/embeddings/learning/impl/elements/SkipGram.java:31`` /
``CBOW.java``, lookup table
``models/embeddings/inmemory/InMemoryLookupTable.java:55``).

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py``. The host packs
fixed-shape batches of (center, context, negatives | Huffman path) ids
and one step does gather -> dot -> sigmoid -> row update for the whole
batch; updates within a batch are averaged (synchronous large-batch
SGD, ``learning_rate`` the batch-level step, default 0.5). The JAX
package has no Pallas kernel here (``ops/__init__.py`` leaves the
scatter-add to XLA), so the step math is plain torch: the gradient is
taken with respect to the gathered rows and duplicate ids fold by sort
and segmented sum (``embeddings/sparse.py``), bitwise repeatable on
the card.

Routes of ``SequenceVectors.fit``, as in the JAX package:

- on-device epoch generation (skip-gram + negative sampling): the
  corpus ids live on the device and each epoch's subsampling, reduced
  windows and negatives are drawn there from an explicit
  ``torch.Generator``, one function (``epoch_draws``) making the three
  draws and the epoch body (``sg_device_epoch``) taking them as
  arguments. ``device_epoch_gen="auto"`` is on for a table on the card
  and off on the CPU;
- chunked host pairs: ``scan_chunk`` batches a chunk, prepared on the
  host (numpy draws, the JAX package's streams exactly) and replayed
  from a device-resident epoch cache;
- per batch (``iterations > 1`` or an overriding ``_apply_batch``);
- CBOW.

Every host draw is the JAX package's ``np.random.RandomState`` stream,
so the host routes see the same pairs, negatives and alphas.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.embeddings import sparse
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import (
    Huffman,
    VocabCache,
    VocabConstructor,
    build_unigram_table,
    subsample_mask,
)
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


def to_device_ids(a, device) -> torch.Tensor:
    """Host ids (uint16 / int32 / int64) as an int64 tensor on
    ``device``: they cross at their own width and are widened there."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device).long()


def _to_device(a, device) -> torch.Tensor:
    """A host batch array on ``device``: integers as int64 ids, floats
    as they are."""
    if torch.is_tensor(a):
        a = a.to(device)
        return a if a.is_floating_point() else a.long()
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return to_device_ids(a, device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _dot_rows(v, u):
    """``einsum("bd,b...d->b...")``: each center row against its rows."""
    return torch.bmm(u.reshape(u.shape[0], -1, u.shape[-1]),
                     v.unsqueeze(-1)).reshape(u.shape[:-1])


# ---------------------------------------------------------------------------
# Update steps. Each gathers its rows, differentiates the JAX step's loss
# with respect to them and updates the tables in place; returns the loss.
# ---------------------------------------------------------------------------


def _ns_step_raw(syn0, syn1neg, centers, contexts, negs, mask, alpha):
    """Negative-sampling step (SkipGram: centers = input word ids,
    contexts = predicted word ids)."""
    v = syn0[centers]                        # [B, D]
    u_pos = syn1neg[contexts]                # [B, D]
    u_neg = syn1neg[negs]                    # [B, K, D]
    # a drawn negative equal to the true context is masked out (the
    # reference resamples on collision)
    nvalid = (negs != contexts[:, None]).to(v.dtype)

    def loss_fn(v_, up_, un_):
        pos = F.logsigmoid((v_ * up_).sum(-1))
        neg = (nvalid * F.logsigmoid(-_dot_rows(v_, un_))).sum(-1)
        return -(mask * (pos + neg)).sum() / mask.sum().clamp_min(1.0)

    loss, (gv, gp, gn) = sparse.rows_grad(loss_fn, v, u_pos, u_neg)
    sparse.sgd_rows_(syn0, centers, gv, alpha)
    sparse.sgd_rows_(syn1neg, torch.cat([contexts, negs.reshape(-1)]),
                     torch.cat([gp, gn.reshape(-1, gn.shape[-1])]), alpha)
    return loss


def _hs_step_raw(syn0, syn1, centers, codes, points, path_mask, mask,
                 alpha):
    """Hierarchical-softmax step: codes/points are the context word's
    padded Huffman path ([B, L]); loss per node is
    -log σ((1-2·code)·(v_center · syn1[point]))."""
    v = syn0[centers]                        # [B, D]
    u = syn1[points]                         # [B, L, D]
    sign = 1.0 - 2.0 * codes

    def loss_fn(v_, u_):
        ll = F.logsigmoid(sign * _dot_rows(v_, u_)) * path_mask
        return -(mask * ll.sum(-1)).sum() / mask.sum().clamp_min(1.0)

    loss, (gv, gu) = sparse.rows_grad(loss_fn, v, u)
    sparse.sgd_rows_(syn0, centers, gv, alpha)
    sparse.sgd_rows_(syn1, points, gu, alpha)
    return loss


def _sg_scan_steps(syn0, syn1, syn1neg, centers_k, contexts_k, codes_k,
                   points_k, pmask_k, negs_k, mask_k, alphas_k):
    """``k`` skip-gram batches of a prepared chunk, in order (the JAX
    package's ``lax.scan``); the HS and NS legs run where their table
    exists. Returns the ``[k]`` losses."""
    losses = []
    for i in range(centers_k.shape[0]):
        loss = centers_k.new_zeros((), dtype=syn0.dtype)
        if syn1 is not None:
            loss = loss + _hs_step_raw(
                syn0, syn1, centers_k[i], codes_k[i], points_k[i],
                pmask_k[i], mask_k[i], alphas_k[i])
        if syn1neg is not None:
            loss = loss + _ns_step_raw(
                syn0, syn1neg, centers_k[i], contexts_k[i], negs_k[i],
                mask_k[i], alphas_k[i])
        losses.append(loss)
    return torch.stack(losses)


_NEG_POOL_MAX = 1 << 18  # presampled negatives; rolled+tiled per epoch


def alpha_schedule(lr0, lr_min, total, step0, epochs, n_batches, batch
                   ) -> np.ndarray:
    """``[epochs, n_batches]`` float32 alphas of the device route: the
    linear decay over ``total`` items from step ``step0``, computed in
    float32 in the JAX program's order (``sched`` = lr0, lr_min, total,
    step0)."""
    f = np.float32
    lr0, lr_min, total, step0 = f(lr0), f(lr_min), f(total), f(step0)
    out = np.empty((epochs, n_batches), np.float32)
    ar = np.arange(n_batches, dtype=np.float32)
    for e in range(epochs):
        steps = step0 + f(e) * f(n_batches) + ar
        frac = np.minimum(steps * f(batch) / total, f(1.0))
        out[e] = np.maximum(lr0 * (f(1.0) - frac), lr_min)
    return out


class DeviceCorpus:
    """The device route's epoch-independent arrays, on the table's
    device: ``ids [N]`` (padded to whole batches), ``ctx [N, 2W]`` (the
    2W context ids by static shifts), ``inb [N, 2W]`` (inside the
    sentence), ``kp_pos [N]`` (each position's keep probability) and
    the negative ``pool [P]``; ``n_words`` the unpadded length."""

    def __init__(self, ids, pos, slen, kp, pool, n_words, window, device):
        w = window
        self.window = w
        self.n_words = int(n_words)
        self.ids = to_device_ids(ids, device)
        pos_d = torch.from_numpy(pos).to(device).int()
        slen_d = torch.from_numpy(slen).to(device).int()
        self.kp_pos = torch.from_numpy(kp).to(device)[self.ids]
        self.pool = to_device_ids(pool, device)
        offsets = [o for o in range(-w, w + 1) if o != 0]
        self.abs_offs = torch.tensor([abs(o) for o in offsets],
                                     device=device)
        n = self.ids.shape[0]
        offs = torch.tensor(offsets, dtype=torch.int32, device=device)
        p = pos_d[:, None] + offs[None, :]
        self.inb = (p >= 0) & (p < slen_d[:, None])
        pad = torch.nn.functional.pad(self.ids, (w, w))
        self.ctx = torch.stack([pad[w + o:w + o + n] for o in offsets], 1)
        self.offsets = offsets


def epoch_draws(gen: torch.Generator, corpus: DeviceCorpus):
    """The epoch's three draws from ``gen`` (on the corpus's device):
    ``keep`` (a uniform under each position's keep probability), the
    reduced window ``b`` in ``[1, W]`` and the negative pool's ``shift``
    in ``[0, P)``."""
    dev = corpus.ids.device
    n = corpus.ids.shape[0]
    keep = torch.rand(n, generator=gen, device=dev) < corpus.kp_pos
    b = torch.randint(1, corpus.window + 1, (n,), generator=gen, device=dev)
    shift = torch.randint(0, corpus.pool.numel(), (1,), generator=gen,
                          device=dev)[0]
    return keep, b, shift


def _sg_center_step(s0, s1n, c, cx, cm, ng, a):
    """One batch of the device route, per CENTER: ``c [B]`` against its
    2W context slots ``cx`` (validity ``cm``) and ``K`` negatives
    ``ng`` shared by its pairs. Loss: the exact pair sum
    Σ_pairs [log σ(v·u_o) + Σ_k log σ(-v·u_nk)] over the valid pairs,
    the negative term weighted per center by ``w_k``, the count of its
    valid pairs whose context is not ``ng[k]``."""
    v = s0[c]                                # [B, D]
    u_c = s1n[cx]                            # [B, 2W, D]
    u_n = s1n[ng]                            # [B, K, D]
    w_k = (cm[:, None, :] * (ng[:, :, None] != cx[:, None, :]).to(cm.dtype)
           ).sum(-1)                         # [B, K]
    npairs = cm.sum().clamp_min(1.0)

    def loss_fn(v_, uc_, un_):
        pos_ll = F.logsigmoid(_dot_rows(v_, uc_))
        neg_ll = F.logsigmoid(-_dot_rows(v_, un_))
        return -((cm * pos_ll).sum() + (w_k * neg_ll).sum()) / npairs

    loss, (gv, guc, gun) = sparse.rows_grad(loss_fn, v, u_c, u_n)
    d = gv.shape[-1]
    sparse.sgd_rows_(s0, c, gv, a)
    sparse.sgd_rows_(s1n, torch.cat([cx.reshape(-1), ng.reshape(-1)]),
                     torch.cat([guc.reshape(-1, d), gun.reshape(-1, d)]), a)
    return loss


def sg_device_epoch(syn0, syn1neg, corpus: DeviceCorpus, draws, alphas, *,
                    negative: int, batch: int) -> torch.Tensor:
    """One skip-gram / NS epoch on the device from the epoch's ``draws``
    (``epoch_draws``, or the JAX package's, fed in): subsampling masks
    pairs in place, windows shrink to ``b``, the negatives are the pool
    rolled by ``shift`` and tiled, and each batch takes its alpha from
    ``alphas [n_batches]``. Updates the tables in place; returns the
    ``[n_batches]`` losses."""
    keep, b, shift = draws
    w, n = corpus.window, corpus.ids.shape[0]
    pad_keep = torch.nn.functional.pad(keep, (w, w))
    keep_ctx = torch.stack(
        [pad_keep[w + o:w + o + n] for o in corpus.offsets], 1)
    cmask = (corpus.inb & (corpus.abs_offs[None, :] <= b[:, None])
             & keep[:, None] & keep_ctx).to(syn0.dtype)
    p = corpus.pool.numel()
    idx = torch.remainder(
        torch.arange(n * negative, device=shift.device) - shift, p)
    negs = corpus.pool[idx].reshape(n, negative)
    losses = []
    for i in range(n // batch):
        sl = slice(i * batch, (i + 1) * batch)
        losses.append(_sg_center_step(syn0, syn1neg, corpus.ids[sl],
                                      corpus.ctx[sl], cmask[sl], negs[sl],
                                      alphas[i]))
    return torch.stack(losses)


def _cbow_hidden(ctx_rows, ctx_mask):
    denom = ctx_mask.sum(-1, keepdim=True).clamp_min(1.0)
    return (ctx_rows * ctx_mask[..., None]).sum(1) / denom   # [B, D]


def _cbow_ns_step(syn0, syn1neg, ctx_ids, ctx_mask, targets, negs, mask,
                  alpha):
    """CBOW + negative sampling: mean of context vectors predicts the
    center word (reference ``CBOW.java`` iterateSample)."""
    ctx = syn0[ctx_ids]                      # [B, W, D]
    u_pos = syn1neg[targets]
    u_neg = syn1neg[negs]
    nvalid = (negs != targets[:, None]).to(ctx.dtype)

    def loss_fn(c_, up_, un_):
        h = _cbow_hidden(c_, ctx_mask)
        pos = F.logsigmoid((h * up_).sum(-1))
        neg = (nvalid * F.logsigmoid(-_dot_rows(h, un_))).sum(-1)
        return -(mask * (pos + neg)).sum() / mask.sum().clamp_min(1.0)

    loss, (gc, gp, gn) = sparse.rows_grad(loss_fn, ctx, u_pos, u_neg)
    sparse.sgd_rows_(syn0, ctx_ids, gc, alpha)
    sparse.sgd_rows_(syn1neg, torch.cat([targets, negs.reshape(-1)]),
                     torch.cat([gp, gn.reshape(-1, gn.shape[-1])]), alpha)
    return loss


def _cbow_hs_step(syn0, syn1, ctx_ids, ctx_mask, codes, points, path_mask,
                  mask, alpha):
    """CBOW + hierarchical softmax: context mean against the TARGET
    word's Huffman path."""
    ctx = syn0[ctx_ids]
    u = syn1[points]                         # [B, L, D]
    sign = 1.0 - 2.0 * codes

    def loss_fn(c_, u_):
        h = _cbow_hidden(c_, ctx_mask)
        ll = F.logsigmoid(sign * _dot_rows(h, u_)) * path_mask
        return -(mask * ll.sum(-1)).sum() / mask.sum().clamp_min(1.0)

    loss, (gc, gu) = sparse.rows_grad(loss_fn, ctx, u)
    sparse.sgd_rows_(syn0, ctx_ids, gc, alpha)
    sparse.sgd_rows_(syn1, points, gu, alpha)
    return loss


# ---------------------------------------------------------------------------
# Lookup table
# ---------------------------------------------------------------------------


def _host(t) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


class InMemoryLookupTable:
    """syn0/syn1/syn1neg embedding matrices on ``device`` (reference
    ``InMemoryLookupTable.java:55``); syn0 rows are the word vectors.
    The initial syn0 is the JAX package's draw from
    ``RandomState(seed)``, bit for bit."""

    def __init__(self, cache: VocabCache, layer_size: int, seed: int = 12345,
                 use_hs: bool = False, negative: int = 5, device=None):
        self.cache = cache
        self.layer_size = layer_size
        self.use_hs = use_hs
        self.negative = negative
        self.device = resolve_device(device)
        v = len(cache)
        rng = np.random.RandomState(seed)
        # reference resetWeights: syn0 ~ U(-0.5, 0.5)/layerSize
        syn0 = ((rng.rand(v, layer_size) - 0.5) / layer_size).astype(
            np.float32)
        self.syn0 = torch.from_numpy(syn0).to(self.device)
        zeros = lambda: torch.zeros((v, layer_size), device=self.device)
        self.syn1 = zeros() if use_hs else None
        self.syn1neg = zeros() if negative > 0 else None
        self._normalized: Optional[np.ndarray] = None

    def load_numpy(self, syn0, syn1=None, syn1neg=None) -> None:
        """Adopt host tables (the JAX package's ``syn0`` / ``syn1`` /
        ``syn1neg`` as numpy arrays), copied onto this table's device."""
        def put(a):
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        self.syn0 = put(syn0)
        if syn1 is not None:
            self.syn1 = put(syn1)
        if syn1neg is not None:
            self.syn1neg = put(syn1neg)
        self.invalidate_norms()

    def to_numpy(self):
        """``(syn0, syn1, syn1neg)`` as host arrays (None where absent)."""
        return _host(self.syn0), _host(self.syn1), _host(self.syn1neg)

    def vector(self, word: str) -> Optional[np.ndarray]:
        i = self.cache.index_of(word)
        return None if i < 0 else _host(self.syn0[i])

    def invalidate_norms(self):
        self._normalized = None

    def normalized(self) -> np.ndarray:
        if self._normalized is None:
            m = _host(self.syn0)
            norms = np.linalg.norm(m, axis=1, keepdims=True)
            self._normalized = m / np.maximum(norms, 1e-12)
        return self._normalized


# ---------------------------------------------------------------------------
# SequenceVectors: generic trainer over id sequences
# ---------------------------------------------------------------------------


class SequenceVectors:
    """Generic embedding trainer over integer id sequences (reference
    ``SequenceVectors<T>`` — DeepWalk and ParagraphVectors reuse it).

    Subclasses/owners supply: a built ``VocabCache`` and an iterable of
    id sequences per epoch (``_sequences()``). ``device``: where the
    tables live (default ``"cuda"``, raising without a card).
    """

    def __init__(self, cache: VocabCache, *, layer_size=100, window=5,
                 learning_rate=0.5, min_learning_rate=1e-4, negative=5,
                 use_hierarchic_softmax=False, sample=1e-3, epochs=1,
                 iterations=1, batch_size=1024, seed=12345,
                 algorithm="SkipGram", device=None):
        if negative <= 0 and not use_hierarchic_softmax:
            raise ValueError(
                "Need negative sampling (negative>0) or hierarchical "
                "softmax (use_hierarchic_softmax=True)"
            )
        self.cache = cache
        self.layer_size = layer_size
        self.window = window
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.sample = sample
        self.epochs = epochs
        self.iterations = iterations
        self.batch_size = batch_size
        self.seed = seed
        self.algorithm = algorithm
        self.device = resolve_device(device)
        self.scan_chunk = 16  # skip-gram batches a prepared chunk
        # Device-resident epoch replay: the prepared (ids, negatives,
        # masks, alphas) chunks of an epoch are kept on the device keyed
        # by everything that shapes them (``_epoch_cache_key``), so a
        # repeated fit skips the host pair generation and transfer. The
        # cached arrays are bit-identical to regeneration (same seeds);
        # a subclass that mutates its corpus under the same seed must
        # call clear_epoch_cache(). Bounded by
        # ``epoch_cache_budget_bytes``; 0 disables it.
        self.cache_epoch_data = True
        self.epoch_cache_budget_bytes = 256 * 2 ** 20
        self._epoch_cache: dict = {}
        self._epoch_cache_bytes = 0
        # On-device epoch generation (skip-gram/NS only): "auto" = on
        # for a table on the card, off on the CPU; True/False force.
        self.device_epoch_gen = "auto"
        self._dev_gen: Optional[torch.Generator] = None
        self._dev_corpus = None  # (key, DeviceCorpus)
        self._dev_upload_bytes = 0
        # device-route continuation: a repeated fit() draws fresh epochs
        # (the generator runs on) and continues the lr schedule where
        # the last fit stopped
        self._dev_fit_no = 0
        self._dev_steps_done = 0
        self.lookup = self._make_lookup()
        self._rng = np.random.RandomState(seed)
        if use_hierarchic_softmax:
            huff = Huffman(cache.words)
            huff.build()
            self._codes, self._points, self._code_lens = huff.padded_arrays()
        if negative > 0:
            self._table = build_unigram_table(cache)
        self._counts = np.array([w.count for w in cache.words], np.int64)

    def _make_lookup(self) -> InMemoryLookupTable:
        """Lookup-table factory hook: the sharded subclass
        (``embeddings/word2vec.py``) substitutes row-sharded tables."""
        return InMemoryLookupTable(
            self.cache, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative, device=self.device,
        )

    # -- corpus plumbing ----------------------------------------------------

    def _sequences(self) -> Iterable[np.ndarray]:
        raise NotImplementedError

    def _flatten_corpus(self, rng):
        """Concatenate every sequence into corpus-wide arrays for
        vectorized window generation: (all_ids, pos-in-sentence,
        own-sentence-length, reduced-window draw b ~ U{1..window}) —
        after frequent-word subsampling. Returns None for an
        empty/too-short corpus."""
        total = self.cache.total_word_count
        seqs = [np.asarray(ids, np.int32) for ids in self._sequences()]
        seqs = [s for s in seqs if len(s) > 0]
        if not seqs:
            return None
        all_ids = np.concatenate(seqs)
        lens = np.array([len(s) for s in seqs], np.int32)
        sent = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
        if self.sample > 0:
            keep = subsample_mask(
                all_ids, self._counts, total, self.sample, rng
            )
            all_ids = all_ids[keep]
            sent = sent[keep]
            lens = np.bincount(sent, minlength=len(lens)).astype(np.int32)
        n = len(all_ids)
        if n < 2:
            return None
        starts = np.repeat(
            np.cumsum(lens, dtype=np.int64).astype(np.int32) - lens, lens
        )
        pos = np.arange(n, dtype=np.int32) - starts
        slen = np.repeat(lens, lens)
        b = rng.randint(1, self.window + 1, n)
        return all_ids, pos, slen, b

    def _gen_pairs(self, epoch_seed: int):
        """(centers, contexts) int32 arrays for one epoch: reduced
        window sampling + frequent-word subsampling (reference
        SkipGram.learnSequence), vectorized over the whole corpus."""
        rng = np.random.RandomState(epoch_seed)
        flat = self._flatten_corpus(rng)
        if flat is None:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        all_ids, pos, slen, b = flat
        centers: List[np.ndarray] = []
        contexts: List[np.ndarray] = []
        for off in range(1, self.window + 1):
            idx = np.nonzero(b >= off)[0]
            left = idx[pos[idx] >= off]
            centers.append(all_ids[left])
            contexts.append(all_ids[left - off])
            right = idx[pos[idx] < slen[idx] - off]
            centers.append(all_ids[right])
            contexts.append(all_ids[right + off])
        c = np.concatenate(centers).astype(np.int32)
        o = np.concatenate(contexts).astype(np.int32)
        perm = rng.permutation(len(c))
        return c[perm], o[perm]

    def _gen_cbow(self, epoch_seed: int):
        """(targets[N], ctx_ids[N, 2W], ctx_mask[N, 2W]) for one epoch
        (true windowed CBOW: all context words within the reduced
        window feed one averaged prediction)."""
        rng = np.random.RandomState(epoch_seed)
        W = self.window
        offsets = [o for o in range(-W, W + 1) if o != 0]
        flat = self._flatten_corpus(rng)
        if flat is None:
            z = np.zeros((0, 2 * W), np.int32)
            return np.zeros(0, np.int32), z, z.astype(np.float32)
        all_ids, pos, slen, b = flat
        n = len(all_ids)
        padded = np.pad(all_ids, (W, W))
        cols, masks = [], []
        for off in offsets:
            cols.append(padded[W + off:W + off + n])
            masks.append(
                (pos + off >= 0) & (pos + off < slen)
                & (np.abs(off) <= b)
            )
        ctx = np.stack(cols, 1).astype(np.int32)
        cm = np.stack(masks, 1)
        keep_rows = cm.any(axis=1)
        t = all_ids[keep_rows].astype(np.int32)
        c = ctx[keep_rows]
        m = cm[keep_rows].astype(np.float32)
        perm = rng.permutation(len(t))
        return t[perm], c[perm], m[perm]

    # -- training -----------------------------------------------------------

    def clear_epoch_cache(self) -> None:
        """Drop the device-resident epoch replay cache AND the
        device-generation corpus arrays (required after mutating the
        corpus without changing the seed)."""
        self._epoch_cache.clear()
        self._epoch_cache_bytes = 0
        self._dev_corpus = None

    def _epoch_cache_key(self, ep_seed: int, step: int):
        """Everything that shapes the prepared chunk arrays: epoch
        seed + step offset (negatives, alpha offsets), geometry, the
        hyperparameters baked into alphas/negatives/hs-paths, and the
        pair-generation knobs."""
        return (
            ep_seed, step, self.batch_size, self.scan_chunk,
            self.learning_rate, self.min_learning_rate, self.epochs,
            self.negative, self.use_hs,
            self.window, self.sample, self.algorithm,
        )

    @staticmethod
    def _chunks_nbytes(chunks) -> int:
        return sum(a.numel() * a.element_size()
                   for tup in chunks for a in tup[:-1] if a is not None)

    def _use_device_gen(self) -> bool:
        # the device route re-derives skip-gram windows from
        # ``_sequences``: a subclass with pairs of its own
        # (ParagraphVectors' label -> word pairs) stays on the host
        # routes (the JAX package's "auto" sends it to the device route
        # on a TPU, training plain skip-gram over the documents' words)
        if not (self.algorithm == "SkipGram" and self.negative > 0
                and not self.use_hs and self.iterations == 1
                and self._scan_path_ok()
                and type(self)._gen_pairs is SequenceVectors._gen_pairs):
            return False
        flag = self.device_epoch_gen
        if flag == "auto":
            return self.lookup.syn0.device.type == "cuda"
        return bool(flag)

    def _flat_corpus_static(self):
        """One-time (ids, pos, slen) over the UNsubsampled corpus for
        the device-generation path — subsampling is drawn on device
        per epoch, so these arrays are epoch-independent."""
        seqs = [np.asarray(ids, np.int32) for ids in self._sequences()]
        seqs = [s for s in seqs if len(s) > 0]
        if not seqs:
            return None
        all_ids = np.concatenate(seqs)
        lens = np.array([len(s) for s in seqs], np.int32)
        starts = np.repeat(
            np.cumsum(lens, dtype=np.int64).astype(np.int32) - lens, lens
        )
        pos = np.arange(len(all_ids), dtype=np.int32) - starts
        slen = np.repeat(lens, lens)
        return all_ids, pos, slen

    def _keep_probs(self) -> np.ndarray:
        """Per-word P(keep) of frequent-word subsampling (reference
        SkipGram sample branch), as a [V] table for device draws."""
        v = len(self._counts)
        if self.sample <= 0:
            return np.ones(v, np.float32)
        total = max(self.cache.total_word_count, 1)
        freq = self._counts / total
        kp = (np.sqrt(freq / self.sample) + 1) * (
            self.sample / np.maximum(freq, 1e-12)
        )
        return np.minimum(kp, 1.0).astype(np.float32)

    def device_corpus(self) -> Optional[DeviceCorpus]:
        """The device route's corpus on the table's device, built once
        per (batch, negative, sample, seed). Where the vocabulary is
        under 2**16 words and every sentence under 256, the keep
        probabilities are quantized to u16 fixed point, as the JAX
        package's packed upload does (``round(kp * 65535) / 65535``)."""
        B = self.batch_size
        dev_key = (B, self.negative, self.sample, self.seed)
        if self._dev_corpus is not None and self._dev_corpus[0] != dev_key:
            self._dev_corpus = None
        if self._dev_corpus is None:
            flat = self._flat_corpus_static()
            if flat is None:
                return None
            all_ids, pos, slen = flat
            n = len(all_ids)
            pad = (-n) % B
            if pad:
                all_ids = np.pad(all_ids, (0, pad))
                pos = np.pad(pos, (0, pad))
                slen = np.pad(slen, (0, pad))  # slen 0 -> no pairs
            V = len(self._counts)
            pool_rng = np.random.RandomState(self.seed ^ 0x5EED)
            P = int(min(len(all_ids) * self.negative, _NEG_POOL_MAX))
            pool = self._table[pool_rng.randint(0, len(self._table), P)]
            narrow = V < 2 ** 16
            if narrow and int(slen.max(initial=0)) < 256:
                kp_q = np.round(self._keep_probs() * 65535.0).astype(
                    np.uint16)
                kp = kp_q.astype(np.float32) / np.float32(65535.0)
                pos, slen = pos.astype(np.uint8), slen.astype(np.uint8)
            else:
                kp = self._keep_probs()
            idt = np.uint16 if narrow else np.int32
            host = (all_ids.astype(idt), pos, slen, kp, pool.astype(idt))
            self._dev_upload_bytes = sum(a.nbytes for a in host)
            self._dev_corpus = (dev_key, DeviceCorpus(
                *host, n, self.window, self.lookup.syn0.device))
        return self._dev_corpus[1]

    def _fit_device_gen(self, draws=None) -> Optional[torch.Tensor]:
        """The on-device generation route: ``epochs`` epochs, each drawn
        from the trainer's ``torch.Generator`` (seeded with ``seed`` at
        the first device fit and running on across fits) unless
        ``draws`` (one ``(keep, b, shift)`` per epoch) are given.
        Returns the ``[epochs, n_batches]`` losses on the device."""
        corpus = self.device_corpus()
        if corpus is None:
            return None
        B = self.batch_size
        n_batches = corpus.ids.shape[0] // B
        E = self.epochs
        lk = self.lookup
        dev = lk.syn0.device
        if self._dev_gen is None:
            self._dev_gen = torch.Generator(device=dev).manual_seed(
                int(self.seed))
        total = max((self._dev_steps_done + n_batches * E) * B, 1)
        alphas = torch.from_numpy(alpha_schedule(
            self.learning_rate, self.min_learning_rate, float(total),
            float(self._dev_steps_done), E, n_batches, B)).to(dev)
        losses = []
        for e in range(E):
            d = (epoch_draws(self._dev_gen, corpus) if draws is None
                 else tuple(torch.as_tensor(np.array(a)).to(dev)
                            for a in draws[e]))
            losses.append(sg_device_epoch(
                lk.syn0, lk.syn1neg, corpus, d, alphas[e],
                negative=self.negative, batch=B))
        self._dev_fit_no += 1
        self._dev_steps_done += n_batches * E
        lk.invalidate_norms()
        return torch.stack(losses)

    def fit(self) -> None:
        if self._use_device_gen():
            self._fit_device_gen()
            return
        B = self.batch_size
        lr0, lr_min = self.learning_rate, self.min_learning_rate
        total_items = None
        step = 0
        cbow = self.algorithm == "CBOW"
        for epoch in range(self.epochs):
            scan_ok = (
                not cbow and self.scan_chunk > 1
                and self.iterations == 1
                and self._scan_path_ok()
            )
            ep_seed = self.seed + 31 * epoch
            caching = (
                self.cache_epoch_data
                and self.epoch_cache_budget_bytes > 0
            )
            if scan_ok:
                key = self._epoch_cache_key(ep_seed, step)
                entry = self._epoch_cache.get(key) if caching else None
                if entry is not None:
                    n_items, chunks = entry
                    if total_items is None:
                        total_items = max(n_items * self.epochs, 1)
                    step = self._run_scan_chunks(chunks, step)
                    continue
            if cbow:
                t, c, m = self._gen_cbow(ep_seed)
                n_items = len(t)
            else:
                c, o = self._gen_pairs(ep_seed)
                n_items = len(c)
            if total_items is None:
                total_items = max(n_items * self.epochs, 1)
            if scan_ok:
                chunks = self._prepare_scan_chunks(
                    c, o, step, total_items, lr0, lr_min
                )
                if caching:
                    nbytes = self._chunks_nbytes(chunks)
                    if (self._epoch_cache_bytes + nbytes
                            <= self.epoch_cache_budget_bytes):
                        self._epoch_cache[key] = (n_items, chunks)
                        self._epoch_cache_bytes += nbytes
                step = self._run_scan_chunks(chunks, step)
                continue
            for s in range(0, n_items, B):
                mask = np.ones(B, np.float32)
                if cbow:
                    tb, cb, mb = t[s:s + B], c[s:s + B], m[s:s + B]
                    if len(tb) < B:
                        pad = B - len(tb)
                        mask[len(tb):] = 0.0
                        tb = np.pad(tb, (0, pad))
                        cb = np.pad(cb, ((0, pad), (0, 0)))
                        mb = np.pad(mb, ((0, pad), (0, 0)))
                else:
                    cb, ob = c[s:s + B], o[s:s + B]
                    if len(cb) < B:
                        pad = B - len(cb)
                        mask[len(cb):] = 0.0
                        cb = np.pad(cb, (0, pad))
                        ob = np.pad(ob, (0, pad))
                frac = min((step * B) / total_items, 1.0)
                alpha = max(lr0 * (1 - frac), lr_min)
                for _ in range(self.iterations):
                    if cbow:
                        self._apply_cbow_batch(tb, cb, mb, mask, alpha, step)
                    else:
                        self._apply_batch(cb, ob, mask, alpha, step)
                step += 1
        self.lookup.invalidate_norms()

    def _scan_path_ok(self) -> bool:
        """The chunked epoch bypasses the per-batch ``_apply_batch``
        hook; a subclass overriding it would silently lose its override,
        so chunking requires either the base hook or an explicit
        ``scan_path_compatible = True``."""
        return (
            type(self)._apply_batch is SequenceVectors._apply_batch
            or getattr(self, "scan_path_compatible", False)
        )

    def _prepare_scan_chunks(self, centers, contexts, step, total_items,
                             lr0, lr_min) -> list:
        """The device-resident chunk arrays of one chunked skip-gram
        epoch: ``scan_chunk`` batches a chunk, with the per-batch path's
        math, negatives and alphas (same per-batch step seeds). The
        chunks are kept for epoch replay."""
        B = self.batch_size
        K = self.scan_chunk
        n = len(centers)
        # word ids cross at their own width (uint16 under 64k words)
        # and are widened on the device
        idt = np.uint16 if len(self._counts) < 2 ** 16 else np.int32
        chunks = []
        for s0 in range(0, n, B * K):
            cs = centers[s0:s0 + B * K]
            os_ = contexts[s0:s0 + B * K]
            k = (len(cs) + B - 1) // B
            pad = k * B - len(cs)
            mask = np.ones(k * B, np.float32)
            if pad:
                mask[len(cs):] = 0.0
                cs = np.pad(cs, (0, pad))
                os_ = np.pad(os_, (0, pad))
            ck = cs.reshape(k, B).astype(idt, copy=False)
            ok = os_.reshape(k, B).astype(idt, copy=False)
            mk = mask.reshape(k, B)
            alphas = np.empty(k, np.float32)
            negs = (
                np.empty((k, B, self.negative), idt)
                if self.negative > 0 else None
            )
            for i in range(k):
                frac = min(((step + i) * B) / total_items, 1.0)
                alphas[i] = max(lr0 * (1 - frac), lr_min)
                if negs is not None:
                    negs[i] = self._sample_negatives(B, step + i)
            if self.use_hs:
                codes, points, pmask = self._path_arrays(ok.ravel())
                ckd = codes.reshape(k, B, -1)
                ptd = points.reshape(k, B, -1)
                pmd = pmask.reshape(k, B, -1)
            else:
                ckd = ptd = pmd = None
            chunks.append((
                self._put_stacked(ck), self._put_stacked(ok),
                ckd, ptd, pmd,
                self._put_stacked(negs) if negs is not None else None,
                self._put_stacked(mk), self._put_stacked(alphas), k,
            ))
            step += k
        return chunks

    def _run_scan_chunks(self, chunks, step) -> int:
        """Run a prepared epoch: the chunks in order, no host work (the
        device-resident replay path)."""
        lk = self.lookup
        for (ck, ok, ckd, ptd, pmd, negs, mk, alphas, k) in chunks:
            _sg_scan_steps(lk.syn0, lk.syn1, lk.syn1neg, ck, ok, ckd, ptd,
                           pmd, negs, mk, alphas)
            step += k
        return step

    def _put_stacked(self, a):
        """Placement hook for [k, B, ...] stacked batch arrays."""
        return _to_device(a, self.lookup.syn0.device)

    def _path_arrays(self, word_ids: np.ndarray):
        dev = self.lookup.syn0.device
        lens = self._code_lens[word_ids]
        pmask = (np.arange(self._codes.shape[1])[None, :]
                 < lens[:, None]).astype(np.float32)
        return (_to_device(self._codes[word_ids], dev),
                _to_device(self._points[word_ids], dev),
                _to_device(pmask, dev))

    def _apply_batch(self, centers, contexts, mask, alpha, step):
        lk = self.lookup
        dev = lk.syn0.device
        mask = _to_device(mask, dev)
        cb = _to_device(centers, dev)
        ob = _to_device(contexts, dev)
        if self.use_hs:
            codes, points, pmask = self._path_arrays(contexts)
            _hs_step_raw(lk.syn0, lk.syn1, cb, codes, points, pmask, mask,
                         alpha)
        if self.negative > 0:
            negs = _to_device(self._sample_negatives(len(centers), step),
                              dev)
            _ns_step_raw(lk.syn0, lk.syn1neg, cb, ob, negs, mask, alpha)

    def _apply_cbow_batch(self, targets, ctx_ids, ctx_mask, mask, alpha,
                          step):
        lk = self.lookup
        dev = lk.syn0.device
        mask = _to_device(mask, dev)
        tb = _to_device(targets, dev)
        cb = _to_device(ctx_ids, dev)
        cm = _to_device(ctx_mask, dev)
        if self.use_hs:
            codes, points, pmask = self._path_arrays(targets)
            _cbow_hs_step(lk.syn0, lk.syn1, cb, cm, codes, points, pmask,
                          mask, alpha)
        if self.negative > 0:
            negs = _to_device(self._sample_negatives(len(targets), step),
                              dev)
            _cbow_ns_step(lk.syn0, lk.syn1neg, cb, cm, tb, negs, mask,
                          alpha)

    def _sample_negatives(self, b: int, step: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed + step) % (2**31))
        idx = rng.randint(0, len(self._table), (b, self.negative))
        return self._table[idx]

    # -- query API (reference BasicModelUtils / wordVectors) ----------------

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup.vector(word)

    def has_word(self, word: str) -> bool:
        return word in self.cache

    def similarity(self, a: str, b: str) -> float:
        """Cosine similarity (reference
        ``BasicModelUtils.similarity``)."""
        ia, ib = self.cache.index_of(a), self.cache.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        m = self.lookup.normalized()
        return float(m[ia] @ m[ib])

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        """Top-n by cosine (reference ``wordsNearest``) — one matmul
        over the normalized table."""
        i = self.cache.index_of(word)
        if i < 0:
            return []
        m = self.lookup.normalized()
        sims = m @ m[i]
        sims[i] = -np.inf
        top = np.argsort(-sims)[:n]
        return [self.cache.word_at(int(t)) for t in top]

    def words_nearest_vec(self, vec: np.ndarray, n: int = 10) -> List[str]:
        m = self.lookup.normalized()
        v = vec / max(np.linalg.norm(vec), 1e-12)
        sims = m @ v
        top = np.argsort(-sims)[:n]
        return [self.cache.word_at(int(t)) for t in top]


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------


class Word2Vec(SequenceVectors):
    """Word2Vec over a sentence corpus (reference
    ``models/word2vec/Word2Vec.java`` builder API)."""

    def __init__(self, cache, sentences_ids, **kw):
        super().__init__(cache, **kw)
        self._sentence_ids = sentences_ids

    def _sequences(self):
        return iter(self._sentence_ids)

    class Builder:
        def __init__(self):
            self._min_word_frequency = 1
            self._layer_size = 100
            self._window = 5
            self._lr = 0.5
            self._min_lr = 1e-4
            self._negative = 5
            self._hs = False
            self._sample = 1e-3
            self._epochs = 1
            self._iterations = 1
            self._batch_size = 1024
            self._seed = 12345
            self._algorithm = "SkipGram"
            self._iterator = None
            self._tokenizer = None
            self._device = None

        def min_word_frequency(self, n): self._min_word_frequency = n; return self
        def layer_size(self, n): self._layer_size = n; return self
        def window_size(self, n): self._window = n; return self
        def learning_rate(self, x): self._lr = x; return self
        def min_learning_rate(self, x): self._min_lr = x; return self
        def negative_sample(self, n): self._negative = int(n); return self
        def use_hierarchic_softmax(self, b): self._hs = b; return self
        def sampling(self, x): self._sample = x; return self
        def epochs(self, n): self._epochs = n; return self
        def iterations(self, n): self._iterations = n; return self
        def batch_size(self, n): self._batch_size = n; return self
        def seed(self, n): self._seed = n; return self
        def elements_learning_algorithm(self, a): self._algorithm = a; return self
        def iterate(self, it): self._iterator = it; return self
        def tokenizer_factory(self, tf): self._tokenizer = tf; return self
        def device(self, d): self._device = d; return self

        def build(self) -> "Word2Vec":
            if self._iterator is None:
                raise ValueError("iterate(sentence_iterator) is required")
            tf = self._tokenizer or DefaultTokenizerFactory()
            sentences = [
                tf.create(s).get_tokens() for s in self._iterator
            ]
            cache = VocabConstructor(
                min_word_frequency=self._min_word_frequency
            ).build_vocab_from_tokens(sentences)
            ids = [
                np.asarray(cache.id_stream(toks), np.int64)
                for toks in sentences
            ]
            return Word2Vec(
                cache, ids,
                layer_size=self._layer_size, window=self._window,
                learning_rate=self._lr, min_learning_rate=self._min_lr,
                negative=self._negative, use_hierarchic_softmax=self._hs,
                sample=self._sample, epochs=self._epochs,
                iterations=self._iterations, batch_size=self._batch_size,
                seed=self._seed, algorithm=self._algorithm,
                device=self._device,
            )

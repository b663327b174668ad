"""ParagraphVectors — document embeddings, PV-DBOW and PV-DM
(reference: ``models/paragraphvectors/ParagraphVectors.java`` with
sequence learning algorithms ``DBOW.java`` / ``DM.java``).

Labels (document ids) get embedding rows in the SAME syn0 table,
appended after the word vocab (the reference interleaves label
VocabWords into the vocab). DBOW: the label vector predicts each word
of the document (skip-gram with the label as center). DM: the label
vector joins the context-window average that predicts each word
(CBOW with one extra context slot).

Counterpart of ``deeplearning4j_tpu/nlp/paragraph_vectors.py``: the
pair and window generators are its numpy streams, the training runs
through the port's ``SequenceVectors`` routes, and ``infer_vector``
descends a fresh document vector against the frozen tables.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    LabelAwareIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor, VocabWord
from deeplearning4j_tpu_torch.embeddings import sparse
from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors


def _infer_step(v, syn1neg, words, negs, alpha):
    """One inference gradient step on a fresh doc vector ``v [D]``,
    tables frozen: the DBOW negative-sampling objective over all of the
    document's words at once."""
    u_pos = syn1neg[words]                      # [n, D]
    u_neg = syn1neg[negs]                       # [n, K, D]
    nvalid = (negs != words[:, None]).to(v.dtype)

    def loss(v_):
        pos = F.logsigmoid(u_pos @ v_)
        neg = (nvalid * F.logsigmoid(-(u_neg @ v_))).sum(-1)
        return -(pos + neg).mean()

    _, (g,) = sparse.rows_grad(loss, v)
    return v - alpha * g


class ParagraphVectors(SequenceVectors):
    def __init__(self, cache: VocabCache, doc_ids: List[np.ndarray],
                 doc_labels: List[List[str]], label_index: Dict[str, int],
                 algorithm: str = "DBOW", **kw):
        kw.setdefault("sample", 0.0)
        super().__init__(cache, algorithm="SkipGram", **kw)
        self._pv_algorithm = algorithm
        self._doc_ids = doc_ids
        self._doc_labels = doc_labels
        self._label_index = label_index  # label -> row in syn0
        self._n_words = min(label_index.values(), default=len(cache))
        if self.negative > 0:
            # labels must not be drawn as negatives for word pairs
            from deeplearning4j_tpu_torch.nlp.vocab import build_unigram_table

            self._table = build_unigram_table(cache, limit=self._n_words)

    # SequenceVectors hooks -------------------------------------------------

    def _sequences(self):
        return iter(self._doc_ids)

    def _gen_pairs(self, epoch_seed: int):
        """DBOW pairs: (label_row, word) for every word of each doc
        (reference DBOW.learnSequence: iterateSample(label, word))."""
        rng = np.random.RandomState(epoch_seed)
        centers, contexts = [], []
        for ids, labels in zip(self._doc_ids, self._doc_labels):
            if len(ids) == 0:
                continue
            for lab in labels:
                row = self._label_index[lab]
                centers.append(np.full(len(ids), row, np.int32))
                contexts.append(np.asarray(ids, np.int32))
        if not centers:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        c = np.concatenate(centers)
        o = np.concatenate(contexts)
        perm = rng.permutation(len(c))
        return c[perm], o[perm]

    def _gen_cbow(self, epoch_seed: int):
        """DM items: window context + label row predict the center
        word (reference DM.java)."""
        rng = np.random.RandomState(epoch_seed)
        W = self.window
        offsets = [o for o in range(-W, W + 1) if o != 0]
        t_list, c_list, m_list = [], [], []
        for ids, labels in zip(self._doc_ids, self._doc_labels):
            ids = np.asarray(ids, np.int64)
            n = len(ids)
            if n < 2 or not labels:
                continue
            b = rng.randint(1, W + 1, n)
            padded = np.pad(ids, (W, W))
            pos = np.arange(n)
            base_cols, base_masks = [], []
            for off in offsets:
                base_cols.append(padded[W + off:W + off + n])
                base_masks.append(
                    (pos + off >= 0) & (pos + off < n) & (np.abs(off) <= b)
                )
            # one training example per label: each label row joins the
            # context window (reference DM trains every sequence label)
            for lab in labels:
                row = self._label_index[lab]
                cols = base_cols + [np.full(n, row, np.int64)]
                masks = base_masks + [np.ones(n, bool)]
                ctx = np.stack(cols, 1).astype(np.int32)
                cm = np.stack(masks, 1)
                t_list.append(ids.astype(np.int32))
                c_list.append(ctx)
                m_list.append(cm.astype(np.float32))
        if not t_list:
            z = np.zeros((0, 2 * W + 1), np.int32)
            return np.zeros(0, np.int32), z, z.astype(np.float32)
        t = np.concatenate(t_list)
        c = np.concatenate(c_list)
        m = np.concatenate(m_list)
        perm = rng.permutation(len(t))
        return t[perm], c[perm], m[perm]

    def fit(self) -> None:
        # route DBOW through pair training, DM through cbow training
        self.algorithm = "CBOW" if self._pv_algorithm == "DM" else "SkipGram"
        super().fit()

    # query -----------------------------------------------------------------

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        """Word-level query: label rows are excluded."""
        i = self.cache.index_of(word)
        if i < 0:
            return []
        m = self.lookup.normalized()[:self._n_words]
        sims = m @ m[i]
        sims[i] = -np.inf
        return [self.cache.word_at(int(t)) for t in np.argsort(-sims)[:n]]

    def words_nearest_vec(self, vec: np.ndarray, n: int = 10) -> List[str]:
        m = self.lookup.normalized()[:self._n_words]
        v = vec / max(np.linalg.norm(vec), 1e-12)
        sims = m @ v
        return [self.cache.word_at(int(t)) for t in np.argsort(-sims)[:n]]

    def get_vector(self, label: str) -> Optional[np.ndarray]:
        row = self._label_index.get(label)
        return None if row is None else self.lookup.syn0[row].cpu().numpy()

    def infer_vector(self, tokens, epochs: int = 10,
                     learning_rate: float = 0.05,
                     seed: int = 0) -> np.ndarray:
        """Embed an UNSEEN document (reference
        ``ParagraphVectors.inferVector``): gradient-descend a fresh
        doc vector against the frozen word/output tables under the
        DBOW objective — one jitted step per epoch over all of the
        doc's words at once. Requires negative sampling (the training
        default); HS-only models raise (NS is the inference
        objective)."""
        if self.lookup.syn1neg is None:
            raise ValueError(
                "infer_vector needs a negative-sampling model "
                "(negative > 0); this model was trained with "
                "hierarchical softmax only"
            )
        if isinstance(tokens, str):
            tokens = tokens.split()
        ids = np.asarray(
            [
                self.cache.index_of(t) for t in tokens
                if t in self.cache
                and self.cache.index_of(t) < self._n_words
            ],
            np.int32,
        )
        rng = np.random.RandomState(seed)
        dev = self.lookup.syn1neg.device
        v = torch.from_numpy(
            ((rng.rand(self.layer_size) - 0.5) / self.layer_size).astype(
                np.float32)).to(dev)
        if len(ids) == 0:
            return v.cpu().numpy()
        words = torch.from_numpy(ids).to(dev).long()
        for e in range(epochs):
            negs = torch.from_numpy(self._table[
                rng.randint(0, len(self._table),
                            (len(ids), self.negative))
            ]).to(dev).long()
            alpha = float(np.float32(
                max(learning_rate * (1 - e / max(epochs, 1)),
                    self.min_learning_rate)
            ))
            v = _infer_step(v, self.lookup.syn1neg, words, negs, alpha)
        return v.cpu().numpy()

    def similarity_to_label(self, a: str, b: str) -> float:
        ra, rb = self._label_index.get(a), self._label_index.get(b)
        if ra is None or rb is None:
            return float("nan")
        m = self.lookup.normalized()
        return float(m[ra] @ m[rb])

    def nearest_labels(self, label: str, n: int = 5) -> List[str]:
        row = self._label_index.get(label)
        if row is None:
            return []
        m = self.lookup.normalized()
        sims = m @ m[row]
        inv = {v: k for k, v in self._label_index.items()}
        order = [
            i for i in np.argsort(-sims)
            if int(i) in inv and int(i) != row
        ]
        return [inv[int(i)] for i in order[:n]]

    class Builder:
        def __init__(self):
            self._kw = {}
            self._min_word_frequency = 1
            self._iterator: Optional[LabelAwareIterator] = None
            self._tokenizer = None
            self._algorithm = "DBOW"

        def min_word_frequency(self, n):
            self._min_word_frequency = n; return self

        def layer_size(self, n): self._kw["layer_size"] = n; return self
        def window_size(self, n): self._kw["window"] = n; return self
        def learning_rate(self, x): self._kw["learning_rate"] = x; return self
        def min_learning_rate(self, x):
            self._kw["min_learning_rate"] = x; return self
        def negative_sample(self, n): self._kw["negative"] = int(n); return self
        def epochs(self, n): self._kw["epochs"] = n; return self
        def batch_size(self, n): self._kw["batch_size"] = n; return self
        def seed(self, n): self._kw["seed"] = n; return self
        def sequence_learning_algorithm(self, a):
            self._algorithm = a; return self
        def iterate(self, it: LabelAwareIterator): self._iterator = it; return self
        def tokenizer_factory(self, tf): self._tokenizer = tf; return self
        def device(self, d): self._kw["device"] = d; return self

        def build(self) -> "ParagraphVectors":
            if self._iterator is None:
                raise ValueError("iterate(LabelAwareIterator) is required")
            tf = self._tokenizer or DefaultTokenizerFactory()
            docs = list(self._iterator)
            token_docs = [tf.create(d.content).get_tokens() for d in docs]
            cache = VocabConstructor(
                min_word_frequency=self._min_word_frequency
            ).build_vocab_from_tokens(token_docs)
            # append label rows to the vocab (reference: labels become
            # special VocabWords)
            label_index: Dict[str, int] = {}
            for d in docs:
                for lab in d.labels:
                    if lab not in label_index:
                        vw = VocabWord(f"\x00label:{lab}", 1)
                        cache.add(vw)
                        label_index[lab] = vw.index
            doc_ids = [
                np.asarray(cache.id_stream(t), np.int64) for t in token_docs
            ]
            doc_labels = [d.labels for d in docs]
            return ParagraphVectors(
                cache, doc_ids, doc_labels, label_index,
                algorithm=self._algorithm, **self._kw,
            )

"""Bag-of-words / TF-IDF text vectorizers (reference
``bagofwords/vectorizer/BagOfWordsVectorizer.java``,
``TfidfVectorizer.java:1``, ``BaseTextVectorizer.java`` — fit a vocab
over labeled documents, then ``vectorize(text, label) -> DataSet``).

The fit pass builds the vocab + document frequencies host-side (the
reference's VocabConstructor pass); transform is a dense [1, V] row —
small enough that sparse storage buys nothing where these rows feed
classifier matmuls.

Counterpart of ``deeplearning4j_tpu/nlp/vectorizers.py``: the fit and
the weights are the same host numpy; ``vectorize`` / ``vectorize_all``
hand back a ``DataSet`` of tensors on the vectorizer's ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


class BaseTextVectorizer:
    """Shared fit machinery (reference ``BaseTextVectorizer.java``)."""

    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory=None,
                 stop_words: Optional[Sequence[str]] = None,
                 labels: Optional[Sequence[str]] = None, device=None):
        self.device = resolve_device(device)
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop_words = set(stop_words or ())
        self.labels: List[str] = list(labels or [])
        self.cache: Optional[VocabCache] = None
        self.doc_freq: Optional[np.ndarray] = None
        self.n_docs = 0

    def _tokens(self, text: str) -> List[str]:
        toks = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    def fit(self, documents: Iterable[Tuple[str, str]]) -> None:
        """``documents``: (text, label) pairs (reference
        LabelAwareIterator)."""
        token_lists = []
        doc_labels = []
        for text, label in documents:
            token_lists.append(self._tokens(text))
            doc_labels.append(label)
        for lab in doc_labels:
            if lab not in self.labels:
                self.labels.append(lab)
        self.cache = VocabConstructor(
            min_word_frequency=self.min_word_frequency
        ).build_vocab_from_tokens(token_lists)
        self.n_docs = len(token_lists)
        df = np.zeros((len(self.cache),), np.int64)
        for toks in token_lists:
            for w in set(toks):
                i = self.cache.index_of(w)
                if i >= 0:
                    df[i] += 1
        self.doc_freq = df

    # -- transform -------------------------------------------------------

    def _counts(self, text: str) -> np.ndarray:
        row = np.zeros((len(self.cache),), np.float32)
        for w in self._tokens(text):
            i = self.cache.index_of(w)
            if i >= 0:
                row[i] += 1.0
        return row

    def _weights(self, counts: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, text: str) -> np.ndarray:
        """[V] weight row for one document."""
        if self.cache is None:
            raise RuntimeError("fit() first")
        return self._weights(self._counts(text))

    def _rows(self, documents) -> Tuple[np.ndarray, np.ndarray]:
        """Host ``([n, V] weights, [n, labels] one-hot)``."""
        rows, ys = [], []
        for text, label in documents:
            rows.append(self.transform(text))
            y = np.zeros((max(len(self.labels), 1),), np.float32)
            if label in self.labels:
                y[self.labels.index(label)] = 1.0
            ys.append(y)
        return np.stack(rows), np.stack(ys)

    def _dataset(self, x: np.ndarray, y: np.ndarray) -> DataSet:
        return DataSet(features=torch.from_numpy(x).to(self.device),
                       labels=torch.from_numpy(y).to(self.device))

    def vectorize(self, text: str, label: str) -> DataSet:
        """(reference ``vectorize(String, String) -> DataSet``): one
        ``[1, V]`` row on the vectorizer's device."""
        return self._dataset(*self._rows([(text, label)]))

    def vectorize_all(
        self, documents: Iterable[Tuple[str, str]]
    ) -> DataSet:
        return self._dataset(*self._rows(documents))


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw term counts (reference ``BagOfWordsVectorizer.java``)."""

    def _weights(self, counts: np.ndarray) -> np.ndarray:
        return counts


class TfidfVectorizer(BaseTextVectorizer):
    """tf-idf weights (reference ``TfidfVectorizer.java``: tf = raw
    count in document, idf = log(nDocs / docFreq), matching the
    reference's MathUtils.tfidf/idf conventions with the standard
    guard against zero document frequency)."""

    def _weights(self, counts: np.ndarray) -> np.ndarray:
        idf = np.log(
            self.n_docs / np.maximum(self.doc_freq, 1)
        ).astype(np.float32)
        return counts * idf

    def tfidf_word(self, word: str, text: str) -> float:
        """Single-word score for one document (reference
        ``tfidfWord``)."""
        counts = self._counts(text)
        i = self.cache.index_of(word)
        if i < 0:
            return 0.0
        idf = math.log(self.n_docs / max(float(self.doc_freq[i]), 1.0))
        return float(counts[i] * idf)

"""Inverted index over tokenized documents (reference
``text/invertedindex/InvertedIndex.java`` SPI — the in-memory Lucene
stand-in the reference uses for document sampling and batch iteration).

Host-side structure (posting lists are irregular; nothing here touches
the device). Supports the SPI surface: add docs, fetch documents for a
word, document numbers, batch iteration and a seeded sample generator.

Counterpart of ``deeplearning4j_tpu/nlp/inverted_index.py``: the same
host code.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class InvertedIndex:
    """Word -> posting list of document ids (reference
    ``InvertedIndex.java``)."""

    def __init__(self, cache: Optional[VocabCache] = None,
                 batch_size: int = 1024):
        self.cache = cache
        self.batch_size = batch_size
        self._docs: List[List[str]] = []
        self._labels: List[Optional[str]] = []
        self._postings: Dict[str, List[int]] = {}

    # -- building --------------------------------------------------------

    def add_word_to_doc(self, doc: int, word: str) -> None:
        while doc >= len(self._docs):
            self._docs.append([])
            self._labels.append(None)
        self._docs[doc].append(word)
        self._postings.setdefault(word, []).append(doc)

    def add_doc(self, words: Sequence[str],
                label: Optional[str] = None) -> int:
        """Append a document; returns its doc number."""
        doc = len(self._docs)
        self._docs.append(list(words))
        self._labels.append(label)
        for w in set(words):
            self._postings.setdefault(w, []).append(doc)
        return doc

    def finish(self) -> None:
        """Posting lists sorted/deduped (reference finish())."""
        for w, lst in self._postings.items():
            self._postings[w] = sorted(set(lst))

    # -- queries ---------------------------------------------------------

    def num_documents(self) -> int:
        return len(self._docs)

    def document(self, doc: int) -> List[str]:
        return list(self._docs[doc])

    def document_label(self, doc: int) -> Optional[str]:
        return self._labels[doc]

    def documents(self, word: str) -> List[int]:
        return list(self._postings.get(word, ()))

    def doc_frequency(self, word: str) -> int:
        return len(set(self._postings.get(word, ())))

    def all_docs(self) -> Iterator[List[str]]:
        return iter(self._docs)

    def batch_iter(self) -> Iterator[List[List[str]]]:
        """Documents in batches of ``batch_size`` (reference
        ``batchIter``)."""
        for i in range(0, len(self._docs), self.batch_size):
            yield self._docs[i:i + self.batch_size]

    def sample(self, n: int, seed: int = 12345) -> List[List[str]]:
        """Seeded document sample (reference's random doc fetch)."""
        rng = np.random.RandomState(seed)
        if not self._docs:
            return []
        idx = rng.randint(0, len(self._docs), size=n)
        return [self._docs[i] for i in idx]

    def eachdoc_with_label(
        self,
    ) -> Iterable[tuple]:
        return zip(self._docs, self._labels)

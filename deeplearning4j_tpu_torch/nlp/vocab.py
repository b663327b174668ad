"""Vocabulary construction + Huffman coding + negative-sampling table
(reference: ``models/word2vec/wordstore/VocabConstructor.java``,
``models/word2vec/Huffman.java:34``, unigram table construction in
``InMemoryLookupTable.java``).

Counterpart of ``deeplearning4j_tpu/nlp/vocab.py``, copied as it is
(numpy, so indices, counts, codes and tables are the JAX package's bit
for bit). Host-side; produces the fixed-shape integer arrays (huffman
codes/points padded to max code length, unigram sampling table) that
the training steps consume.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np


class VocabWord:
    """A vocab entry (reference ``VocabWord``): word, frequency,
    huffman code/points filled by ``Huffman.build``."""

    __slots__ = ("word", "count", "index", "code", "points")

    def __init__(self, word: str, count: int = 1, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.code: List[int] = []
        self.points: List[int] = []

    def __repr__(self):
        return f"VocabWord({self.word!r}, n={self.count}, i={self.index})"


class VocabCache:
    """In-memory vocab (reference ``AbstractCache`` /
    ``InMemoryLookupCache``)."""

    def __init__(self):
        self.words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}
        self.total_word_count = 0

    def add(self, vw: VocabWord) -> None:
        vw.index = len(self.words)
        self.words.append(vw)
        self._by_word[vw.word] = vw

    def __contains__(self, word: str) -> bool:
        return word in self._by_word

    def __len__(self) -> int:
        return len(self.words)

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._by_word.get(word)

    def index_of(self, word: str) -> int:
        vw = self._by_word.get(word)
        return -1 if vw is None else vw.index

    def word_at(self, index: int) -> str:
        return self.words[index].word

    def id_stream(self, tokens: Iterable[str]) -> List[int]:
        """Token strings -> known-word indices (unknowns dropped, as
        the reference does)."""
        out = []
        for t in tokens:
            vw = self._by_word.get(t)
            if vw is not None:
                out.append(vw.index)
        return out


class VocabConstructor:
    """Count words over a corpus, filter by min frequency, assign
    indices by descending count (reference ``VocabConstructor`` —
    parallel count collapsed to a single pass; Counter is plenty at
    host side)."""

    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory=None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory

    def build_vocab(self, sentences: Iterable[str]) -> VocabCache:
        def tokens_of(sentence):
            if self.tokenizer_factory is not None:
                return self.tokenizer_factory.create(sentence).get_tokens()
            return sentence.split()

        return self.build_vocab_from_tokens(
            tokens_of(s) for s in sentences
        )

    def build_vocab_from_tokens(
        self, token_lists: Iterable[List[str]]
    ) -> VocabCache:
        """Build from pre-tokenized sentences — preserves tokens that
        contain spaces (n-grams)."""
        counts: Counter = Counter()
        for tokens in token_lists:
            counts.update(tokens)
        cache = VocabCache()
        # descending count, then lexical for determinism
        for word, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if n < self.min_word_frequency:
                continue
            cache.add(VocabWord(word, n))
        cache.total_word_count = sum(w.count for w in cache.words)
        return cache


class Huffman:
    """Huffman tree over vocab counts; fills each VocabWord's
    ``code`` (0/1 path) and ``points`` (inner-node indices root→leaf)
    (reference ``Huffman.java:34`` — same two-pass heap construction,
    vectorized here with numpy for the count arrays).
    """

    MAX_CODE_LENGTH = 40

    def __init__(self, words: List[VocabWord]):
        self.words = words

    def build(self) -> None:
        n = len(self.words)
        if n == 0:
            return
        if n == 1:
            self.words[0].code = [0]
            self.words[0].points = [0]
            return
        # heap of (count, tiebreak, node_id); nodes 0..n-1 are leaves,
        # n..2n-2 inner
        heap = [(w.count, i, i) for i, w in enumerate(self.words)]
        heapq.heapify(heap)
        parent = np.zeros(2 * n - 1, np.int64)
        binary = np.zeros(2 * n - 1, np.int8)
        next_id = n
        tiebreak = n
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1] = next_id
            parent[n2] = next_id
            binary[n2] = 1
            heapq.heappush(heap, (c1 + c2, tiebreak, next_id))
            next_id += 1
            tiebreak += 1
        root = 2 * n - 2
        for i, w in enumerate(self.words):
            code: List[int] = []
            points: List[int] = []
            node = i
            while node != root:
                code.append(int(binary[node]))
                points.append(int(parent[node]) - n)
                node = int(parent[node])
            code.reverse()
            points.reverse()
            if len(code) > self.MAX_CODE_LENGTH:
                raise ValueError(
                    f"Huffman code length {len(code)} exceeds "
                    f"{self.MAX_CODE_LENGTH}"
                )
            w.code = code
            w.points = points

    def padded_arrays(self):
        """(codes[V, L], points[V, L], lengths[V]) padded fixed-shape
        arrays for the HS step."""
        L = max((len(w.code) for w in self.words), default=1)
        V = len(self.words)
        codes = np.zeros((V, L), np.float32)
        points = np.zeros((V, L), np.int32)
        lengths = np.zeros(V, np.int32)
        for i, w in enumerate(self.words):
            l = len(w.code)
            codes[i, :l] = w.code
            points[i, :l] = w.points
            lengths[i] = l
        return codes, points, lengths


def build_unigram_table(cache: VocabCache, table_size: int = 100_000,
                        power: float = 0.75,
                        limit: Optional[int] = None) -> np.ndarray:
    """Negative-sampling table: word index repeated proportionally to
    count^0.75 (reference ``InMemoryLookupTable.makeTable``).
    ``limit``: only the first N vocab rows participate (used by
    ParagraphVectors to keep label rows out of negative sampling)."""
    words = cache.words if limit is None else cache.words[:limit]
    counts = np.array([w.count for w in words], np.float64)
    probs = counts ** power
    probs /= probs.sum()
    # cumulative assignment, one vectorized pass
    boundaries = np.floor(np.cumsum(probs) * table_size).astype(np.int64)
    table = np.zeros(table_size, np.int32)
    start = 0
    for idx, end in enumerate(boundaries):
        if end > start:
            table[start:end] = idx
            start = end
    if start < table_size:
        table[start:] = len(words) - 1
    return table


def subsample_mask(ids: np.ndarray, counts: np.ndarray, total: int,
                   sample: float, rng: np.random.RandomState) -> np.ndarray:
    """Frequent-word subsampling keep-mask (reference SkipGram's
    ``sample`` branch: P(keep) = (sqrt(f/sample)+1)*sample/f)."""
    if sample <= 0:
        return np.ones(len(ids), bool)
    freq = counts[ids] / max(total, 1)
    keep_prob = (np.sqrt(freq / sample) + 1) * (sample / np.maximum(freq, 1e-12))
    return rng.rand(len(ids)) < np.minimum(keep_prob, 1.0)

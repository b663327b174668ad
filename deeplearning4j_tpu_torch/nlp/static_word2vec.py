"""Read-only memory-mapped word vectors (reference
``models/word2vec/StaticWord2Vec.java`` — serve vectors from a closed
model without loading/duplicating the full matrix per consumer).

Backing store: an .npz/.npy matrix memory-mapped via numpy, plus the
vocab loaded from the sibling vocab file; or any (cache, matrix) pair
saved by :mod:`deeplearning4j_tpu_torch.nlp.serializer`. Lookups never
mutate; an LRU keeps hot rows (the reference keeps a per-device cache).

Counterpart of ``deeplearning4j_tpu/nlp/static_word2vec.py``: the same
files (numpy and text), so a directory written by either package is
read by the other.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord


def save_static(model_or_pair, directory: str) -> None:
    """Write <dir>/vectors.npy (float32 [V, D]) + <dir>/vocab.txt
    (word<TAB>count per line, index order)."""
    from deeplearning4j_tpu_torch.nlp.serializer import _resolve

    cache, m = _resolve(model_or_pair)
    os.makedirs(directory, exist_ok=True)
    np.save(os.path.join(directory, "vectors.npy"),
            np.asarray(m, np.float32))
    with open(os.path.join(directory, "vocab.txt"), "w",
              encoding="utf-8") as f:
        for i in range(len(cache)):
            w = cache.word_for(cache.word_at(i))
            f.write(f"{w.word}\t{w.count}\n")


class StaticWord2Vec:
    """Read-only vector store over an mmapped matrix (reference
    ``StaticWord2Vec.java``)."""

    def __init__(self, directory: str, cache_size: int = 1024):
        vec_path = os.path.join(directory, "vectors.npy")
        vocab_path = os.path.join(directory, "vocab.txt")
        if not (os.path.exists(vec_path) and os.path.exists(vocab_path)):
            raise FileNotFoundError(
                f"expected vectors.npy + vocab.txt under {directory!r}"
            )
        # mmap: rows page in on demand, shared across processes
        self.syn0 = np.load(vec_path, mmap_mode="r")
        self.cache = VocabCache()
        with open(vocab_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                word, _, count = line.rstrip("\n").partition("\t")
                self.cache.add(VocabWord(word, int(count or 1)))
        if len(self.cache) != self.syn0.shape[0]:
            raise ValueError(
                f"vocab size {len(self.cache)} != matrix rows "
                f"{self.syn0.shape[0]}"
            )
        self.layer_size = int(self.syn0.shape[1])
        self._lru: OrderedDict = OrderedDict()
        self._lru_size = cache_size

    # -- reference WordVectors surface -----------------------------------

    def has_word(self, word: str) -> bool:
        return self.cache.index_of(word) >= 0

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.cache.index_of(word)
        if i < 0:
            return None
        if i in self._lru:
            self._lru.move_to_end(i)
            return self._lru[i]
        v = np.array(self.syn0[i])  # copy out of the mmap
        # read-only: callers mutating the returned row in place must
        # not corrupt the cache shared by later lookups
        v.flags.writeable = False
        self._lru[i] = v
        if len(self._lru) > self._lru_size:
            self._lru.popitem(last=False)
        return v

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        na = np.linalg.norm(va)
        nb = np.linalg.norm(vb)
        if na == 0 or nb == 0:
            return 0.0
        return float(va @ vb / (na * nb))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.get_word_vector(word)
        if v is None:
            return []
        m = np.asarray(self.syn0)
        norms = np.linalg.norm(m, axis=1)
        sims = (m @ v) / np.maximum(norms * np.linalg.norm(v), 1e-12)
        sims[self.cache.index_of(word)] = -np.inf
        return [
            self.cache.word_at(int(i)) for i in np.argsort(-sims)[:n]
        ]

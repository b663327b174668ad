"""Text pipeline: sentence iterators + tokenizers (reference:
``text/sentenceiterator/*.java``, ``text/tokenization/**`` —
``DefaultTokenizerFactory`` splits on whitespace after an optional
token preprocessor; preprocessors live in
``tokenization/tokenizer/preprocessor/``).

Counterpart of ``deeplearning4j_tpu/nlp/tokenization.py``, copied as
it is: pure host-side Python. The training math consumes only the
integer id streams this module produces.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional

# ---------------------------------------------------------------------------
# Token preprocessors (reference CommonPreprocessor / EndingPreProcessor)
# ---------------------------------------------------------------------------

_PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")


def common_preprocessor(token: str) -> str:
    """Reference ``CommonPreprocessor``: strip punctuation+digits,
    lowercase."""
    return _PUNCT.sub("", token).lower()


class Tokenizer:
    """One document's token stream (reference ``Tokenizer`` SPI)."""

    def __init__(self, tokens: List[str],
                 preprocessor: Optional[Callable[[str], str]] = None):
        self._tokens = tokens
        self._pre = preprocessor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return list(self._tokens)
        out = []
        for t in self._tokens:
            t = self._pre(t)
            if t:
                out.append(t)
        return out

    def count_tokens(self) -> int:
        return len(self.get_tokens())

    def __iter__(self):
        return iter(self.get_tokens())


class DefaultTokenizerFactory:
    """Whitespace tokenizer (reference
    ``DefaultTokenizerFactory.java``)."""

    def __init__(self):
        self._pre: Optional[Callable[[str], str]] = None

    def set_token_pre_processor(self, pre: Callable[[str], str]) -> None:
        self._pre = pre

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(DefaultTokenizerFactory):
    """N-gram over the base tokens (reference
    ``NGramTokenizerFactory.java``)."""

    def __init__(self, min_n: int = 1, max_n: int = 2):
        super().__init__()
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        base = Tokenizer(text.split(), self._pre).get_tokens()
        grams: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base) - n + 1):
                grams.append(" ".join(base[i:i + n]))
        return Tokenizer(grams, None)


# ---------------------------------------------------------------------------
# TokenizerFactory registry — the SPI seam the reference fills with
# per-language modules (deeplearning4j-nlp-japanese's Kuromoji
# JapaneseTokenizer, -korean's KoreanTokenizer, -uima's UimaTokenizer).
# Those vendor third-party analyzers (6.9k LoC of Kuromoji); here the
# seam is an explicit registry: plug any object with
# ``create(text) -> Tokenizer`` and select it by name wherever a
# tokenizer_factory is accepted.
# ---------------------------------------------------------------------------

_TOKENIZER_REGISTRY: dict = {}


def register_tokenizer_factory(name: str, factory_cls) -> None:
    """Register a TokenizerFactory class under a language/name key
    (e.g. 'japanese' -> a Kuromoji-backed implementation)."""
    if not callable(factory_cls):
        raise TypeError("factory_cls must be callable (class or factory)")
    _TOKENIZER_REGISTRY[name.lower()] = factory_cls


def tokenizer_factory(name: str = "default", **kwargs):
    """Instantiate a registered TokenizerFactory by name."""
    key = name.lower()
    if key not in _TOKENIZER_REGISTRY:
        raise KeyError(
            f"no TokenizerFactory registered under {name!r}; known: "
            f"{sorted(_TOKENIZER_REGISTRY)}"
        )
    return _TOKENIZER_REGISTRY[key](**kwargs)


class RegexTokenizerFactory(DefaultTokenizerFactory):
    """Split on a regex (covers the reference's PosUimaTokenizer-style
    customization without UIMA)."""

    def __init__(self, pattern: str = r"\s+"):
        super().__init__()
        self._re = re.compile(pattern)

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(
            [t for t in self._re.split(text) if t], self._pre
        )


class CharTokenizerFactory(DefaultTokenizerFactory):
    """Character-level tokens — a working default for unsegmented CJK
    text until a morphological analyzer is registered (the honest
    stand-in for the vendored Kuromoji)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer([c for c in text if not c.isspace()], self._pre)


register_tokenizer_factory("default", DefaultTokenizerFactory)
register_tokenizer_factory("ngram", NGramTokenizerFactory)
register_tokenizer_factory("regex", RegexTokenizerFactory)
register_tokenizer_factory("char", CharTokenizerFactory)
# The CJK entries ("japanese", "japanese_script", "korean") are
# registered by nlp/cjk.py and nlp/japanese.py (the package imports
# both); register_tokenizer_factory adds any factory.


# ---------------------------------------------------------------------------
# Sentence iterators (reference text/sentenceiterator)
# ---------------------------------------------------------------------------


class SentenceIterator:
    """Resettable stream of sentences (reference ``SentenceIterator``).
    Subclasses implement ``_sentences()``."""

    def __init__(self):
        self.preprocessor: Optional[Callable[[str], str]] = None

    def _sentences(self) -> Iterator[str]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        for s in self._sentences():
            if self.preprocessor is not None:
                s = self.preprocessor(s)
            yield s

    def reset(self) -> None:
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        super().__init__()
        self._data = list(sentences)

    def _sentences(self):
        return iter(self._data)


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file (reference
    ``LineSentenceIterator``)."""

    def __init__(self, path):
        super().__init__()
        self._path = Path(path)

    def _sentences(self):
        with open(self._path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """All lines of all files under a directory (reference
    ``FileSentenceIterator``)."""

    def __init__(self, root):
        super().__init__()
        self._root = Path(root)

    def _sentences(self):
        paths = (
            sorted(self._root.rglob("*")) if self._root.is_dir()
            else [self._root]
        )
        for p in paths:
            if not p.is_file():
                continue
            with open(p, "r", encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        yield line


class LabelledDocument:
    """A document with labels (reference ``LabelledDocument`` /
    ``LabelAwareSentenceIterator`` family)."""

    def __init__(self, content: str, labels: Optional[List[str]] = None):
        self.content = content
        self.labels = labels or []


class LabelAwareIterator:
    """Stream of LabelledDocuments for ParagraphVectors (reference
    ``LabelAwareIterator``)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)

    def __iter__(self):
        return iter(self._docs)

    def reset(self):
        pass

    @staticmethod
    def from_texts(texts: Iterable[str], labels: Iterable[str]
                   ) -> "LabelAwareIterator":
        return LabelAwareIterator([
            LabelledDocument(t, [l]) for t, l in zip(texts, labels)
        ])

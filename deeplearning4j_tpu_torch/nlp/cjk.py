"""Counterpart of ``deeplearning4j_tpu/nlp/cjk.py`` (host code, the
same outputs on the same texts), whose docstring follows.

CJK tokenizers (reference: `deeplearning4j-nlp-japanese`'s vendored
Kuromoji wrapper `JapaneseTokenizer`, `deeplearning4j-nlp-korean`'s
twitter-korean-text wrapper `KoreanTokenizer.java:35`).

Dependency-free analogs built on Unicode character classes instead of
vendored third-party analyzers:

- Japanese has no inter-word whitespace; Kuromoji segments with a
  morpheme lattice. The analog here segments on script-class
  boundaries (kanji / hiragana / katakana / latin / digits), which is
  the standard zero-dependency fallback. Documented divergence: runs
  of same-script characters are NOT split into individual morphemes.
- Korean IS whitespace-delimited (eojeol); twitter-korean-text
  additionally strips/splits particles. The analog splits on
  whitespace + punctuation and keeps hangul runs intact.

Both register in the TokenizerFactory registry
(`register_tokenizer_factory`), which is the reference's SPI seam
(`text/tokenization/tokenizerfactory/`)."""

from __future__ import annotations

import unicodedata
from typing import List

from deeplearning4j_tpu_torch.nlp.tokenization import (
    Tokenizer,
    register_tokenizer_factory,
)


def _script_class(ch: str) -> str:
    """Coarse script class used for segmentation boundaries."""
    cp = ord(ch)
    if 0x3040 <= cp <= 0x309F:
        return "hiragana"
    if 0x30A0 <= cp <= 0x30FF or 0x31F0 <= cp <= 0x31FF:
        return "katakana"
    if (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF
    ):
        return "kanji"
    if (
        0xAC00 <= cp <= 0xD7AF       # syllables
        or 0x1100 <= cp <= 0x11FF    # jamo
        or 0x3130 <= cp <= 0x318F    # compatibility jamo (e.g. ㅋㅋ)
        or 0xA960 <= cp <= 0xA97F    # jamo extended-A
    ):
        return "hangul"
    if ch.isspace():
        return "space"
    if ch.isdigit():
        return "digit"
    cat = unicodedata.category(ch)
    if cat.startswith("P") or cat.startswith("S"):
        return "punct"
    return "other"  # latin & everything else alphabetic


def segment_by_script(text: str, *, keep_punct: bool = False) -> List[str]:
    """Split ``text`` into runs of identical script class. Whitespace
    always separates; punctuation is dropped unless ``keep_punct``."""
    tokens: List[str] = []
    run: List[str] = []
    run_class = None
    for ch in text:
        c = _script_class(ch)
        if c != run_class:
            if run:
                tokens.append("".join(run))
            run = []
            run_class = c
        if c == "space":
            run = []
            run_class = None
            continue
        if c == "punct" and not keep_punct:
            run = []
            run_class = None
            continue
        run.append(ch)
    if run:
        tokens.append("".join(run))
    return tokens


class JapaneseTokenizerFactory:
    """Script-class segmentation for Japanese text (Kuromoji-wrapper
    analog, `deeplearning4j-nlp-japanese`). ``preprocessor`` follows
    the reference's TokenPreProcess seam."""

    def __init__(self, preprocessor=None, keep_punct: bool = False):
        self.preprocessor = preprocessor
        self.keep_punct = keep_punct

    def create(self, text: str) -> Tokenizer:
        # Tokenizer's preprocessor seam also drops emptied tokens
        # (e.g. a digit-only token a CommonPreprocessor maps to "")
        return Tokenizer(
            segment_by_script(text, keep_punct=self.keep_punct),
            self.preprocessor,
        )


class KoreanTokenizerFactory(JapaneseTokenizerFactory):
    """Eojeol (whitespace) tokenization with punctuation stripped
    (twitter-korean-text wrapper analog, ``KoreanTokenizer.java:35``).
    Korean is whitespace-delimited, which script-class segmentation
    already honors; mixed-script eojeols split on script boundaries so
    hangul runs separate from embedded latin/digits."""

    def __init__(self, preprocessor=None):
        super().__init__(preprocessor, keep_punct=False)


register_tokenizer_factory("japanese", JapaneseTokenizerFactory)
# explicit name for the script-run fallback; nlp.japanese re-registers
# "japanese" with the dictionary/Viterbi segmenter on package import
register_tokenizer_factory("japanese_script", JapaneseTokenizerFactory)
register_tokenizer_factory("korean", KoreanTokenizerFactory)

"""Counterpart of ``deeplearning4j_tpu/nlp/japanese.py`` (host code, the
same outputs on the same texts), whose docstring follows.

Lattice-based Japanese morphological analysis (reference:
``deeplearning4j-nlp-japanese`` vendors the Kuromoji analyzer —
``com/atilika/kuromoji/TokenizerBase.java:1``; the search is a
dictionary lattice + Viterbi minimum-cost path where
``path_cost = prev_path_cost + connection_cost(prev.rightId,
node.leftId) + word_cost`` — ``viterbi/ViterbiSearcher.java:101`` —
and tokens expose part-of-speech / base-form attributes,
``TokenBase.java``).

Same scheme here, dependency-free and at mini scale:

- a checked-in lexicon where each surface maps to one or more
  ``(word_cost, pos_class, pos, detail, base_form)`` entries
  (ambiguous surfaces like も/か carry their class so the transition
  matrix can disambiguate in context);
- unknown spans covered by script-class runs (Kuromoji's unknown-word
  handler groups the same way), classed by script (katakana run ->
  noun-loanword, digits -> number, kanji -> unknown-noun);
- a **bigram connection-cost matrix over POS classes** — the compact
  analog of Kuromoji's learned (rightId, leftId) matrix. This is what
  resolves the classic ambiguities a unigram lattice gets wrong:
  particle-particle transitions are penalized, noun->particle and
  verb-stem->auxiliary are rewarded, so すもももももももものうち
  segments to the canonical すもも/も/もも/も/もも/の/うち;
- Viterbi over lattice *nodes* (cost depends on the previous node's
  class, so position-only DP is not enough).

The deliberate divergence from the reference is scale, not shape: the
lexicon is a few hundred entries and the matrix is ~15x15 hand-set
classes instead of IPADIC's learned 1316x1316 — a real deployment
loads a full dictionary through the same entry format.

Registered as ``tokenizer_factory("japanese")``; the zero-dependency
script-run segmenter stays available as ``"japanese_script"``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.cjk import _script_class, segment_by_script
from deeplearning4j_tpu_torch.nlp.tokenization import (
    Tokenizer,
    register_tokenizer_factory,
)

# ---------------------------------------------------------------------------
# POS classes (connection ids). Kuromoji: left/right context ids from
# IPADIC; here one compact class per broad POS, used on both sides.
# ---------------------------------------------------------------------------

BOS = 0    # virtual begin-of-sentence
EOS = 1    # virtual end-of-sentence
N = 2      # noun
PRON = 3   # pronoun / demonstrative
PRT = 4    # case/binding particle (は が を に で と の へ から まで も)
PRT_F = 5  # sentence-final particle (ね よ か)
V = 6      # verb, terminal/past/te form (行く 行った して)
VSTEM = 7  # verb continuative stem (行き 食べ) — wants an auxiliary
AUX = 8    # auxiliary / copula / polite endings (です ます ない)
ADJ = 9    # i-adjective
NUM = 10   # number run
SYM = 11   # symbol / punctuation
UNK = 12   # unknown span (non-katakana)
ADV = 13   # adverb (とても もう ゆっくり) — r5, scaled lexicon

_CLASS_NAMES = {
    BOS: "BOS", EOS: "EOS", N: "noun", PRON: "pronoun",
    PRT: "particle", PRT_F: "particle", V: "verb", VSTEM: "verb",
    AUX: "auxiliary", ADJ: "adjective", NUM: "number", SYM: "symbol",
    UNK: "unknown", ADV: "adverb",
}

# loader names -> class ids (the TSV lexicon and user dictionaries
# name classes; VSTEM/PRT_F disambiguate via the detail column)
_NAME_TO_CLASS = {
    "noun": N, "pronoun": PRON, "particle": PRT,
    "final-particle": PRT_F, "verb": V, "verb-stem": VSTEM,
    "auxiliary": AUX, "adjective": ADJ, "adverb": ADV,
    "number": NUM, "symbol": SYM,
}

# Bigram connection costs (left_class, right_class) -> cost, the
# compact analog of Kuromoji's ConnectionCosts matrix
# (``viterbi/ViterbiSearcher.java:101`` adds costs.get(rightId,
# leftId) on every edge). Unlisted pairs cost _CONN_DEFAULT. Negative
# = rewarded transition. Hand-set to encode the grammar facts IPADIC
# learned from corpora: particles follow nominals, auxiliaries follow
# verb stems, particle chains and particle-initial sentences are
# implausible.
_CONN_DEFAULT = 200
_CONN: Dict[Tuple[int, int], int] = {
    (BOS, N): 0, (BOS, PRON): 0, (BOS, NUM): 0, (BOS, V): 50,
    (BOS, VSTEM): 50, (BOS, ADJ): 50, (BOS, UNK): 100, (BOS, SYM): 100,
    (BOS, PRT): 800, (BOS, PRT_F): 800, (BOS, AUX): 800,

    (N, PRT): -150, (N, PRT_F): 0, (N, AUX): -100, (N, EOS): 0,
    (N, N): 150, (N, V): 50, (N, VSTEM): 50,
    (PRON, PRT): -150, (PRON, AUX): -50, (PRON, EOS): 50,

    (PRT, N): -50, (PRT, PRON): 0, (PRT, V): -50, (PRT, VSTEM): -50,
    (PRT, ADJ): -50, (PRT, NUM): 0, (PRT, UNK): 0,
    (PRT, PRT): 700, (PRT, PRT_F): 500, (PRT, AUX): 400,
    (PRT, EOS): 500,
    (PRT_F, EOS): -100, (PRT_F, PRT_F): 100,

    (V, EOS): -100, (V, PRT): 150, (V, PRT_F): -50, (V, N): 100,
    (V, AUX): 100,
    (VSTEM, AUX): -300, (VSTEM, EOS): 800, (VSTEM, PRT): 300,
    (VSTEM, V): 400, (VSTEM, N): 400,

    (AUX, EOS): -150, (AUX, PRT_F): -50, (AUX, AUX): 0,
    (AUX, PRT): 300, (AUX, N): 300,

    (ADJ, N): -50, (ADJ, EOS): -50, (ADJ, AUX): 0, (ADJ, PRT): 100,
    (NUM, N): -100, (NUM, PRT): -50, (NUM, EOS): 0,
    (UNK, PRT): -50, (UNK, AUX): 0, (UNK, EOS): 100,

    # adverbs: sentence-initial or mid-clause, preceding predicates
    (BOS, ADV): 20, (ADV, V): -100, (ADV, VSTEM): -100,
    (ADV, ADJ): -100, (ADV, ADV): 150, (ADV, N): 150,
    (ADV, EOS): 300, (PRT, ADV): 0, (ADV, PRT): 250,
}


def connection_cost(left_class: int, right_class: int) -> int:
    return _CONN.get((left_class, right_class), _CONN_DEFAULT)


# ---------------------------------------------------------------------------
# Lexicon: surface -> [(word_cost, class, pos, detail, base_form)].
# Ambiguous surfaces carry multiple entries; the connection matrix
# picks in context. A real deployment swaps this for a full
# IPADIC-style lexicon through the same format.
# ---------------------------------------------------------------------------

Entry = Tuple[int, int, str, str, Optional[str]]


def _e(cost: int, cls: int, detail: str = "",
       base: Optional[str] = None) -> Entry:
    return (cost, cls, _CLASS_NAMES[cls], detail, base)


LEXICON: Dict[str, List[Entry]] = {
    # case/binding particles
    "は": [_e(100, PRT, "binding")], "が": [_e(100, PRT, "case")],
    "を": [_e(100, PRT, "case")], "に": [_e(100, PRT, "case")],
    "で": [_e(110, PRT, "case")], "と": [_e(110, PRT, "case")],
    "も": [_e(100, PRT, "binding")], "の": [_e(100, PRT, "genitive")],
    "へ": [_e(120, PRT, "case")], "や": [_e(130, PRT, "parallel")],
    "から": [_e(120, PRT, "case")], "まで": [_e(120, PRT, "case")],
    "より": [_e(130, PRT, "case")],
    # sentence-final particles (か doubles as question marker)
    "ね": [_e(140, PRT_F, "final")], "よ": [_e(140, PRT_F, "final")],
    "か": [_e(130, PRT_F, "final"), _e(160, PRT, "parallel")],
    # copula / auxiliaries / polite endings
    "です": [_e(150, AUX, "copula", "です")],
    "でした": [_e(160, AUX, "copula-past", "です")],
    "ます": [_e(150, AUX, "polite", "ます")],
    "ました": [_e(160, AUX, "polite-past", "ます")],
    "ません": [_e(160, AUX, "polite-negative", "ます")],
    "だ": [_e(160, AUX, "copula", "だ")],
    "である": [_e(170, AUX, "copula", "だ")],
    "ない": [_e(170, AUX, "negative", "ない")],
    "たい": [_e(180, AUX, "desiderative", "たい")],
    "れる": [_e(180, AUX, "passive", "れる")],
    "られる": [_e(190, AUX, "passive", "られる")],
    "ください": [_e(180, AUX, "request", "くださる")],
    # verbs — terminal/past/te forms
    "する": [_e(170, V, "suru", "する")],
    "します": [_e(160, V, "suru-polite", "する")],
    "しました": [_e(170, V, "suru-polite-past", "する")],
    "した": [_e(170, V, "suru-past", "する")],
    "して": [_e(170, V, "suru-te", "する")],
    "います": [_e(170, V, "subsidiary", "いる")],
    "いる": [_e(170, V, "subsidiary", "いる")],
    "ある": [_e(170, V, "existence", "ある")],
    "なる": [_e(180, V, "", "なる")],
    "行く": [_e(260, V, "", "行く")], "行った": [_e(270, V, "past", "行く")],
    "来る": [_e(260, V, "", "来る")], "来た": [_e(270, V, "past", "来る")],
    "くる": [_e(260, V, "", "くる")],
    "見る": [_e(260, V, "", "見る")], "見た": [_e(270, V, "past", "見る")],
    "食べる": [_e(270, V, "", "食べる")],
    "読む": [_e(270, V, "", "読む")], "書く": [_e(270, V, "", "書く")],
    "話す": [_e(270, V, "", "話す")], "思う": [_e(270, V, "", "思う")],
    "使う": [_e(270, V, "", "使う")], "待つ": [_e(270, V, "", "待つ")],
    "まつ": [_e(280, V, "", "まつ")],
    # verb continuative stems (expect auxiliaries)
    "行き": [_e(260, VSTEM, "stem", "行く")],
    "食べ": [_e(270, VSTEM, "stem", "食べる")],
    "読み": [_e(270, VSTEM, "stem", "読む")],
    "書き": [_e(270, VSTEM, "stem", "書く")],
    "思い": [_e(270, VSTEM, "stem", "思う")],
    "使い": [_e(270, VSTEM, "stem", "使う")],
    # pronouns / demonstratives
    "私": [_e(200, PRON)], "僕": [_e(210, PRON)], "彼": [_e(210, PRON)],
    "彼女": [_e(220, PRON)], "これ": [_e(200, PRON)],
    "それ": [_e(200, PRON)], "あれ": [_e(210, PRON)],
    "ここ": [_e(210, PRON)], "そこ": [_e(210, PRON)],
    "どこ": [_e(210, PRON)],
    # i-adjectives
    "良い": [_e(270, ADJ, "", "良い")], "いい": [_e(260, ADJ, "", "いい")],
    "大きい": [_e(280, ADJ, "", "大きい")],
    "小さい": [_e(280, ADJ, "", "小さい")],
    "新しい": [_e(280, ADJ, "", "新しい")],
    "高い": [_e(280, ADJ, "", "高い")], "速い": [_e(280, ADJ, "", "速い")],
    # common nouns
    "こと": [_e(200, N)], "もの": [_e(260, N)], "とき": [_e(210, N)],
    "ところ": [_e(220, N)], "人": [_e(220, N)], "日": [_e(230, N)],
    "年": [_e(230, N)], "月": [_e(230, N)], "時間": [_e(240, N)],
    "今日": [_e(230, N)], "明日": [_e(240, N)], "昨日": [_e(240, N)],
    "学生": [_e(250, N)], "先生": [_e(250, N)], "学校": [_e(250, N)],
    "大学": [_e(250, N)], "東京": [_e(250, N, "proper")],
    "日本": [_e(240, N, "proper")], "日本語": [_e(250, N, "proper")],
    "言語": [_e(260, N)], "単語": [_e(260, N)], "文章": [_e(260, N)],
    "意味": [_e(260, N)], "世界": [_e(260, N)], "会社": [_e(260, N)],
    "仕事": [_e(260, N)], "勉強": [_e(260, N, "verbal")],
    "電車": [_e(270, N)], "車": [_e(260, N)], "くるま": [_e(280, N)],
    "家": [_e(250, N)], "水": [_e(260, N)], "本": [_e(250, N)],
    "犬": [_e(260, N)], "猫": [_e(260, N)], "うち": [_e(230, N)],
    "すもも": [_e(300, N)], "もも": [_e(280, N)], "桃": [_e(270, N)],
    "李": [_e(290, N)],
}


class JapaneseDictionary:
    """Compiled lexicon with a per-first-character prefix index — the
    compact analog of the trie Kuromoji compiles IPADIC into
    (``com/atilika/kuromoji/trie/PatriciaTrie.java:1``,
    ``dict/TokenInfoDictionary``): at each lattice position only the
    lengths up to the longest dictionary word starting with that
    character are probed, so lookup cost scales with per-character
    fan-out instead of the global longest surface.

    Sources, merged in order (later entries append, same format):
    the hand-set core ``LEXICON``, the generated TSV shipped in
    ``nlp/data/ja_lexicon.tsv`` (scripts/gen_ja_lexicon.py — base
    vocabulary expanded through godan/ichidan/i-adjective
    conjugation), and user dictionaries via :meth:`add_word` /
    :meth:`load_tsv` (Kuromoji's user-dictionary seam)."""

    def __init__(self, entries: Optional[Dict[str, List[Entry]]] = None):
        self._entries: Dict[str, List[Entry]] = {}
        self._max_by_first: Dict[str, int] = {}
        if entries:
            for surface, es in entries.items():
                for e in es:
                    self._add(surface, e)

    def _add(self, surface: str, entry: Entry) -> None:
        if not surface:
            raise ValueError("empty surface")
        lst = self._entries.setdefault(surface, [])
        if entry not in lst:
            lst.append(entry)
        c = surface[0]
        if len(surface) > self._max_by_first.get(c, 0):
            self._max_by_first[c] = len(surface)

    def add_word(self, surface: str, pos: str = "noun",
                 cost: int = 250, detail: str = "user",
                 base: Optional[str] = None) -> None:
        """User-dictionary seam: register one surface with a named
        POS class (kuromoji UserDictionary analog)."""
        cls = _NAME_TO_CLASS.get(pos)
        if cls is None:
            raise ValueError(
                f"unknown POS class {pos!r}; one of "
                f"{sorted(_NAME_TO_CLASS)}"
            )
        self._add(surface, (cost, cls, _CLASS_NAMES[cls], detail,
                            base))

    def load_tsv(self, path) -> int:
        """Load ``surface<TAB>cost<TAB>class<TAB>detail<TAB>base``
        rows (the generated-lexicon / user-dictionary format);
        returns the number of entries added."""
        n = 0
        with open(path, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t")
                if len(parts) != 5:
                    raise ValueError(
                        f"{path}:{lineno}: expected 5 tab-separated "
                        f"fields, got {len(parts)}"
                    )
                surface, cost, cls_name, detail, base = parts
                cls = _NAME_TO_CLASS.get(cls_name)
                if cls is None:
                    raise ValueError(
                        f"{path}:{lineno}: unknown class {cls_name!r}"
                    )
                self._add(surface, (int(cost), cls,
                                    _CLASS_NAMES[cls], detail,
                                    base or None))
                n += 1
        return n

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, surface: str) -> bool:
        return surface in self._entries

    def max_surface_len(self, first_char: str) -> int:
        return self._max_by_first.get(first_char, 0)

    def lookup(self, surface: str):
        return self._entries.get(surface, ())

    def prefixes(self, text: str, i: int):
        """Yield (surface, entries) for every dictionary surface
        starting at ``text[i]`` — the lattice construction probe."""
        mx = min(self._max_by_first.get(text[i], 0), len(text) - i)
        for ln in range(1, mx + 1):
            w = text[i:i + ln]
            es = self._entries.get(w)
            if es:
                yield w, es


_DEFAULT_DICT: Optional[JapaneseDictionary] = None


def default_dictionary() -> JapaneseDictionary:
    """The process-wide dictionary: core LEXICON + the shipped
    generated lexicon (loaded once, lazily)."""
    global _DEFAULT_DICT
    if _DEFAULT_DICT is None:
        d = JapaneseDictionary(LEXICON)
        import os

        tsv = os.path.join(os.path.dirname(__file__), "data",
                           "ja_lexicon.tsv")
        if os.path.exists(tsv):
            d.load_tsv(tsv)
        _DEFAULT_DICT = d
    return _DEFAULT_DICT


# Unknown-span costs by script class (Kuromoji's unknown-word handler
# assigns per-category costs from unk.def; same idea, coarser).
# Katakana runs are almost always loanword nouns -> cheap; hiragana is
# function-word territory -> long unknown runs are implausible.
_UNK_BASE = 700
_UNK_PER_CHAR = {
    "katakana": 200, "other": 200, "digit": 150,
    "kanji": 350, "hiragana": 500, "hangul": 250,
}
_UNK_PER_CHAR_DEFAULT = 350


class Token(NamedTuple):
    """Analyzed token (reference ``TokenBase.java``: surface, POS
    levels, base form, known/unknown)."""

    surface: str
    part_of_speech: str          # coarse label: noun/particle/verb/...
    pos_detail: str              # sub-class ("case", "stem", ...)
    base_form: str               # dictionary form (= surface if n/a)
    known: bool                  # True if from the lexicon

    @property
    def pos(self) -> str:
        return self.part_of_speech


class _Node(NamedTuple):
    start: int
    end: int
    surface: str
    word_cost: int
    cls: int
    pos: str
    detail: str
    base: Optional[str]
    known: bool


def _script_runs(text: str) -> List[Tuple[int, str]]:
    """Per-position (run_end, script_class), computed once in O(n)
    (Kuromoji's unknown-word grouping). Positions inside a run share
    its end, so lattice construction never rescans."""
    n = len(text)
    out: List[Tuple[int, str]] = [None] * n  # type: ignore[list-item]
    i = 0
    while i < n:
        c = _script_class(text[i])
        j = i + 1
        while j < n and _script_class(text[j]) == c:
            j += 1
        for k in range(i, j):
            out[k] = (j, c)
        i = j
    return out


def _unknown_node(i: int, end: int, script: str) -> _Node:
    """Unknown-span node. ``surface`` stays empty until the node wins
    a place on the Viterbi path (avoids O(n^2) substring copies on
    long single-script runs)."""
    per = _UNK_PER_CHAR.get(script, _UNK_PER_CHAR_DEFAULT)
    cost = _UNK_BASE + per * (end - i)
    if script in ("katakana", "other"):  # loanwords / latin words
        cls, pos, detail = N, "noun", f"unknown-{script}"
    elif script == "digit":
        cls, pos, detail = NUM, "number", "unknown-digit"
    elif script == "punct":
        cls, pos, detail = SYM, "symbol", "punct"
    else:
        cls, pos, detail = UNK, "unknown", f"unknown-{script}"
    return _Node(i, end, "", cost, cls, pos, detail, None, False)


def tokenize(text: str,
             dictionary: Optional[JapaneseDictionary] = None
             ) -> List[Token]:
    """Morphological analysis: Viterbi minimum-cost path over the
    dictionary lattice with bigram connection costs. Whitespace splits
    the lattice; punctuation tokens are dropped (the script-run
    segmenter's convention). ``dictionary`` defaults to the core +
    generated lexicon; pass your own (e.g. with user entries) to
    extend it."""
    d = dictionary if dictionary is not None else default_dictionary()
    out: List[Token] = []
    for chunk in text.split():
        out.extend(_tokenize_chunk(chunk, d))
    return [t for t in out if t.part_of_speech != "symbol"]


def segment(text: str) -> List[str]:
    """Surfaces of :func:`tokenize` (back-compat API)."""
    return [t.surface for t in tokenize(text)]


def _lattice_nodes(text: str,
                   d: JapaneseDictionary) -> List[List[_Node]]:
    """starts[i] = lattice nodes beginning at position i: all
    dictionary matches (probed through the prefix index), plus the
    unknown same-script run AND its single first character (so a
    dictionary word just past i+1 is reachable without consuming the
    whole run)."""
    n = len(text)
    runs = _script_runs(text)
    starts: List[List[_Node]] = [[] for _ in range(n)]
    for i in range(n):
        for w, entries in d.prefixes(text, i):
            for (cost, cls, pos, detail, base) in entries:
                starts[i].append(
                    _Node(i, i + len(w), w, cost, cls, pos, detail,
                          base, True)
                )
        run_end, script = runs[i]
        starts[i].append(_unknown_node(i, run_end, script))
        if run_end - i > 1:
            starts[i].append(_unknown_node(i, i + 1, script))
    return starts


def _tokenize_chunk(text: str, d: JapaneseDictionary) -> List[Token]:
    n = len(text)
    if n == 0:
        return []
    starts = _lattice_nodes(text, d)
    # Viterbi over nodes (cost depends on the previous node's class,
    # so position-only DP is not enough): `arena` is the flat list of
    # settled (node, best_cost, backpointer-index) entries and
    # arena_at[i] indexes the entries whose node ends at i.
    bos = _Node(0, 0, "", 0, BOS, "BOS", "", None, True)
    INF = float("inf")
    arena: List[Tuple[_Node, float, Optional[int]]] = [(bos, 0.0, None)]
    arena_at: List[List[int]] = [[] for _ in range(n + 1)]
    arena_at[0].append(0)
    for i in range(n):
        if not arena_at[i]:
            continue
        for node in starts[i]:
            best_cost, best_back = INF, None
            for ai in arena_at[i]:
                left, lcost, _ = arena[ai]
                c = (lcost + connection_cost(left.cls, node.cls)
                     + node.word_cost)
                if c < best_cost:
                    best_cost, best_back = c, ai
            if best_back is None:
                continue
            arena.append((node, best_cost, best_back))
            arena_at[node.end].append(len(arena) - 1)
    # EOS: pick the end-node with the best cost + connection to EOS
    best_cost, best_ai = INF, None
    for ai in arena_at[n]:
        node, cost, _ = arena[ai]
        c = cost + connection_cost(node.cls, EOS)
        if c < best_cost:
            best_cost, best_ai = c, ai
    if best_ai is None:  # only possible on empty/degenerate input
        return [
            Token(s, "unknown", "", s, False)
            for s in segment_by_script(text)
        ]
    path: List[_Node] = []
    ai: Optional[int] = best_ai
    while ai is not None:
        node, _, back = arena[ai]
        if node.cls != BOS:
            path.append(node)
        ai = back
    path.reverse()
    out = []
    for nd in path:
        surface = nd.surface or text[nd.start:nd.end]
        out.append(
            Token(surface, nd.pos, nd.detail, nd.base or surface,
                  nd.known)
        )
    return out


class JapaneseDictTokenizerFactory:
    """Kuromoji-analog TokenizerFactory: dictionary lattice + Viterbi
    with bigram connection costs; unknown spans grouped by script
    class. ``preprocessor`` follows the reference's TokenPreProcess
    seam. ``create`` yields surfaces (the Tokenizer SPI);
    ``tokenize`` yields POS-tagged :class:`Token`s (the reference's
    JapaneseTokenizer returns Kuromoji Tokens the same way)."""

    def __init__(self, preprocessor=None):
        self.preprocessor = preprocessor

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(segment(text), self.preprocessor)

    def tokenize(self, text: str) -> List[Token]:
        return tokenize(text)


# dictionary lattice becomes the default "japanese" tokenizer; the
# zero-dependency script-run fallback stays registered under an
# explicit name
register_tokenizer_factory("japanese", JapaneseDictTokenizerFactory)

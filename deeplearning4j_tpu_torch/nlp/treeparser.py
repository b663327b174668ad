"""Counterpart of ``deeplearning4j_tpu/nlp/treeparser.py`` (host code, the
same outputs on the same texts), whose docstring follows.

Text-annotation periphery (reference: `deeplearning4j-nlp-uima` —
`SentenceAnnotator`, `StemmerAnnotator` (Snowball), `PoStagger`
(ClearTK models), `corpora/treeparser/{TreeParser,TreeFactory,
BinarizeTreeTransformer,CollapseUnaries,TreeVectorizer}` — and the
recursive `Tree` structure in `deeplearning4j-nn`
`nn/layers/feedforward/autoencoder/recursive/Tree.java:1`).

The reference drives a UIMA pipeline with external statistical models;
this analog is dependency-free: rule-based sentence segmentation, the
published Porter (1980) stemming algorithm, a suffix-heuristic POS
tagger, and chunk-based constituency trees. The `Tree` node API
(label/children/value/vector, gold label, `is_leaf`, `yield_leaves`)
matches the reference contract so recursive models consume either."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# sentence segmentation (SentenceAnnotator analog)
# ---------------------------------------------------------------------------

_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc",
    "e.g", "i.e", "fig", "al", "inc", "ltd", "co", "corp", "no",
    "a.m", "p.m",
}
_SENT_END = re.compile(r"([.!?]+)(\s+|$)")


def segment_sentences(text: str) -> List[str]:
    """Split text into sentences on ., !, ? — holding back common
    abbreviations and initials (reference SentenceAnnotator's UIMA
    segmenter)."""
    sentences: List[str] = []
    start = 0
    for m in _SENT_END.finditer(text):
        prev = text[start:m.start()].rstrip()
        last_word = prev.rsplit(None, 1)[-1].lower() if prev else ""
        last_word = last_word.rstrip(".")
        if last_word in _ABBREV or (
            len(last_word) == 1 and last_word.isalpha()
        ):
            continue  # "Dr." / middle initial — not a boundary
        sent = text[start:m.end()].strip()
        if sent:
            sentences.append(sent)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences


# ---------------------------------------------------------------------------
# Porter stemmer (StemmerAnnotator analog) — implements the published
# Porter (1980) algorithm steps 1a-5b
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences."""
    forms = "".join(
        "c" if _is_cons(stem, i) else "v" for i in range(len(stem))
    )
    return len(re.findall("vc", forms))


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


_STEP2 = [
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
    ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
    ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
    ("iviti", "ive"), ("biliti", "ble"),
]
_STEP3 = [
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
]
_STEP4 = [
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
]


def porter_stem(word: str) -> str:
    """Porter (1980) stemmer, the classic Snowball-English ancestor
    (reference StemmerAnnotator wraps Snowball)."""
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif (w.endswith("ed") and _has_vowel(w[:-2])) or (
        w.endswith("ing") and _has_vowel(w[:-3])
    ):
        w = w[:-2] if w.endswith("ed") else w[:-3]
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in _STEP2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in _STEP3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and _measure(w[:-3]) > 1 and \
                w[:-3].endswith(("s", "t")):
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _ends_cvc(w[:-1])):
            w = w[:-1]
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# POS-lite tagger (PoStagger analog)
# ---------------------------------------------------------------------------

_CLOSED = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT", "every": "DT", "each": "DT",
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC",
    "in": "IN", "on": "IN", "at": "IN", "of": "IN", "for": "IN",
    "with": "IN", "to": "TO", "by": "IN", "from": "IN", "over": "IN",
    "under": "IN", "through": "IN", "than": "IN", "as": "IN",
    "into": "IN", "about": "IN", "after": "IN", "before": "IN",
    # be/have/do — the irregular auxiliaries every tagger ships as
    # closed-class entries (OpenNLP's dictionaries do the same)
    "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD", "be": "VB",
    "been": "VBN", "being": "VBG", "am": "VBP",
    "have": "VBP", "has": "VBZ", "had": "VBD",
    "do": "VBP", "does": "VBZ", "did": "VBD", "done": "VBN",
    # modals
    "can": "MD", "could": "MD", "may": "MD", "might": "MD",
    "must": "MD", "shall": "MD", "should": "MD", "will": "MD",
    "would": "MD",
    # pronouns / possessives / wh
    "he": "PRP", "she": "PRP", "it": "PRP", "they": "PRP", "we": "PRP",
    "i": "PRP", "you": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "us": "PRP", "them": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
    "our": "PRP$", "their": "PRP$",
    "who": "WP", "what": "WP", "which": "WDT", "whose": "WP$",
    "there": "EX",
    # small numerals (larger ones hit the digit rule)
    "one": "CD", "two": "CD", "three": "CD", "four": "CD",
    "five": "CD", "six": "CD", "seven": "CD", "eight": "CD",
    "nine": "CD", "ten": "CD",
    # frequent irregular verb forms
    "went": "VBD", "gone": "VBN", "came": "VBD", "come": "VB",
    "saw": "VBD", "seen": "VBN", "sat": "VBD", "said": "VBD",
    "made": "VBD", "took": "VBD", "taken": "VBN", "got": "VBD",
    "gave": "VBD", "given": "VBN", "knew": "VBD", "known": "VBN",
    "found": "VBD", "thought": "VBD", "told": "VBD", "became": "VBD",
    "left": "VBD", "kept": "VBD", "held": "VBD", "brought": "VBD",
    "wrote": "VBD", "written": "VBN", "stood": "VBD", "heard": "VBD",
    "met": "VBD", "ran": "VBD", "won": "VBD", "threw": "VBD",
    "blew": "VBD", "grew": "VBD", "flew": "VBD", "drove": "VBD",
    "rose": "VBD", "fell": "VBD", "built": "VBD", "slept": "VBD",
    "spoke": "VBD", "broke": "VBD", "broken": "VBN", "bought": "VBD",
    "caught": "VBD", "taught": "VBD", "felt": "VBD", "lost": "VBD",
    "rang": "VBD", "sang": "VBD", "swam": "VBD", "forgot": "VBD",
    # frequent adverbs that morphology misses
    "not": "RB", "very": "RB", "too": "RB", "also": "RB", "often": "RB",
    "never": "RB", "always": "RB", "again": "RB", "soon": "RB",
    "twice": "RB", "once": "RB", "here": "RB", "now": "RB",
    "then": "RB", "together": "RB", "away": "RB",
}


def pos_tag(tokens: Sequence[str]) -> List[str]:
    """Statistical POS tags via the averaged-perceptron tagger
    (reference ``PoStagger.java:54`` wraps a trained OpenNLP model;
    :mod:`deeplearning4j_tpu_torch.nlp.pos_tagger` is the trained-model
    analog). The rule tagger below stays as the dependency-free
    fallback (``pos_tag_rules``) and backstops unseen feature sets."""
    if not tokens:
        return []
    from deeplearning4j_tpu_torch.nlp.pos_tagger import default_tagger

    return [t for _, t in default_tagger().tag(list(tokens))]


def pos_tag_rules(tokens: Sequence[str]) -> List[str]:
    """Suffix-heuristic POS tags (closed-class lexicon + morphology) —
    the pre-statistical fallback."""
    tags = []
    for tok in tokens:
        low = tok.lower()
        if low in _CLOSED:
            tags.append(_CLOSED[low])
        elif re.fullmatch(r"[-+]?\d[\d.,]*", tok):
            tags.append("CD")
        elif low.endswith("ly"):
            tags.append("RB")
        elif low.endswith("ing"):
            tags.append("VBG")
        elif low.endswith("ed"):
            tags.append("VBD")
        elif low.endswith(("ous", "ful", "ive", "able", "al", "ic")):
            tags.append("JJ")
        elif tok[:1].isupper():
            tags.append("NNP")
        elif low.endswith("s") and not low.endswith("ss"):
            tags.append("NNS")
        else:
            tags.append("NN")
    return tags


# ---------------------------------------------------------------------------
# Tree structure + parser + vectorizer (Tree.java / treeparser analog)
# ---------------------------------------------------------------------------


@dataclass
class Tree:
    """Recursive constituency node (reference `Tree.java:1` — label,
    children, value/vector slots for recursive autoencoders, gold
    label, tokens)."""

    label: str = ""
    children: List["Tree"] = field(default_factory=list)
    value: Optional[str] = None          # surface token for leaves
    vector: Optional[np.ndarray] = None  # attached by TreeVectorizer
    gold_label: int = 0
    prediction: Optional[np.ndarray] = None

    def is_leaf(self) -> bool:
        return not self.children

    def is_preterminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def yield_leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.yield_leaves())
        return out

    def tokens(self) -> List[str]:
        return [leaf.value for leaf in self.yield_leaves()
                if leaf.value is not None]

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def clone(self) -> "Tree":
        return Tree(
            label=self.label,
            children=[c.clone() for c in self.children],
            value=self.value,
            vector=None if self.vector is None else self.vector.copy(),
            gold_label=self.gold_label,
        )


def binarize(tree: Tree) -> Tree:
    """Right-binarize n-ary nodes (reference
    ``BinarizeTreeTransformer``)."""
    if tree.is_leaf():
        return tree.clone()  # fresh leaves: vectorizing the binarized
        # tree must not mutate the input tree's nodes
    kids = [binarize(c) for c in tree.children]
    while len(kids) > 2:
        right = Tree(label=f"@{tree.label}", children=kids[-2:])
        kids = kids[:-2] + [right]
    return Tree(label=tree.label, children=kids, value=tree.value,
                gold_label=tree.gold_label)


def collapse_unaries(tree: Tree) -> Tree:
    """Collapse unary chains X->Y->... (reference
    ``CollapseUnaries``), keeping preterminal->leaf."""
    t = tree
    while (
        len(t.children) == 1
        and not t.children[0].is_leaf()
        and not t.children[0].is_preterminal()
    ):
        t = t.children[0]
    return Tree(label=tree.label, children=[
        collapse_unaries(c) for c in t.children
    ], value=t.value, gold_label=tree.gold_label)


class TreeParser:
    """Sentence -> chunked constituency Tree (reference ``TreeParser``
    drives a UIMA/OpenNLP parser; the analog builds flat NP/VP/PP
    chunks from POS-lite tags under a sentence root)."""

    _CHUNK_OF = {
        "DT": "NP", "JJ": "NP", "NN": "NP", "NNS": "NP", "NNP": "NP",
        "PRP": "NP", "CD": "NP",
        "VB": "VP", "VBZ": "VP", "VBP": "VP", "VBD": "VP", "VBG": "VP",
        "RB": "VP",
        "IN": "PP", "TO": "PP",
    }

    def __init__(self, tokenizer_factory=None):
        if tokenizer_factory is None:
            from deeplearning4j_tpu_torch.nlp.tokenization import (
                DefaultTokenizerFactory,
            )
            tokenizer_factory = DefaultTokenizerFactory()
        self.tf = tokenizer_factory

    def parse(self, sentence: str) -> Tree:
        tokens = list(self.tf.create(sentence).get_tokens())
        tags = pos_tag(tokens)
        root = Tree(label="S")
        chunk: Optional[Tree] = None
        chunk_kind = None
        for tok, tag in zip(tokens, tags):
            kind = self._CHUNK_OF.get(tag, "X")
            if chunk is None or kind != chunk_kind:
                chunk = Tree(label=kind)
                root.children.append(chunk)
                chunk_kind = kind
            chunk.children.append(
                Tree(label=tag, children=[Tree(value=tok, label=tok)])
            )
        return root

    def trees(self, text: str) -> List[Tree]:
        """All sentences of ``text`` parsed (reference
        ``TreeParser.getTrees``)."""
        return [self.parse(s) for s in segment_sentences(text)]


class TreeVectorizer:
    """Attach word vectors to every leaf (reference ``TreeVectorizer``
    feeds trees to the recursive autoencoder). ``lookup`` is any
    ``word -> vector | None`` callable — e.g. ``Word2Vec.
    get_word_vector`` — unknown words get zeros."""

    def __init__(self, lookup: Callable[[str], Optional[np.ndarray]],
                 layer_size: int, *, stem: bool = True):
        self.lookup = lookup
        self.layer_size = layer_size
        self.stem = stem

    def vectorize(self, tree: Tree) -> Tree:
        for leaf in tree.yield_leaves():
            word = leaf.value or ""
            v = self.lookup(word)
            if v is None and self.stem:
                # vocabularies hold surface forms; only fall back to
                # the Porter stem ("happi") when the word itself misses
                v = self.lookup(porter_stem(word))
            leaf.vector = (
                np.zeros(self.layer_size, np.float32)
                if v is None else np.asarray(v, np.float32)
            )
        return tree

    def trees_with_vectors(self, text: str,
                           parser: Optional[TreeParser] = None):
        parser = parser or TreeParser()
        return [self.vectorize(t) for t in parser.trees(text)]

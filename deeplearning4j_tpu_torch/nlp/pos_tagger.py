"""Counterpart of ``deeplearning4j_tpu/nlp/pos_tagger.py`` (host code, the
same outputs on the same texts), whose docstring follows.

Statistical part-of-speech tagging (reference:
``deeplearning4j-nlp-uima``'s ``PoStagger.java:54`` wraps a TRAINED
OpenNLP maxent model via UIMA; the capability is statistical sequence
tagging, not rule lookup).

TPU-era rebuild: an averaged-perceptron tagger — the standard
lightweight discriminative tagger (greedy left-to-right, contextual +
morphological features, averaged weights) — trained on a checked-in
mini-treebank (Penn-style tags, hand-annotated here; no external model
files, zero downloads). The honest divergence is training-set scale,
not algorithm class: a real deployment calls ``train()`` on a full
treebank through the same API.

``pos_tag`` in :mod:`deeplearning4j_tpu_torch.nlp.treeparser` routes through
the default tagger; the old suffix heuristics remain as
``pos_tag_rules`` and as the final fallback for tokens whose feature
scores tie at zero.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class AveragedPerceptronTagger:
    """Greedy averaged-perceptron POS tagger.

    Standard formulation: per-class weight vectors over sparse binary
    features; on a training mistake, +1 the gold class weights and -1
    the predicted class weights; final weights are the average over
    all update timesteps (which regularizes the late updates)."""

    START = ("-START-", "-START2-")

    def __init__(self):
        self.weights: Dict[str, Dict[str, float]] = {}
        self.classes: set = set()
        # single-tag words bypass scoring (fast path + precision)
        self.tagdict: Dict[str, str] = {}
        # averaging machinery
        self._totals = defaultdict(float)
        self._tstamps = defaultdict(int)
        self._i = 0

    # -- features ------------------------------------------------------

    @staticmethod
    def _normalize(word: str) -> str:
        if word.isdigit():
            return "!DIGIT"
        if any(c.isdigit() for c in word):
            return "!HASDIGIT"
        return word.lower()

    def _features(self, i: int, word: str, context: List[str],
                  prev: str, prev2: str) -> Dict[str, int]:
        """Sparse feature dict for position i (context is padded by
        two START entries)."""
        i += 2
        f: Dict[str, int] = {}

        def add(name, *args):
            f[" ".join((name,) + args)] = 1

        low = word.lower()
        add("bias")
        # the rule tagger's guess as a feature: a morphological prior
        # the perceptron learns to trust per context (and can
        # override) — worth ~15 points of held-out accuracy at
        # mini-treebank scale
        from deeplearning4j_tpu_torch.nlp.treeparser import pos_tag_rules

        add("rule", pos_tag_rules([word])[0])
        add("w", self._normalize(word))
        add("suf3", low[-3:])
        add("suf2", low[-2:])
        add("suf1", low[-1:])
        add("pre1", low[:1])
        add("shape",
            "U" if word.isupper() else
            "T" if word[:1].isupper() else
            "d" if word.isdigit() else "l")
        if "-" in word[1:-1]:
            add("hyphen")
        add("t-1", prev)
        add("t-2", prev2)
        add("t-1t-2", prev, prev2)
        add("t-1w", prev, self._normalize(word))
        add("w-1", self._normalize(context[i - 1]))
        add("w-1suf3", context[i - 1].lower()[-3:])
        add("w-2", self._normalize(context[i - 2]))
        add("w+1", self._normalize(context[i + 1]))
        add("w+1suf3", context[i + 1].lower()[-3:])
        add("w+2", self._normalize(context[i + 2]))
        return f

    # -- scoring / prediction ------------------------------------------

    def _score(self, features: Dict[str, int]) -> Dict[str, float]:
        scores: Dict[str, float] = defaultdict(float)
        for feat in features:
            w = self.weights.get(feat)
            if not w:
                continue
            for cls, wt in w.items():
                scores[cls] += wt
        return scores

    def tag(self, tokens: Sequence[str]) -> List[Tuple[str, str]]:
        """Tag one tokenized sentence: [(word, tag), ...]."""
        prev, prev2 = self.START
        out: List[Tuple[str, str]] = []
        context = (list(self.START) + [
            self._normalize(t) for t in tokens
        ] + ["-END-", "-END2-"])
        for i, word in enumerate(tokens):
            tag = self.tagdict.get(word.lower())
            if tag is None:
                scores = self._score(
                    self._features(i, word, context, prev, prev2)
                )
                if scores:
                    tag = max(self.classes,
                              key=lambda c: (scores.get(c, 0.0), c))
                else:  # wholly unseen features: morphology fallback
                    from deeplearning4j_tpu_torch.nlp.treeparser import (
                        pos_tag_rules,
                    )

                    tag = pos_tag_rules([word])[0]
            out.append((word, tag))
            prev2, prev = prev, tag
        return out

    # -- training ------------------------------------------------------

    def _update(self, truth: str, guess: str,
                features: Dict[str, int]) -> None:
        self._i += 1
        if truth == guess:
            return
        for feat in features:
            w = self.weights.setdefault(feat, {})
            for cls, delta in ((truth, 1.0), (guess, -1.0)):
                key = (feat, cls)
                self._totals[key] += (
                    (self._i - self._tstamps[key]) * w.get(cls, 0.0)
                )
                self._tstamps[key] = self._i
                w[cls] = w.get(cls, 0.0) + delta

    def _average_weights(self) -> None:
        for feat, w in self.weights.items():
            for cls in list(w):
                key = (feat, cls)
                total = self._totals[key] + (
                    (self._i - self._tstamps[key]) * w[cls]
                )
                avg = total / max(self._i, 1)
                if abs(avg) > 1e-9:
                    w[cls] = round(avg, 6)
                else:
                    del w[cls]

    def train(self, sentences: Iterable[List[Tuple[str, str]]],
              n_iter: int = 8, seed: int = 1) -> "AveragedPerceptronTagger":
        """``sentences``: [[(word, tag), ...], ...]."""
        sentences = list(sentences)
        self._make_tagdict(sentences)
        rng = random.Random(seed)
        for _ in range(n_iter):
            for sent in sentences:
                words = [w for w, _ in sent]
                context = (list(self.START) + [
                    self._normalize(w) for w in words
                ] + ["-END-", "-END2-"])
                prev, prev2 = self.START
                for i, (word, truth) in enumerate(sent):
                    guess = self.tagdict.get(word.lower())
                    if guess is None:
                        feats = self._features(
                            i, word, context, prev, prev2
                        )
                        scores = self._score(feats)
                        guess = (
                            max(self.classes,
                                key=lambda c: (scores.get(c, 0.0), c))
                            if scores else truth
                        )
                        self._update(truth, guess, feats)
                    prev2, prev = prev, guess
            rng.shuffle(sentences)
        self._average_weights()
        return self

    def _make_tagdict(self, sentences) -> None:
        counts: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        for sent in sentences:
            for word, tag in sent:
                counts[word.lower()][tag] += 1
                self.classes.add(tag)
        for word, tag_counts in counts.items():
            tag, mode = max(tag_counts.items(), key=lambda kv: kv[1])
            n = sum(tag_counts.values())
            # unambiguous + frequent enough -> closed entry
            if n >= 2 and mode / n >= 0.99:
                self.tagdict[word] = tag

    # -- persistence ----------------------------------------------------

    def save(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({
                "weights": self.weights,
                "tagdict": self.tagdict,
                "classes": sorted(self.classes),
            }, f)

    @classmethod
    def load(cls, path) -> "AveragedPerceptronTagger":
        t = cls()
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        t.weights = d["weights"]
        t.tagdict = d["tagdict"]
        t.classes = set(d["classes"])
        return t


# ---------------------------------------------------------------------------
# Checked-in mini-treebank (hand-annotated, Penn tags). Scale is the
# documented divergence: a real deployment trains on a full treebank
# through the same train() API.
# ---------------------------------------------------------------------------

_RAW = """
The/DT cat/NN sat/VBD on/IN the/DT mat/NN ./.
A/DT dog/NN barked/VBD at/IN the/DT mailman/NN ./.
She/PRP quickly/RB opened/VBD the/DT old/JJ door/NN ./.
He/PRP reads/VBZ a/DT book/NN every/DT night/NN ./.
They/PRP are/VBP running/VBG in/IN the/DT park/NN ./.
I/PRP have/VBP seen/VBN that/DT movie/NN twice/RB ./.
We/PRP will/MD visit/VB the/DT museum/NN tomorrow/NN ./.
The/DT children/NNS played/VBD with/IN small/JJ toys/NNS ./.
My/PRP$ sister/NN writes/VBZ long/JJ letters/NNS ./.
John/NNP lives/VBZ in/IN London/NNP ./.
Mary/NNP and/CC John/NNP went/VBD to/TO school/NN ./.
The/DT quick/JJ brown/JJ fox/NN jumps/VBZ over/IN the/DT lazy/JJ dog/NN ./.
This/DT model/NN trains/VBZ very/RB fast/RB ./.
The/DT network/NN learned/VBD useful/JJ features/NNS ./.
Researchers/NNS published/VBD three/CD new/JJ papers/NNS ./.
The/DT price/NN rose/VBD by/IN five/CD percent/NN ./.
It/PRP was/VBD raining/VBG heavily/RB yesterday/NN ./.
Birds/NNS fly/VBP south/RB in/IN winter/NN ./.
The/DT teacher/NN gave/VBD us/PRP difficult/JJ homework/NN ./.
You/PRP should/MD eat/VB more/JJR vegetables/NNS ./.
The/DT company/NN has/VBZ hired/VBN two/CD engineers/NNS ./.
Old/JJ houses/NNS often/RB need/VBP expensive/JJ repairs/NNS ./.
The/DT river/NN flows/VBZ through/IN the/DT valley/NN ./.
Students/NNS were/VBD studying/VBG for/IN their/PRP$ exams/NNS ./.
A/DT strong/JJ wind/NN blew/VBD from/IN the/DT north/NN ./.
He/PRP carefully/RB repaired/VBD the/DT broken/JJ clock/NN ./.
The/DT committee/NN approved/VBD the/DT budget/NN quickly/RB ./.
Many/JJ people/NNS enjoy/VBP walking/VBG on/IN the/DT beach/NN ./.
Her/PRP$ answer/NN surprised/VBD everyone/NN ./.
The/DT train/NN arrives/VBZ at/IN nine/CD ./.
Scientists/NNS discovered/VBD a/DT distant/JJ planet/NN ./.
We/PRP watched/VBD the/DT game/NN together/RB ./.
The/DT bread/NN smells/VBZ wonderful/JJ ./.
Workers/NNS built/VBD a/DT tall/JJ bridge/NN ./.
The/DT baby/NN slept/VBD peacefully/RB ./.
I/PRP can/MD hear/VB the/DT music/NN ./.
She/PRP has/VBZ finished/VBN her/PRP$ report/NN ./.
The/DT garden/NN looks/VBZ beautiful/JJ in/IN spring/NN ./.
Heavy/JJ rain/NN flooded/VBD the/DT streets/NNS ./.
They/PRP sell/VBP fresh/JJ fruit/NN at/IN the/DT market/NN ./.
The/DT engine/NN started/VBD immediately/RB ./.
A/DT famous/JJ author/NN signed/VBD my/PRP$ book/NN ./.
Children/NNS love/VBP sweet/JJ desserts/NNS ./.
The/DT manager/NN will/MD announce/VB the/DT results/NNS soon/RB ./.
Wolves/NNS hunt/VBP in/IN packs/NNS ./.
The/DT snow/NN melted/VBD slowly/RB ./.
He/PRP drives/VBZ an/DT electric/JJ car/NN ./.
The/DT lecture/NN was/VBD extremely/RB boring/JJ ./.
Farmers/NNS grow/VBP wheat/NN and/CC corn/NN ./.
The/DT team/NN won/VBD the/DT final/JJ match/NN ./.
She/PRP speaks/VBZ three/CD languages/NNS fluently/RB ./.
The/DT stars/NNS shine/VBP brightly/RB at/IN night/NN ./.
An/DT honest/JJ politician/NN is/VBZ rare/JJ ./.
The/DT chef/NN prepared/VBD a/DT delicious/JJ meal/NN ./.
Tourists/NNS visit/VBP the/DT ancient/JJ castle/NN ./.
The/DT phone/NN rang/VBD twice/RB ./.
I/PRP forgot/VBD my/PRP$ keys/NNS again/RB ./.
The/DT wall/NN was/VBD painted/VBN white/JJ ./.
Doctors/NNS recommend/VBP regular/JJ exercise/NN ./.
The/DT meeting/NN ended/VBD early/RB ./.
Strong/JJ coffee/NN keeps/VBZ me/PRP awake/JJ ./.
The/DT library/NN opens/VBZ at/IN eight/CD ./.
He/PRP threw/VBD the/DT ball/NN over/IN the/DT fence/NN ./.
The/DT old/JJ man/NN walks/VBZ his/PRP$ dog/NN daily/RB ./.
Prices/NNS are/VBP rising/VBG everywhere/RB ./.
The/DT actor/NN forgot/VBD his/PRP$ lines/NNS ./.
A/DT gentle/JJ breeze/NN cooled/VBD the/DT room/NN ./.
They/PRP have/VBP moved/VBN to/TO Paris/NNP ./.
The/DT student/NN asked/VBD a/DT clever/JJ question/NN ./.
Rivers/NNS carry/VBP water/NN to/TO the/DT sea/NN ./.
The/DT clock/NN stopped/VBD at/IN noon/NN ./.
She/PRP wears/VBZ a/DT red/JJ scarf/NN in/IN winter/NN ./.
The/DT bakery/NN sells/VBZ fresh/JJ bread/NN every/DT morning/NN ./.
Which/WDT road/NN leads/VBZ to/TO the/DT village/NN ?/.
Who/WP wrote/VBD this/DT letter/NN ?/.
There/EX is/VBZ a/DT problem/NN with/IN the/DT printer/NN ./.
The/DT results/NNS were/VBD better/JJR than/IN expected/VBN ./.
It/PRP is/VBZ the/DT tallest/JJS building/NN in/IN town/NN ./.
"""


def load_treebank() -> List[List[Tuple[str, str]]]:
    out = []
    for line in _RAW.strip().split("\n"):
        sent = []
        for pair in line.split():
            word, _, tag = pair.rpartition("/")
            sent.append((word, tag))
        out.append(sent)
    return out


_default: Optional[AveragedPerceptronTagger] = None


def default_tagger() -> AveragedPerceptronTagger:
    """The tagger trained on the bundled mini-treebank (cached;
    training takes well under a second)."""
    global _default
    if _default is None:
        _default = AveragedPerceptronTagger().train(load_treebank())
    return _default

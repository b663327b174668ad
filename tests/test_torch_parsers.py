"""The port's parsers and taggers (``nlp/treeparser.py``,
``pos_tagger.py``, ``cjk.py``, ``japanese.py``; host code, no tensor)
against the JAX package's on the same texts: every output is held
equal, すもももももももものうち included. The two taggers' trained
weights are equal, and a tagger saved by either package loads in the
other."""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import cjk as jcjk  # noqa: F401 (registers)
from deeplearning4j_tpu.nlp import japanese as jja
from deeplearning4j_tpu.nlp import pos_tagger as jpt
from deeplearning4j_tpu.nlp import treeparser as jtp
from deeplearning4j_tpu.nlp.tokenization import (
    tokenizer_factory as jtokenizer_factory,
)
from deeplearning4j_tpu_torch.nlp import japanese as ja
from deeplearning4j_tpu_torch.nlp import pos_tagger as pt
from deeplearning4j_tpu_torch.nlp import treeparser as tp
from deeplearning4j_tpu_torch.nlp.tokenization import tokenizer_factory

ENGLISH = (
    "The big dog chased the cat. Dr. Smith arrived at 5 p.m. yesterday! "
    "Did the engineers quickly fix the broken server? They were running "
    "relational databases, generalizations and hopefully conditional "
    "adjustments. A cat sat on the mat while the dogs ran happily.")
JAPANESE = (
    "すもももももももものうち",
    "東京大学に行きます",
    "くるまでまつ",
    "新しい時計を買いました",
    "友達と映画を見に行きました",
    "図書館で宿題をしてから帰ります",
    "コーヒーを飲みながら新聞を読みます",
    "天気予報によると明日は雨が降ります",
    "フレームワークは速い",
    "3月に行きます",
    "新しい本を読んだ",
    "烏龍茶を飲む",
    "私はPython3で機械学習を勉強しています。",
)
KOREAN = ("안녕하세요 세계 ㅋㅋ abc123", "오늘은 날씨가 좋네요!")
WORDS = ("caresses ponies ties caress cats feed agreed plastered motoring "
         "sing conflated troubled sized hopping tanned falling hissing "
         "fizzed failing filing happy sky relational conditional rational "
         "valenci hesitanci digitizer conformabli radicalli differentli "
         "vileli analogousli vietnamization predication operator "
         "feudalism decisiveness hopefulness callousness formaliti "
         "sensitiviti sensibiliti triplicate formative formalize "
         "electriciti electrical hopeful goodness revival allowance "
         "inference airliner gyroscopic adjustable defensible irritant "
         "replacement adjustment dependent adoption homologou communism "
         "activate angulariti homologous effective bowdlerize probate "
         "rate cease controll roll generalizations oscillators").split()


def _tree(t):
    """A tree as nested tuples (label, value, children)."""
    return (t.label, t.value, tuple(_tree(c) for c in t.children))


def test_segmentation_stemming_and_rule_tags_equal_jax():
    assert tp.segment_sentences(ENGLISH) == jtp.segment_sentences(ENGLISH)
    assert [tp.porter_stem(w) for w in WORDS] == [jtp.porter_stem(w)
                                                  for w in WORDS]
    for sent in jtp.segment_sentences(ENGLISH):
        toks = sent.replace(".", " .").replace("?", " ?").split()
        assert tp.pos_tag(toks) == jtp.pos_tag(toks)
        assert tp.pos_tag_rules(toks) == jtp.pos_tag_rules(toks)


def test_tree_parser_binarize_collapse_and_vectorizer_equal_jax():
    parser, jparser = tp.TreeParser(), jtp.TreeParser()
    trees, jtrees = parser.trees(ENGLISH), jparser.trees(ENGLISH)
    assert [_tree(t) for t in trees] == [_tree(t) for t in jtrees]
    for t, jt in zip(trees, jtrees):
        assert _tree(tp.binarize(t)) == _tree(jtp.binarize(jt))
        assert _tree(tp.collapse_unaries(t)) == _tree(
            jtp.collapse_unaries(jt))
        assert t.tokens() == jt.tokens() and t.depth() == jt.depth()
    rng = np.random.RandomState(0)
    table = {tp.porter_stem(w.lower()): rng.randn(4).astype(np.float32)
             for w in ENGLISH.split()}
    vec = tp.TreeVectorizer(table.get, layer_size=4)
    jvec = jtp.TreeVectorizer(table.get, layer_size=4)
    for t, jt in zip(vec.trees_with_vectors(ENGLISH),
                     jvec.trees_with_vectors(ENGLISH)):
        assert _tree(t) == _tree(jt)
        for a, b in zip(t.yield_leaves(), jt.yield_leaves()):
            np.testing.assert_array_equal(a.vector, b.vector)


def test_perceptron_tagger_trains_equal_weights_and_crosses(tmp_path):
    bank = pt.load_treebank()
    assert bank == jpt.load_treebank()
    train = [s for i, s in enumerate(bank) if i % 5]
    tagger = pt.AveragedPerceptronTagger().train(train, seed=7)
    jtagger = jpt.AveragedPerceptronTagger().train(train, seed=7)
    assert tagger.weights == jtagger.weights
    for sent in bank[::5] + [["zzzqqq", "flumming", "quickly"]]:
        words = [w if isinstance(w, str) else w[0] for w in sent]
        assert tagger.tag(words) == jtagger.tag(words)
    sent = "The engineers quickly fixed the broken server".split()
    assert pt.default_tagger().tag(sent) == jpt.default_tagger().tag(sent)
    tagger.save(tmp_path / "port.json")
    jtagger.save(tmp_path / "jax.json")
    assert (jpt.AveragedPerceptronTagger.load(tmp_path / "port.json")
            .tag(sent) == tagger.tag(sent))
    assert (pt.AveragedPerceptronTagger.load(tmp_path / "jax.json")
            .tag(sent) == jtagger.tag(sent))


@pytest.mark.parametrize("name", ["japanese", "japanese_script", "korean"])
def test_cjk_tokenizer_factories_equal_jax(name):
    for text in JAPANESE + KOREAN:
        assert (tokenizer_factory(name).create(text).get_tokens()
                == jtokenizer_factory(name).create(text).get_tokens())


def test_japanese_lattice_tokens_equal_jax():
    assert ja.segment("すもももももももものうち") == [
        "すもも", "も", "もも", "も", "もも", "の", "うち"]
    for text in JAPANESE:
        assert ja.segment(text) == jja.segment(text)
        assert [tuple(t) for t in ja.tokenize(text)] == [
            tuple(t) for t in jja.tokenize(text)]
    d, jd = ja.default_dictionary(), jja.default_dictionary()
    assert len(d) == len(jd) >= 2000
    for ch in "時ぞ〇食":
        assert d.max_surface_len(ch) == jd.max_surface_len(ch)


def test_japanese_user_dictionary_equal_jax(tmp_path):
    d, jd = ja.JapaneseDictionary(ja.LEXICON), jja.JapaneseDictionary(
        jja.LEXICON)
    for dic in (d, jd):
        dic.add_word("烏龍茶", pos="noun", detail="beverage")
    pth = tmp_path / "user.tsv"
    pth.write_text("紅茶花伝\t240\tnoun\tbrand\t紅茶花伝\n", encoding="utf-8")
    assert d.load_tsv(str(pth)) == jd.load_tsv(str(pth)) == 1
    for text in ("烏龍茶を飲む", "紅茶花伝を買いました"):
        assert [tuple(t) for t in ja.tokenize(text, dictionary=d)] == [
            tuple(t) for t in jja.tokenize(text, dictionary=jd)]
    with pytest.raises(ValueError):
        d.add_word("x", pos="nonsense")

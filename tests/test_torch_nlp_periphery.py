"""The port's NLP periphery on the CPU (``nlp/vectorizers.py``,
``nlp/inverted_index.py``, ``nlp/static_word2vec.py``,
``nlp/model_utils.py``, ``graph/loader.py``, ``graph/serializer.py``):
one counterpart of each test of ``tests/test_nlp_periphery.py``, and
each module held against the JAX package on the same inputs.

Tolerances: these modules are host code (numpy and text files) in both
packages, so vocabularies, TF-IDF and bag-of-words matrices, postings,
nearest words and the files' contents are equal exactly; a
``StaticWord2Vec`` directory and a graph-vector file written by one
package read back bit for bit in the other."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import graph as jgraph
from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp.vocab import VocabCache as JVocabCache
from deeplearning4j_tpu.nlp.vocab import VocabWord as JVocabWord
from deeplearning4j_tpu_torch import graph as tgraph
from deeplearning4j_tpu_torch.nlp import (
    BagOfWordsVectorizer,
    BasicModelUtils,
    CharTokenizerFactory,
    FlatModelUtils,
    InvertedIndex,
    StaticWord2Vec,
    TfidfVectorizer,
    TreeModelUtils,
    register_tokenizer_factory,
    save_static,
    tokenizer_factory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord

DOCS = [
    ("the quick brown fox jumps", "animal"),
    ("the lazy dog sleeps all day", "animal"),
    ("stocks rallied as markets rose", "finance"),
    ("the markets fell on rate fears", "finance"),
]


def _words(cache):
    return [(w.word, w.count, w.index) for w in cache.words]


def _docs(seed, n=40, vocab=60, length=12):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [(" ".join(words[i] for i in rng.choice(vocab, length, p=p)),
             f"c{i % 3}") for i in range(n)]


def test_bag_of_words_counts():
    v = BagOfWordsVectorizer(device="cpu")
    v.fit(DOCS)
    ds = v.vectorize("the the dog", "animal")
    assert tuple(ds.features.shape) == (1, len(v.cache))
    assert ds.features[0, v.cache.index_of("the")] == 2.0
    assert ds.features[0, v.cache.index_of("dog")] == 1.0
    assert ds.labels[0, v.labels.index("animal")] == 1.0


def test_tfidf_downweights_common_words():
    v = TfidfVectorizer(device="cpu")
    v.fit(DOCS)
    row = v.transform("the fox")
    assert row[v.cache.index_of("fox")] > row[v.cache.index_of("the")]
    assert v.tfidf_word("fox", "the fox") > 0
    assert v.tfidf_word("absent", "the fox") == 0.0
    assert row[v.cache.index_of("the")] >= 0.0


def test_vectorize_all_matrix():
    v = TfidfVectorizer(device="cpu")
    v.fit(DOCS)
    ds = v.vectorize_all(DOCS)
    assert tuple(ds.features.shape) == (4, len(v.cache))
    assert tuple(ds.labels.shape) == (4, 2)
    np.testing.assert_array_equal(ds.labels.sum(dim=1).numpy(), 1.0)


@pytest.mark.parametrize("kind", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_match_jax(kind):
    """Vocabulary, document frequencies and the whole matrix equal the
    JAX package's; the DataSet lies on the vectorizer's device."""
    docs = _docs(3)
    j = getattr(jnlp, kind)(stop_words=["w1"])
    t = {"BagOfWordsVectorizer": BagOfWordsVectorizer,
         "TfidfVectorizer": TfidfVectorizer}[kind](stop_words=["w1"],
                                                  device="cpu")
    j.fit(docs)
    t.fit(docs)
    assert _words(t.cache) == _words(j.cache)
    np.testing.assert_array_equal(t.doc_freq, j.doc_freq)
    assert t.labels == j.labels
    jd, td = j.vectorize_all(docs), t.vectorize_all(docs)
    assert torch.is_tensor(td.features) and td.features.device.type == "cpu"
    np.testing.assert_array_equal(td.features.numpy(),
                                  np.asarray(jd.features))
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))
    if kind == "TfidfVectorizer":
        assert t.tfidf_word("w0", docs[0][0]) == j.tfidf_word(
            "w0", docs[0][0])


def test_vectorizer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TfidfVectorizer()


def test_inverted_index_postings_and_batches():
    idx = InvertedIndex(batch_size=2)
    d0 = idx.add_doc(["a", "b", "a"], label="x")
    d1 = idx.add_doc(["b", "c"], label="y")
    d2 = idx.add_doc(["a"], label="x")
    idx.finish()
    assert idx.num_documents() == 3
    assert idx.documents("a") == [d0, d2]
    assert idx.documents("b") == [d0, d1]
    assert idx.doc_frequency("a") == 2
    assert idx.document(d1) == ["b", "c"]
    assert idx.document_label(d1) == "y"
    batches = list(idx.batch_iter())
    assert [len(b) for b in batches] == [2, 1]
    sample = idx.sample(5, seed=1)
    assert len(sample) == 5
    assert all(s in [["a", "b", "a"], ["b", "c"], ["a"]] for s in sample)


def test_inverted_index_postings_equal_jax():
    docs = [(text.split(), label) for text, label in _docs(5)]
    j, t = jnlp.InvertedIndex(batch_size=7), InvertedIndex(batch_size=7)
    for ix in (j, t):
        for words, label in docs:
            ix.add_doc(words, label=label)
        ix.add_word_to_doc(len(docs) + 1, "late")
        ix.finish()
    for w in {w for words, _ in docs for w in words} | {"late", "nope"}:
        assert t.documents(w) == j.documents(w)
        assert t.doc_frequency(w) == j.doc_frequency(w)
    assert list(t.batch_iter()) == list(j.batch_iter())
    assert t.sample(9, seed=4) == j.sample(9, seed=4)
    assert list(t.eachdoc_with_label()) == list(j.eachdoc_with_label())


def _toy_vectors(cache_cls=VocabCache, word_cls=VocabWord):
    cache = cache_cls()
    words = ["king", "queen", "man", "woman", "apple"]
    for w in words:
        cache.add(word_cls(w, 5))
    m = np.array([
        [1.0, 1.0, 0.0],   # king
        [1.0, 0.9, 0.2],   # queen
        [0.9, 0.1, 0.0],   # man
        [0.9, 0.0, 0.2],   # woman
        [0.0, 0.0, 1.0],   # apple
    ], np.float32)
    return cache, m


def test_static_word2vec_round_trip(tmp_path):
    cache, m = _toy_vectors()
    save_static((cache, m), str(tmp_path))
    sw = StaticWord2Vec(str(tmp_path))
    assert sw.has_word("king") and not sw.has_word("nope")
    np.testing.assert_allclose(sw.get_word_vector("queen"), m[1])
    assert not sw.syn0.flags.writeable
    assert sw.similarity("king", "queen") > sw.similarity("king", "apple")
    assert sw.words_nearest("king", 1) == ["queen"]
    v1 = sw.get_word_vector("king")
    v2 = sw.get_word_vector("king")
    assert v1 is v2


def test_static_word2vec_directories_cross_packages(tmp_path):
    """A directory written by either package reads back in the other
    bit for bit; a trained port Word2Vec (tables on the CPU) saves
    through ``_resolve``."""
    rng = np.random.RandomState(0)
    cache, _ = _toy_vectors()
    jcache, _ = _toy_vectors(JVocabCache, JVocabWord)
    m = rng.randn(5, 7).astype(np.float32)
    save_static((cache, m), str(tmp_path / "t"))
    jnlp.save_static((jcache, m), str(tmp_path / "j"))
    for d in ("t", "j"):
        a = StaticWord2Vec(str(tmp_path / d))
        b = jnlp.StaticWord2Vec(str(tmp_path / d))
        np.testing.assert_array_equal(np.asarray(a.syn0), m)
        np.testing.assert_array_equal(np.asarray(b.syn0), m)
        assert _words(a.cache) == _words(b.cache)
        assert a.words_nearest("king", 3) == b.words_nearest("king", 3)
    assert (tmp_path / "t" / "vocab.txt").read_text() == (
        tmp_path / "j" / "vocab.txt").read_text()
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w2v = Word2Vec(cache, [np.arange(5)] * 4, layer_size=4, epochs=1,
                   device="cpu")
    save_static(w2v, str(tmp_path / "w"))
    np.testing.assert_array_equal(
        np.load(tmp_path / "w" / "vectors.npy"), w2v.lookup.syn0.numpy())


def test_model_utils_flat_vs_tree_agree():
    cache, m = _toy_vectors()
    flat = BasicModelUtils((cache, m))
    tree = TreeModelUtils((cache, m))
    for w in ["king", "queen", "man"]:
        assert flat.words_nearest(w, 2) == tree.words_nearest(w, 2)
    assert flat.similarity("king", "queen") == pytest.approx(
        float(
            (m[0] / np.linalg.norm(m[0])) @ (m[1] / np.linalg.norm(m[1]))
        ), abs=1e-6,
    )


def test_words_nearest_sum_analogy():
    cache, m = _toy_vectors()
    utils = BasicModelUtils((cache, m))
    got = utils.words_nearest_sum(
        ["king", "woman"], negative=["man"], n=1
    )
    assert got == ["queen"]


def test_model_utils_match_jax_on_a_trained_model():
    """Nearest words (flat and VP-tree) and analogy sums of a port
    Word2Vec equal the JAX utilities' over the same table."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    sents = [t.split() for t, _ in _docs(8, n=30, vocab=40)]
    cache = __import__(
        "deeplearning4j_tpu_torch.nlp.vocab", fromlist=["x"]
    ).VocabConstructor(1).build_vocab_from_tokens(sents)
    ids = [np.asarray([cache.index_of(w) for w in s], np.int32)
           for s in sents]
    w2v = Word2Vec(cache, ids, layer_size=8, batch_size=64, epochs=1,
                   device="cpu")
    w2v.fit()
    m = w2v.lookup.syn0.numpy()
    jcache = JVocabCache()
    for w in cache.words:
        jcache.add(JVocabWord(w.word, w.count))
    for ours, theirs in ((FlatModelUtils(w2v), jnlp.FlatModelUtils(
            (jcache, m))), (TreeModelUtils(w2v), jnlp.TreeModelUtils(
                (jcache, m)))):
        for w in ("w0", "w3", "w7"):
            assert ours.words_nearest(w, 5) == theirs.words_nearest(w, 5)
        assert ours.words_nearest_sum(["w0", "w2"], ["w1"], 4) == (
            theirs.words_nearest_sum(["w0", "w2"], ["w1"], 4))
        assert ours.similarity("w0", "w1") == theirs.similarity("w0", "w1")
    assert TreeModelUtils(w2v).words_nearest("w3", 6) == FlatModelUtils(
        w2v).words_nearest("w3", 6)


def test_tokenizer_registry_spi():
    tf = tokenizer_factory("default")
    assert tf.create("a b c").get_tokens() == ["a", "b", "c"]
    # the CJK segmenters are registered with the package (nlp/cjk.py,
    # nlp/japanese.py; tests/test_torch_parsers.py holds them to JAX)
    assert tokenizer_factory("japanese").create(
        "すもももももももものうち").get_tokens()[:3] == ["すもも", "も", "もも"]
    assert tokenizer_factory("korean").create("안녕 세계").get_tokens() == [
        "안녕", "세계"]
    rx = tokenizer_factory("regex", pattern=r"[,;]")
    assert rx.create("a,b;c").get_tokens() == ["a", "b", "c"]

    class Upper(CharTokenizerFactory):
        pass

    register_tokenizer_factory("upper-test", Upper)
    assert isinstance(tokenizer_factory("upper-test"), Upper)
    with pytest.raises(KeyError, match="no TokenizerFactory"):
        tokenizer_factory("klingon")


def test_vectorizer_with_registered_tokenizer():
    v = BagOfWordsVectorizer(tokenizer_factory=tokenizer_factory("char"),
                             device="cpu")
    v.fit([("ab", "x"), ("bc", "y")])
    row = v.transform("abb")
    assert row[v.cache.index_of("b")] == 2.0


# -- graph/loader.py and graph/serializer.py --------------------------------


def test_edge_list_loaders_match_jax(tmp_path):
    plain = tmp_path / "edges.txt"
    plain.write_text("# comment\n0,1\n1,2\n\n2,3\n// also\n3,0\n")
    weighted = tmp_path / "weighted.txt"
    weighted.write_text("0 1 0.5\n1 2 2.0\n2 0 1.5\n")
    for path, kw, fn in (
            (plain, {}, "load_undirected_graph_edge_list_file"),
            (weighted, {"delim": " ", "directed": True},
             "load_weighted_edge_list_file")):
        t = getattr(tgraph, fn)(str(path), 4, **kw)
        j = getattr(jgraph, fn)(str(path), 4, **kw)
        for v in range(4):
            np.testing.assert_array_equal(
                t.get_connected_vertex_indices(v),
                j.get_connected_vertex_indices(v))
            assert [(e.to_idx, e.weight, e.directed)
                    for e in t.get_edges_out(v)] == [
                (e.to_idx, e.weight, e.directed)
                for e in j.get_edges_out(v)]
    bad = tmp_path / "bad.txt"
    bad.write_text("0,1,2\n")
    with pytest.raises(tgraph.ParseException):
        tgraph.load_undirected_graph_edge_list_file(str(bad), 3)
    values = tmp_path / "values.txt"
    values.write_text("2:c\n0:a\n# skip\n1:b\n")
    assert tgraph.load_vertex_values(str(values)) == (
        jgraph.load_vertex_values(str(values))) == ["a", "b", "c"]
    with pytest.raises(tgraph.ParseException):
        values.write_text("0-a\n")
        tgraph.load_vertex_values(str(values))


def test_graph_vectors_round_trip_between_packages(tmp_path):
    """A port DeepWalk's vectors written by the port load in the JAX
    package bit for bit, and a file the JAX package writes loads into
    the port (on the caller's device)."""
    g = tgraph.Graph(12)
    for i in range(12):
        g.add_edge(i, (i + 1) % 12)
        g.add_edge(i, (i + 5) % 12)
    dw = tgraph.DeepWalk(vector_size=6, window_size=2, seed=3, device="cpu")
    dw.initialize(g)
    dw.fit(g, walk_length=5)
    want = dw.lookup_table.get_vertex_vectors()
    path = tmp_path / "t.txt"
    tgraph.write_graph_vectors(dw, str(path))
    back = jgraph.load_txt_vectors(str(path))
    np.testing.assert_array_equal(np.asarray(
        back.lookup_table.get_vertex_vectors()), want)
    jpath = tmp_path / "j.txt"
    jgraph.write_graph_vectors(back, str(jpath))
    assert jpath.read_text() == path.read_text()
    mine = tgraph.load_txt_vectors(str(jpath), device="cpu")
    assert mine.lookup_table.vertex_vectors.device.type == "cpu"
    np.testing.assert_array_equal(mine.lookup_table.get_vertex_vectors(),
                                  want)
    assert mine.vertices_nearest(0, 3) == back.vertices_nearest(0, 3)
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    with pytest.raises(tgraph.ParseException):
        tgraph.load_txt_vectors(str(empty), device="cpu")

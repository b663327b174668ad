"""The port's NLP subsystem (``deeplearning4j_tpu_torch/nlp``) against
the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function and its
counterpart in the port. Host-side modules (tokenization, vocabulary,
Huffman coding, the unigram table, subsampling, pair generation,
serialization) must agree exactly. Tolerances of the float math:

- one step (NS, HS, CBOW NS, CBOW HS) on carried tables:
  ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5);
- a whole fit (Word2Vec's host routes and its device-generation epochs
  fed the JAX package's draws, GloVe, ParagraphVectors and
  ``infer_vector``): rtol 1e-4, atol 1e-6 — the same updates summed in
  another order (the port folds duplicate rows by a sorted segmented
  sum, XLA by its scatter-add), over a few dozen batches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from conftest import kernel_tols
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as tpv
from deeplearning4j_tpu_torch.nlp import serializer as tser
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v

FIT_RTOL, FIT_ATOL = 1e-4, 1e-6


def zipf_sentences(n, length, vocab, seed):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [[f"w{i}" for i in rng.choice(vocab, size=length, p=p)]
            for _ in range(n)]


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def assert_tables(jlk, tlk, rtol=FIT_RTOL, atol=FIT_ATOL):
    for name in ("syn0", "syn1", "syn1neg"):
        a, b = getattr(jlk, name), getattr(tlk, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=rtol,
                                       atol=atol, err_msg=name)


class _JSeq(jw2v.SequenceVectors):
    def __init__(self, cache, seqs, **kw):
        super().__init__(cache, **kw)
        self._seqs = seqs

    def _sequences(self):
        return iter(self._seqs)


class _TSeq(tw2v.SequenceVectors):
    def __init__(self, cache, seqs, **kw):
        super().__init__(cache, device="cpu", **kw)
        self._seqs = seqs

    def _sequences(self):
        return iter(self._seqs)


@pytest.fixture(scope="module")
def corpus():
    sents = zipf_sentences(200, 12, 60, 0)
    jc = jvocab.VocabConstructor(1).build_vocab_from_tokens(sents)
    tc = tvocab.VocabConstructor(1).build_vocab_from_tokens(sents)
    ids = [np.asarray([jc.index_of(w) for w in s], np.int32) for s in sents]
    return sents, jc, tc, ids


# -- host modules, exactly --------------------------------------------------


def _common(m):
    f = m.DefaultTokenizerFactory()
    f.set_token_pre_processor(m.common_preprocessor)
    return f


@pytest.mark.parametrize("make", [
    lambda m: m.DefaultTokenizerFactory(),
    _common,
    lambda m: m.NGramTokenizerFactory(1, 3),
    lambda m: m.CharTokenizerFactory(),
    lambda m: m.RegexTokenizerFactory(r"[,!]\s*"),
    lambda m: m.tokenizer_factory("ngram", min_n=2, max_n=2),
], ids=["default", "common", "ngram", "char", "regex", "registry"])
def test_tokenizers_equal_jax(make):
    text = "The quick, brown fox -- jumps over 3 lazy dogs! ÉTÉ été"
    assert (make(ttok).create(text).get_tokens()
            == make(jtok).create(text).get_tokens())


def test_sentence_iterators_equal_jax(tmp_path):
    path = tmp_path / "c.txt"
    path.write_text("a b c\n\n  d e  \nf\n")
    for name in ("LineSentenceIterator", "FileSentenceIterator"):
        assert (list(getattr(ttok, name)(str(path)))
                == list(getattr(jtok, name)(str(path))))
    docs = ["x y", "z"]
    assert (list(ttok.CollectionSentenceIterator(docs))
            == list(jtok.CollectionSentenceIterator(docs)))


def test_vocab_huffman_and_unigram_table_equal_jax(corpus):
    _, jc, tc, _ = corpus
    assert [(w.word, w.count, w.index) for w in tc.words] == [
        (w.word, w.count, w.index) for w in jc.words]
    assert tc.total_word_count == jc.total_word_count
    jh, th = jvocab.Huffman(jc.words), tvocab.Huffman(tc.words)
    jh.build()
    th.build()
    for a, b in zip(th.padded_arrays(), jh.padded_arrays()):
        np.testing.assert_array_equal(a, b)
    for limit in (None, 40):
        np.testing.assert_array_equal(
            tvocab.build_unigram_table(tc, limit=limit),
            jvocab.build_unigram_table(jc, limit=limit))


def test_subsample_mask_equals_jax(corpus):
    _, jc, _, ids = corpus
    flat = np.concatenate(ids)
    counts = np.array([w.count for w in jc.words], np.int64)
    for sample in (0.0, 1e-3, 1e-1):
        np.testing.assert_array_equal(
            tvocab.subsample_mask(flat, counts, jc.total_word_count, sample,
                                  np.random.RandomState(4)),
            jvocab.subsample_mask(flat, counts, jc.total_word_count, sample,
                                  np.random.RandomState(4)))


@pytest.mark.parametrize("algo", ["SkipGram", "CBOW"])
def test_pair_generators_equal_jax(corpus, algo):
    _, jc, tc, ids = corpus
    kw = dict(layer_size=8, window=3, seed=2, algorithm=algo)
    j, t = _JSeq(jc, ids, **kw), _TSeq(tc, ids, **kw)
    gen = "_gen_cbow" if algo == "CBOW" else "_gen_pairs"
    for a, b in zip(getattr(t, gen)(33), getattr(j, gen)(33)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t._sample_negatives(16, 5),
                                  j._sample_negatives(16, 5))


# -- one step on carried tables ---------------------------------------------


def _tables(rng, v, d):
    return [(rng.randn(v, d) * 0.3).astype(np.float32) for _ in range(2)]


def test_ns_step_matches_jax(rng):
    v, d, b, k = 30, 8, 64, 5
    s0, s1 = _tables(rng, v, d)
    c = rng.zipf(1.5, b).clip(1, v) - 1
    o = rng.randint(0, v, b)
    negs = rng.randint(0, v, (b, k))
    negs[0, 0] = o[0]  # a collision, masked
    mask = np.ones(b, np.float32)
    mask[-5:] = 0
    j0, j1, jl = jw2v._ns_step_raw(
        jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(c, jnp.int32),
        jnp.asarray(o, jnp.int32), jnp.asarray(negs, jnp.int32),
        jnp.asarray(mask), jnp.float32(0.3), False)
    t0, t1 = torch.from_numpy(s0.copy()), torch.from_numpy(s1.copy())
    tl = tw2v._ns_step_raw(t0, t1, torch.from_numpy(c).long(),
                           torch.from_numpy(o).long(),
                           torch.from_numpy(negs).long(),
                           torch.from_numpy(mask), 0.3)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol, atol)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol, atol)
    np.testing.assert_allclose(float(tl), float(jl), rtol, atol)


def _paths(rng, b, l, v):
    codes = rng.randint(0, 2, (b, l)).astype(np.float32)
    points = rng.randint(0, v - 1, (b, l))
    lens = rng.randint(1, l + 1, b)
    pmask = (np.arange(l)[None] < lens[:, None]).astype(np.float32)
    return codes, points, pmask


def test_hs_step_matches_jax(rng):
    v, d, b, l = 30, 8, 64, 6
    s0, s1 = _tables(rng, v, d)
    c = rng.randint(0, v, b)
    codes, points, pmask = _paths(rng, b, l, v)
    mask = np.ones(b, np.float32)
    j0, j1, jl = jw2v._hs_step_raw(
        jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(c, jnp.int32),
        jnp.asarray(codes), jnp.asarray(points, jnp.int32),
        jnp.asarray(pmask), jnp.asarray(mask), jnp.float32(0.2), False)
    t0, t1 = torch.from_numpy(s0.copy()), torch.from_numpy(s1.copy())
    tl = tw2v._hs_step_raw(t0, t1, torch.from_numpy(c).long(),
                           torch.from_numpy(codes),
                           torch.from_numpy(points).long(),
                           torch.from_numpy(pmask), torch.from_numpy(mask),
                           0.2)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol, atol)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol, atol)
    np.testing.assert_allclose(float(tl), float(jl), rtol, atol)


@pytest.mark.parametrize("leg", ["ns", "hs"])
def test_cbow_steps_match_jax(rng, leg):
    v, d, b, w, k, l = 30, 8, 48, 6, 4, 5
    s0, s1 = _tables(rng, v, d)
    ctx = rng.randint(0, v, (b, w))
    cm = (rng.rand(b, w) < 0.7).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-3:] = 0
    tgt = rng.randint(0, v, b)
    t0, t1 = torch.from_numpy(s0.copy()), torch.from_numpy(s1.copy())
    tc, tcm, tm = (torch.from_numpy(ctx).long(), torch.from_numpy(cm),
                   torch.from_numpy(mask))
    if leg == "ns":
        negs = rng.randint(0, v, (b, k))
        j0, j1, _ = jw2v._cbow_ns_step(
            jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(ctx, jnp.int32),
            jnp.asarray(cm), jnp.asarray(tgt, jnp.int32),
            jnp.asarray(negs, jnp.int32), jnp.asarray(mask),
            jnp.float32(0.4), dense=False)
        tw2v._cbow_ns_step(t0, t1, tc, tcm, torch.from_numpy(tgt).long(),
                           torch.from_numpy(negs).long(), tm, 0.4)
    else:
        codes, points, pmask = _paths(rng, b, l, v)
        j0, j1, _ = jw2v._cbow_hs_step(
            jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(ctx, jnp.int32),
            jnp.asarray(cm), jnp.asarray(codes),
            jnp.asarray(points, jnp.int32), jnp.asarray(pmask),
            jnp.asarray(mask), jnp.float32(0.4), dense=False)
        tw2v._cbow_hs_step(t0, t1, tc, tcm, torch.from_numpy(codes),
                           torch.from_numpy(points).long(),
                           torch.from_numpy(pmask), tm, 0.4)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol, atol)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol, atol)


# -- whole fits ---------------------------------------------------------------


@pytest.mark.parametrize("route", [
    dict(),                                      # chunked host pairs
    dict(scan_chunk=1),                          # per batch
    dict(iterations=2),                          # per batch, 2 iterations
    dict(use_hierarchic_softmax=True),
    dict(use_hierarchic_softmax=True, negative=0),
    dict(algorithm="CBOW"),
    dict(algorithm="CBOW", use_hierarchic_softmax=True),
], ids=["chunked", "per_batch", "iterations2", "ns_hs", "hs", "cbow",
        "cbow_hs"])
def test_host_route_fit_matches_jax(corpus, route):
    _, jc, tc, ids = corpus
    kw = dict(layer_size=16, window=3, negative=4, batch_size=64,
              epochs=2, seed=3)
    chunk = route.pop("scan_chunk", None)
    kw.update(route)
    j, t = _JSeq(jc, ids, **kw), _TSeq(tc, ids, **kw)
    if chunk is not None:
        j.scan_chunk = t.scan_chunk = chunk
    assert not t._use_device_gen()
    np.testing.assert_array_equal(t.lookup.syn0.numpy(),
                                  np.asarray(j.lookup.syn0))
    j.fit()
    t.fit()
    assert_tables(j.lookup, t.lookup)


def test_epoch_replay_cache_replays_the_same_epoch(corpus):
    """A second fit replays the cached chunks: the same tables as a
    trainer that generates them afresh (bitwise, one process)."""
    _, _, tc, ids = corpus
    kw = dict(layer_size=8, window=3, batch_size=64, epochs=1, seed=3)
    a, b = _TSeq(tc, ids, **kw), _TSeq(tc, ids, **kw)
    b.cache_epoch_data = False
    for m in (a, b):
        m.fit()
        m.fit()
    assert a._epoch_cache and not b._epoch_cache
    for x, y in zip(a.lookup.to_numpy(), b.lookup.to_numpy()):
        if x is not None:
            np.testing.assert_array_equal(x, y)


def jax_device_draws(j, epochs):
    """The JAX package's per-epoch draws of ``_sg_device_epochs``, rebuilt
    as its body makes them (``nlp/word2vec.py:296-313``)."""
    ids, pos, slen, kp, pool, _ = j._dev_corpus[1]
    n, w, p = ids.shape[0], j.window, pool.size
    base = jax.random.PRNGKey(j.seed)
    out = []
    for e in range(epochs):
        k1, k2, k3 = jax.random.split(
            jax.random.fold_in(base, jnp.int32(e)), 3)
        out.append((np.asarray(jax.random.uniform(k1, (n,)) < kp),
                    np.asarray(jax.random.randint(k2, (n,), 1, w + 1)),
                    np.asarray(jax.random.randint(k3, (), 0, p))))
    return out


@pytest.mark.parametrize("sample", [1e-3, 0.0])
def test_device_generation_epochs_fed_jax_draws_match_jax(corpus, sample):
    _, jc, tc, ids = corpus
    kw = dict(layer_size=16, window=3, negative=4, batch_size=64,
              epochs=2, seed=3, sample=sample)
    j, t = _JSeq(jc, ids, **kw), _TSeq(tc, ids, **kw)
    j.device_epoch_gen = t.device_epoch_gen = True
    assert t._use_device_gen()
    j.fit()
    corp = t.device_corpus()
    jid, _, _, jkp, jpool, jn = j._dev_corpus[1]
    np.testing.assert_array_equal(corp.ids.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(corp.kp_pos.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(corp.pool.numpy(), np.asarray(jpool))
    assert corp.n_words == jn
    t._fit_device_gen(jax_device_draws(j, 2))
    assert_tables(j.lookup, t.lookup)
    assert (t._dev_fit_no, t._dev_steps_done) == (1, 2 * corp.ids.shape[0]
                                                  // 64)


def test_device_route_alpha_schedule_is_jax_sched():
    """The host float32 schedule equals the JAX program's per-epoch
    alphas from ``sched`` (lr0, lr_min, total, step0)."""
    lr0, lr_min, total, step0, e, nb, b = 0.5, 1e-4, 3 * 40 * 64.0, 7, 3, 40, 64
    sched = jnp.asarray([lr0, lr_min, total, step0], jnp.float32)
    for ep in range(e):
        steps = (sched[3] + jnp.float32(ep) * nb
                 + jnp.arange(nb, dtype=jnp.float32))
        frac = jnp.minimum(steps * b / sched[2], 1.0)
        want = np.asarray(jnp.maximum(sched[0] * (1.0 - frac), sched[1]))
        got = tw2v.alpha_schedule(lr0, lr_min, total, step0, e, nb, b)[ep]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_device_generation_is_repeatable_and_continues(corpus):
    """Two trainers from one seed give the same tables bit for bit; a
    second fit draws fresh epochs and continues the schedule."""
    _, _, tc, ids = corpus
    kw = dict(layer_size=8, window=3, batch_size=64, epochs=1, seed=9)
    a, b = _TSeq(tc, ids, **kw), _TSeq(tc, ids, **kw)
    for m in (a, b):
        m.device_epoch_gen = True
        m.fit()
    for x, y in zip(a.lookup.to_numpy(), b.lookup.to_numpy()):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    before = a.lookup.syn0.clone()
    a.fit()
    assert a._dev_fit_no == 2 and not torch.equal(before, a.lookup.syn0)
    assert a._dev_steps_done == 2 * (a.device_corpus().ids.shape[0] // 64)


@pytest.mark.parametrize("slen,packed", [(255, True), (256, False)])
def test_keep_probabilities_quantize_in_the_packed_branch(slen, packed):
    """Under 2**16 words and sentences under 256 the keep probabilities
    are u16 fixed point, as the JAX package's packed upload makes them;
    at a 256-word sentence they stay float32. Both equal JAX's."""
    sents = zipf_sentences(3, slen, 40, 5)
    jc = jvocab.VocabConstructor(1).build_vocab_from_tokens(sents)
    tc = tvocab.VocabConstructor(1).build_vocab_from_tokens(sents)
    ids = [np.asarray([jc.index_of(w) for w in s], np.int32) for s in sents]
    kw = dict(layer_size=4, window=2, batch_size=128, epochs=1, seed=1,
              sample=1e-2)
    j, t = _JSeq(jc, ids, **kw), _TSeq(tc, ids, **kw)
    j.device_epoch_gen = True
    j.fit()
    kp = t.device_corpus().kp_pos.numpy()
    np.testing.assert_array_equal(kp, np.asarray(j._dev_corpus[1][3]))
    raw = t._keep_probs()[t.device_corpus().ids.numpy()]
    assert np.array_equal(kp, raw) != packed
    q = np.round(raw * 65535.0) / 65535.0
    np.testing.assert_allclose(kp, q if packed else raw, rtol=1e-7)


def test_query_api_on_carried_tables_equals_jax(corpus, rng):
    _, jc, tc, ids = corpus
    kw = dict(layer_size=8, window=3, seed=2)
    j, t = _JSeq(jc, ids, **kw), _TSeq(tc, ids, **kw)
    syn0 = rng.randn(len(jc), 8).astype(np.float32)
    j.lookup.syn0 = jnp.asarray(syn0)
    j.lookup.invalidate_norms()
    t.lookup.load_numpy(syn0)
    assert t.words_nearest("w3", 7) == j.words_nearest("w3", 7)
    assert t.similarity("w1", "w2") == pytest.approx(
        j.similarity("w1", "w2"), rel=1e-6)
    vec = rng.randn(8)
    assert t.words_nearest_vec(vec, 5) == j.words_nearest_vec(vec, 5)
    assert t.words_nearest("nope") == [] and np.isnan(t.similarity("a", "b"))
    np.testing.assert_array_equal(t.get_word_vector("w4"),
                                  j.get_word_vector("w4"))


def test_word2vec_builder_fit_matches_jax():
    texts = [" ".join(s) for s in zipf_sentences(120, 10, 40, 8)]

    def build(m, device=None):
        b = (m.Word2Vec.Builder().layer_size(8).window_size(2)
             .batch_size(32).epochs(2).seed(4).min_word_frequency(2)
             .iterate(m_tok(m).CollectionSentenceIterator(texts)))
        return b.device(device).build() if device else b.build()

    def m_tok(m):
        return ttok if m is tw2v else jtok

    j, t = build(jw2v), build(tw2v, "cpu")
    assert [w.word for w in t.cache.words] == [w.word for w in j.cache.words]
    j.fit()
    t.fit()
    assert_tables(j.lookup, t.lookup)


# -- serialization both ways -----------------------------------------------


@pytest.mark.parametrize("ext", ["txt", "bin", "zip", "csv"])
def test_word_vectors_written_by_either_package_load_in_the_other(
        tmp_path, corpus, rng, ext):
    _, jc, tc, ids = corpus
    t = _TSeq(tc, ids, layer_size=6, seed=2)
    j = _JSeq(jc, ids, layer_size=6, seed=2)
    m = rng.randn(len(tc), 6).astype(np.float32)
    t.lookup.load_numpy(m)
    j.lookup.syn0 = jnp.asarray(m)
    for writer, reader, name in ((tser, jser, "t2j"), (jser, tser, "j2t")):
        path = tmp_path / f"{name}.{ext}"
        writer.write_word_vectors(t if writer is tser else j, path)
        cache, got = reader.read_word_vectors(path)
        assert [w.word for w in cache.words] == [w.word for w in tc.words]
        np.testing.assert_array_equal(got, m)


def test_full_model_written_by_either_package_loads_in_the_other(
        tmp_path, corpus):
    _, jc, tc, ids = corpus
    kw = dict(layer_size=6, window=2, batch_size=64, seed=2,
              use_hierarchic_softmax=True)
    j = jw2v.Word2Vec(jc, ids, **kw)
    j.fit()
    jser.write_full_model(j, tmp_path / "j.zip")
    t = tser.load_full_model(tmp_path / "j.zip", ids, device="cpu")
    assert_tables(j.lookup, t.lookup, rtol=0, atol=0)
    tser.write_full_model(t, tmp_path / "t.zip")
    back = jser.load_full_model(tmp_path / "t.zip", ids)
    assert_tables(back.lookup, t.lookup, rtol=0, atol=0)
    j.fit()
    t.fit()  # both continue from the same tables
    assert_tables(j.lookup, t.lookup)


# -- GloVe and ParagraphVectors -----------------------------------------------


@pytest.mark.parametrize("symmetric", [True, False])
def test_glove_fit_matches_jax(symmetric):
    sents = zipf_sentences(150, 12, 50, 6)
    jc = jvocab.VocabConstructor(1).build_vocab_from_tokens(sents)
    tc = tvocab.VocabConstructor(1).build_vocab_from_tokens(sents)
    ids = [np.asarray(jc.id_stream(s), np.int64) for s in sents]
    kw = dict(layer_size=8, window=3, epochs=3, batch_size=128, seed=5,
              symmetric=symmetric)
    j = jglove.Glove(jc, ids, **kw)
    t = tglove.Glove(tc, ids, device="cpu", **kw)
    for a, b in zip(t.co.triples(), j.co.triples()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.state_numpy(), j._state):
        np.testing.assert_array_equal(a, np.asarray(b))
    j.fit()
    t.fit()
    for a, b in zip(t.state_numpy(), j._state):
        np.testing.assert_allclose(a, np.asarray(b), FIT_RTOL, FIT_ATOL)
    np.testing.assert_allclose(t.syn0, j.syn0, FIT_RTOL, FIT_ATOL)
    assert t.last_loss == pytest.approx(j.last_loss, rel=FIT_RTOL)
    assert t.words_nearest("w1", 5) == j.words_nearest("w1", 5)


def test_glove_step_on_carried_state_matches_jax(rng):
    v, d, b = 20, 6, 64
    state = [(rng.randn(v, d) * 0.1).astype(np.float32) for _ in range(2)]
    state += [(rng.randn(v) * 0.1).astype(np.float32) for _ in range(2)]
    state += [rng.rand(v, d).astype(np.float32) for _ in range(2)]
    state += [rng.rand(v).astype(np.float32) for _ in range(2)]
    rows, cols = rng.randint(0, v, b), rng.randint(0, v, b)
    logx = rng.randn(b).astype(np.float32)
    fx, mask = rng.rand(b).astype(np.float32), np.ones(b, np.float32)
    jstate, jl = jglove._glove_step(
        tuple(jnp.asarray(a) for a in state), jnp.asarray(rows, jnp.int32),
        jnp.asarray(cols, jnp.int32), jnp.asarray(logx), jnp.asarray(fx),
        jnp.asarray(mask), jnp.float32(0.05))
    tstate = tuple(torch.from_numpy(a.copy()) for a in state)
    tl = tglove._glove_step(tstate, torch.from_numpy(rows).long(),
                            torch.from_numpy(cols).long(),
                            torch.from_numpy(logx), torch.from_numpy(fx),
                            torch.from_numpy(mask), 0.05)
    rtol, atol = kernel_tols()
    for a, b_ in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol, atol)
    np.testing.assert_allclose(float(tl), float(jl), rtol, atol)


def _docs(m):
    texts = [" ".join(s) for s in zipf_sentences(60, 10, 40, 7)]
    labels = [f"doc{i % 20}" for i in range(60)]
    return m.LabelAwareIterator.from_texts(texts, labels)


@pytest.mark.parametrize("algo", ["DBOW", "DM"])
def test_paragraph_vectors_fit_and_infer_match_jax(algo):
    def build(pv, tok, device=None):
        b = (pv.ParagraphVectors.Builder().layer_size(8).window_size(2)
             .epochs(2).batch_size(64).seed(3)
             .sequence_learning_algorithm(algo).iterate(_docs(tok)))
        return b.device(device).build() if device else b.build()

    j, t = build(jpv, jtok), build(tpv, ttok, "cpu")
    assert t._label_index == j._label_index
    j.fit()
    t.fit()
    assert_tables(j.lookup, t.lookup)
    doc = "w1 w2 w3 w5 w8 w13"
    np.testing.assert_allclose(t.infer_vector(doc, epochs=5, seed=2),
                               j.infer_vector(doc, epochs=5, seed=2),
                               FIT_RTOL, FIT_ATOL)
    assert t.nearest_labels("doc0", 3) == j.nearest_labels("doc0", 3)
    np.testing.assert_array_equal(t.get_vector("doc3"), np.asarray(
        t.lookup.syn0[t._label_index["doc3"]]))


# -- chip_smoke.py's CPU twins -------------------------------------------


@pytest.mark.parametrize("fault", [None, "no-op", "half", "row", "twin-no-op"])
def test_chip_smoke_twin_holds_what_the_epoch_changed(corpus, fault):
    """``chip_smoke.hold_change`` passes a run that changed the tables as
    its twin did, and fails one that left them as they were, moved them
    half as far, or left the most-moved row behind (a dropped duplicate
    sum), and fails a twin that left them as they were."""
    import chip_smoke

    _, _, tc, ids = corpus
    t = _TSeq(tc, ids, layer_size=16, window=3, negative=4, batch_size=64,
              epochs=1, seed=3)
    start = chip_smoke.w2v_tables(torch, t)
    t.fit()
    want = chip_smoke.w2v_tables(torch, t)
    got = [w.clone() for w in want]
    if fault == "no-op":
        got = [s.clone() for s in start]
    elif fault == "half":
        got = [s + (w - s) / 2 for s, w in zip(start, want)]
    elif fault == "row":
        moved = (want[0] - start[0]).abs().amax(1)
        got[0][int(moved.argmax())] = start[0][int(moved.argmax())]
    elif fault == "twin-no-op":
        want = [s.clone() for s in start]
    if fault is None:
        err, atol = chip_smoke.hold_change(torch, "t", got, want, start)
        assert err == 0.0 and 0.0 < atol < 1e-5
    else:
        with pytest.raises(RuntimeError, match="differ|as it was"):
            chip_smoke.hold_change(torch, "t", got, want, start)


# -- the device route's captured epoch (EpochGraph) --------------------------


def test_epoch_graph_fill_takes_the_eager_draws_in_order(corpus):
    """``EpochGraph.fill`` draws from the generator exactly what the
    eager route's ``epoch_draws`` takes, epoch after epoch, leaving the
    generator where the eager route leaves it, and its static buffers
    hold those draws and the epoch's alphas (the graph's body reads them
    as the eager epoch reads its arguments)."""
    _, _, tc, ids = corpus
    kw = dict(layer_size=8, window=3, batch_size=64, epochs=1, seed=9)
    m = _TSeq(tc, ids, **kw)
    m.device_epoch_gen = True
    corpus_d = m.device_corpus()
    g = m.epoch_graph(corpus_d)
    assert m.epoch_graph(corpus_d) is g
    n_b = corpus_d.ids.shape[0] // 64
    alphas = torch.from_numpy(tw2v.alpha_schedule(
        0.5, 1e-4, 2.0 * n_b * 64, 0.0, 2, n_b, 64))
    gen_a = torch.Generator().manual_seed(3)
    gen_b = torch.Generator().manual_seed(3)
    for e in range(2):
        g.fill(gen_a, alphas[e])
        keep, b, shift = tw2v.epoch_draws(gen_b, corpus_d)
        assert torch.equal(g.keep, keep) and torch.equal(g.b, b)
        assert int(g.shift) == int(shift)
        assert torch.equal(g.alphas, alphas[e])
        assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert g.graph is None  # captured at the first replay, on the card


def test_epoch_graph_is_dropped_when_a_table_is_rebound(corpus):
    """``load_numpy`` rebinds the tables: the captured epoch no longer
    serves them, the next one is built on the new tensors, and the old
    tensors are never written again. A new corpus drops it too."""
    _, _, tc, ids = corpus
    m = _TSeq(tc, ids, layer_size=8, window=3, batch_size=64, epochs=1,
              seed=9)
    m.device_epoch_gen = True
    g = m.epoch_graph(m.device_corpus())
    old = m.lookup.syn0
    kept = old.clone()
    syn0, _, syn1neg = m.lookup.to_numpy()
    m.lookup.load_numpy(syn0, None, syn1neg)
    assert not g.bound_to(m.lookup.syn0, m.lookup.syn1neg)
    g2 = m.epoch_graph(m.device_corpus())
    assert g2 is not g and g2.bound_to(m.lookup.syn0, m.lookup.syn1neg)
    m.fit()  # eager on the CPU: it trains the new tensors alone
    assert torch.equal(old, kept)
    assert not torch.equal(m.lookup.syn0, old)
    m.batch_size = 32
    assert m.epoch_graph(m.device_corpus()) is not g2
    m.clear_epoch_cache()
    assert m._dev_graph is None


def test_device_route_on_the_cpu_stays_eager(corpus):
    """On the CPU ``fit`` runs the eager epoch (no graph is built): the
    tables of the explicitly eager route."""
    _, _, tc, ids = corpus
    kw = dict(layer_size=8, window=3, batch_size=64, epochs=2, seed=9)
    a, b = _TSeq(tc, ids, **kw), _TSeq(tc, ids, **kw)
    for m in (a, b):
        m.device_epoch_gen = True
    a.fit()
    b._fit_device_gen(eager=True)
    assert a._dev_graph is None
    assert torch.equal(a.lookup.syn0, b.lookup.syn0)
    assert torch.equal(a.lookup.syn1neg, b.lookup.syn1neg)

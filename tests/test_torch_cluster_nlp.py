"""The port's cluster NLP trainers (``parallel/cluster_nlp.py``) on the
CPU: one counterpart of each test of ``tests/test_cluster_nlp.py``, and
each held against the JAX package.

The ranks are subprocesses of torch + numpy + the port forming a gloo
group through a file under ``tmp_path`` (as ``tests/
test_torch_parallel.py``), each under a timeout of its own.

Tolerances: the vocabulary and the id sequences are host code and equal
the JAX package's exactly. Two ranks give every rank the same tables,
and the single-process port's bit for bit (each occurrence's gradient
is computed from the same rows and folded in the one-process order);
against the JAX package's mesh run the JAX test's tolerances hold
(rtol 2e-5, atol 1e-6 for the tables; rel 1e-4 for GloVe's loss)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp.glove import Glove as JGlove
from deeplearning4j_tpu.nlp.vocab import VocabConstructor as JVocab
from deeplearning4j_tpu.nlp.word2vec import SequenceVectors as JSeqVectors
from deeplearning4j_tpu.parallel.cluster_nlp import (
    ClusterGlove as JClusterGlove,
)
from deeplearning4j_tpu.parallel.cluster_nlp import (
    ClusterSequenceVectors as JClusterSeq,
)
from deeplearning4j_tpu.parallel.cluster_nlp import (
    TextPipeline as JTextPipeline,
)
from deeplearning4j_tpu.parallel.mesh import build_mesh as jmesh
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors
from deeplearning4j_tpu_torch.parallel import build_mesh
from deeplearning4j_tpu_torch.parallel.cluster_nlp import (
    ClusterGlove,
    ClusterSequenceVectors,
    ClusterWord2Vec,
    TextPipeline,
)

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180
W2V_KW = dict(layer_size=16, window=3, negative=4, batch_size=64, epochs=1,
              seed=7)
GLOVE_KW = dict(layer_size=12, window=3, learning_rate=0.05, epochs=3,
                batch_size=64, seed=11)

# One rank: the cluster trainer over the world, its tables saved.
_CHILD = r"""
import json, sys
import numpy as np
from deeplearning4j_tpu_torch.parallel import (
    build_mesh, init_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.parallel.cluster_nlp import (
    ClusterGlove, ClusterSequenceVectors, ClusterWord2Vec, TextPipeline)

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
mesh = build_mesh(data=spec["world"])
sentences = json.loads(open(spec["corpus"]).read())
tp = TextPipeline(min_word_frequency=1)
cache = tp.build_vocab(sentences)
ids = tp.to_id_sequences(sentences, cache)
kw = dict(spec["kw"], device="cpu")
out = {}
if spec["kind"] == "glove":
    m = ClusterGlove(cache, ids, mesh=mesh, **kw).fit()
    out["syn0"] = m.syn0
    out["loss"] = np.asarray(m.last_loss)
else:
    cls = ClusterWord2Vec if spec["kind"] == "w2v" else ClusterSequenceVectors
    m = cls(cache, ids, mesh=mesh, **kw)
    for attr, v in spec.get("set", {}).items():
        setattr(m, attr, v)
    m.fit()
    out["syn0"] = m.lookup.syn0.numpy()
    out["syn1neg"] = m.lookup.syn1neg.numpy()
    out["batch"] = np.asarray(m.batch_size)
np.savez(spec["out"], **out)
shutdown_distributed()
"""


def run_ranks(tmp_path, world, kind, corpus, **spec_kw):
    run = tmp_path / f"run{len(list(tmp_path.glob('run*')))}"
    run.mkdir()
    (run / "corpus.json").write_text(json.dumps(corpus))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        spec = dict(rank=r, world=world, rdv=str(run / "rdv"), kind=kind,
                    corpus=str(run / "corpus.json"),
                    out=str(run / f"out{r}.npz"), **spec_kw)
        logs.append(run / f"err{r}.txt")
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, json.dumps(spec)],
                cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
                stderr=err))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"ranks hung past {RANK_TIMEOUT_S} s:\n" + "\n---\n".join(
            log.read_text()[-2000:] for log in logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    return [dict(np.load(run / f"out{r}.npz")) for r in range(world)]


def _corpus(rng, n_sent=60, sent_len=12, vocab=30):
    words = [f"w{i}" for i in range(vocab)]
    # two "topics" so similarity structure exists
    return [
        " ".join(
            words[rng.randint(0, vocab // 2)] if s % 2 == 0
            else words[rng.randint(vocab // 2, vocab)]
            for _ in range(sent_len)
        )
        for s in range(n_sent)
    ]


class _Seq(SequenceVectors):
    def __init__(self, cache, seqs, **kw):
        super().__init__(cache, **kw)
        self._seqs = seqs

    def _sequences(self):
        return iter(self._seqs)


class _JSeq(JSeqVectors):
    def __init__(self, cache, seqs, **kw):
        super().__init__(cache, **kw)
        self._seqs = seqs

    def _sequences(self):
        return iter(self._seqs)


def _vocab_ids(sentences):
    tp = TextPipeline(min_word_frequency=1)
    cache = tp.build_vocab(sentences)
    return cache, tp.to_id_sequences(sentences, cache)


def test_text_pipeline_matches_serial_vocab(rng):
    sentences = _corpus(rng)
    serial = VocabConstructor(min_word_frequency=2).build_vocab(sentences)
    for parts in (1, 3, 4):
        parallel = TextPipeline(
            min_word_frequency=2, n_partitions=parts
        ).build_vocab(sentences)
        assert len(parallel) == len(serial)
        for w in serial.words:
            assert parallel.word_for(w.word).count == w.count
        assert [w.word for w in parallel.words] == [
            w.word for w in serial.words
        ]


def test_text_pipeline_id_sequences(rng):
    sentences = _corpus(rng)
    tp = TextPipeline(min_word_frequency=2)
    cache = tp.build_vocab(sentences)
    ids = tp.to_id_sequences(sentences, cache)
    assert len(ids) == len(sentences)
    assert all(a.dtype == np.int32 for a in ids)
    assert all((a >= 0).all() and (a < len(cache)).all()
               for a in ids if len(a))


@pytest.mark.parametrize("min_freq,parts", [(1, 4), (2, 3)])
def test_text_pipeline_equals_jax(rng, min_freq, parts):
    """Vocabulary (words, counts, indices, total) and id sequences equal
    the JAX pipeline's."""
    sentences = _corpus(rng, n_sent=50) + [["pre", "tokenized", "w1"]]
    t = TextPipeline(min_word_frequency=min_freq, n_partitions=parts)
    j = JTextPipeline(min_word_frequency=min_freq, n_partitions=parts)
    tc, jc = t.build_vocab(sentences), j.build_vocab(sentences)
    assert [(w.word, w.count, w.index) for w in tc.words] == [
        (w.word, w.count, w.index) for w in jc.words]
    assert tc.total_word_count == jc.total_word_count
    for a, b in zip(t.to_id_sequences(sentences, tc),
                    j.to_id_sequences(sentences, jc)):
        np.testing.assert_array_equal(a, b)


def test_mesh_word2vec_matches_single_device(rng, tmp_path):
    """Two ranks: every rank's tables equal the single-process port's
    bit for bit, and the JAX mesh run's within the JAX test's
    tolerance; the nearest words agree."""
    require = jax.devices()
    sentences = _corpus(rng)
    cache, ids = _vocab_ids(sentences)
    single = _Seq(cache, ids, device="cpu", **W2V_KW)
    single.fit()
    res = run_ranks(tmp_path, 2, "seq", sentences, kw=W2V_KW)
    for out in res:
        assert int(out["batch"]) == 64
        np.testing.assert_array_equal(out["syn0"], single.lookup.syn0.numpy())
        np.testing.assert_array_equal(out["syn1neg"],
                                      single.lookup.syn1neg.numpy())
    jt = JTextPipeline(min_word_frequency=1)
    jcache = jt.build_vocab(sentences)
    jids = jt.to_id_sequences(sentences, jcache)
    mesh = jmesh(data=len(require), model=1)
    jsharded = JClusterSeq(jcache, jids, mesh=mesh, **W2V_KW)
    jsharded.fit()
    np.testing.assert_allclose(res[0]["syn0"], np.asarray(
        jsharded.lookup.syn0), rtol=2e-5, atol=1e-6)
    w = cache.word_at(0)
    assert single.words_nearest(w, 3) == jsharded.words_nearest(w, 3)


def test_mesh_word2vec_per_batch_route_matches_single_device(rng, tmp_path):
    """The per-batch route (``iterations=2``) and CBOW split the batch
    the same way: two ranks equal one process bit for bit."""
    sentences = _corpus(rng, n_sent=30)
    cache, ids = _vocab_ids(sentences)
    for kw in (dict(W2V_KW, iterations=2),
               dict(W2V_KW, algorithm="CBOW")):
        single = _Seq(cache, ids, device="cpu", **kw)
        single.fit()
        res = run_ranks(tmp_path, 2, "seq", sentences, kw=kw)
        for out in res:
            np.testing.assert_array_equal(out["syn0"],
                                          single.lookup.syn0.numpy())


def test_mesh_word2vec_rounds_batch_to_mesh(rng, tmp_path):
    """A batch of 30 over two ranks rounds up to 30 (and over a world
    of four to 32), as the JAX trainer rounds to its mesh, and trains
    without uneven shards."""
    sentences = _corpus(rng, n_sent=20)
    kw = dict(layer_size=8, batch_size=30, epochs=1, negative=2, seed=3)
    res = run_ranks(tmp_path, 4, "seq", sentences, kw=kw)
    for out in res:
        assert int(out["batch"]) % 4 == 0 and int(out["batch"]) == 32
        assert np.isfinite(out["syn0"]).all()
    cache, ids = _vocab_ids(sentences)
    one = ClusterSequenceVectors(cache, ids, mesh=build_mesh(device="cpu"),
                                 device="cpu", **kw)
    assert one.batch_size == 30 and one.mesh.data == 1
    one.fit()


def test_cluster_word2vec_builder_path(rng):
    """ClusterWord2Vec IS-A Word2Vec: same query surface after fit."""
    sentences = _corpus(rng, n_sent=30)
    cache, ids = _vocab_ids(sentences)
    w2v = ClusterWord2Vec(
        cache, ids, layer_size=12, window=3, negative=3,
        batch_size=64, epochs=1, seed=5, device="cpu",
    )
    assert not w2v._use_device_gen()
    w2v.fit()
    w = cache.word_at(0)
    assert w2v.has_word(w)
    assert w2v.get_word_vector(w).shape == (12,)
    assert len(w2v.words_nearest(w, 5)) == 5


def test_mesh_glove_matches_single_device(rng, tmp_path):
    """Two ranks: GloVe's vectors equal the single-process port's bit for
    bit and the JAX mesh run's within its tolerance; the loss within
    rel 1e-4."""
    sentences = _corpus(rng)
    cache, ids = _vocab_ids(sentences)
    single = Glove(cache, ids, device="cpu", **GLOVE_KW).fit()
    res = run_ranks(tmp_path, 2, "glove", sentences, kw=GLOVE_KW)
    for out in res:
        np.testing.assert_array_equal(out["syn0"], single.syn0)
        assert float(out["loss"]) == pytest.approx(single.last_loss,
                                                   rel=1e-4)
    jt = JTextPipeline(min_word_frequency=1)
    jcache = jt.build_vocab(sentences)
    jids = jt.to_id_sequences(sentences, jcache)
    mesh = jmesh(data=len(jax.devices()), model=1)
    jsharded = JClusterGlove(jcache, jids, mesh=mesh, **GLOVE_KW).fit()
    np.testing.assert_allclose(res[0]["syn0"], jsharded.syn0, rtol=2e-5,
                               atol=1e-6)
    assert float(res[0]["loss"]) == pytest.approx(jsharded.last_loss,
                                                  rel=1e-4)
    jsingle = JGlove(jcache, jids, **GLOVE_KW).fit()
    np.testing.assert_allclose(single.syn0, jsingle.syn0, rtol=2e-5,
                               atol=1e-6)


def test_cluster_trainers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sentences = _corpus(np.random.RandomState(0), n_sent=4)
    cache, ids = _vocab_ids(sentences)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterWord2Vec(cache, ids, layer_size=4)

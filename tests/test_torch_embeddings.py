"""The port's sharded embeddings (``deeplearning4j_tpu_torch/embeddings``)
and embedding layers, on the CPU, against the JAX package and against
their own unsharded versions.

Multi-rank cases run each rank as a subprocess of torch + numpy + the
port forming a gloo group through a file under ``tmp_path``, as
``tests/test_torch_parallel.py`` does, each run under a timeout of its
own.

Tolerances: the sharded lookup and update equal the unsharded ones bit
for bit at 1, 2 and 4 ranks (the lookup sums one owned row and exact
zeros; the deduplicated update is the same replicated arithmetic on
every rank), and checkpoints restore bit for bit in either package at
any world size. Against the JAX package: ``sparse.py`` and one layer
step within ``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5); a whole fit
(``ShardedWord2Vec``, three ``EmbeddingLayer`` training steps) within
rtol 1e-4, atol 1e-6 (the same updates summed in another order).
"""

import json
import os
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import kernel_tols
from deeplearning4j_tpu.embeddings import ShardedWord2Vec as JShardedW2V
from deeplearning4j_tpu.embeddings import sparse as jsparse
from deeplearning4j_tpu.nlp.vocab import VocabConstructor as JVocab
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import EmbeddingLayer as JEmbedding
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SparseEmbeddingLayer as JSparseEmb
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.embeddings import ShardedEmbeddingTable
from deeplearning4j_tpu_torch.embeddings import ShardedWord2Vec
from deeplearning4j_tpu_torch.embeddings import sparse as tsparse
from deeplearning4j_tpu_torch.embeddings import word2vec as tsw2v
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
from deeplearning4j_tpu_torch.nn.conf import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer,
    EmbeddingLayer,
    OutputLayer,
    SparseEmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DistributedTrainer
from deeplearning4j_tpu_torch.util import model_serializer as tser

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 180
FIT_RTOL, FIT_ATOL = 1e-4, 1e-6

# One rank of a scenario; argv[1] is a JSON spec.
_CHILD = r"""
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.parallel import (
    build_mesh, init_distributed, shutdown_distributed)

spec = json.loads(sys.argv[1])
init_distributed("file://" + spec["rdv"], spec["world"], spec["rank"],
                 device="cpu", timeout_s=120)
mesh = build_mesh(data=spec["world"])
data = dict(np.load(spec["data"]))
out = {}
kind = spec["scenario"]
if kind == "table":
    from deeplearning4j_tpu_torch.embeddings import ShardedEmbeddingTable
    t = ShardedEmbeddingTable.from_rows(data["rows"], mesh=mesh)
    out["lookup"] = t.lookup(data["ids2d"]).numpy()
    out["touched"] = np.asarray(t.apply_sparse_grads(
        data["ids"], data["grads"], float(data["lr"])))
    out["rows"] = t.to_host()
    out["shard_bytes"] = np.asarray(t.shard_bytes())
elif kind in ("w2v", "deepwalk"):
    corpus = json.loads(open(spec["corpus"]).read())
    if kind == "w2v":
        from deeplearning4j_tpu_torch.embeddings import ShardedWord2Vec
        from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
        cache = VocabConstructor(1).build_vocab_from_tokens(corpus)
        ids = [np.asarray([cache.index_of(w) for w in s], np.int32)
               for s in corpus]
        m = ShardedWord2Vec(cache, ids, mesh=mesh, **spec["kw"])
    else:
        from deeplearning4j_tpu_torch.embeddings import ShardedDeepWalk
        from deeplearning4j_tpu_torch.graph import Graph
        g = Graph(corpus["n"])
        for a, b in corpus["edges"]:
            g.add_edge(a, b)
        m = ShardedDeepWalk(mesh=mesh, **spec["kw"])
        m.initialize(g)
    if spec.get("restore"):
        m.restore(spec["restore"])
    if kind == "w2v":
        m.fit()
        out["syn0"] = m.lookup.t0.to_host()
        out["syn1neg"] = m.lookup.t1n.to_host()
    else:
        m.fit(g, walk_length=spec["walk"], epochs=spec["epochs"])
        out["syn0"] = m.lookup_table.t0.to_host()
        out["syn1"] = m.lookup_table.t1.to_host()
    if spec.get("save"):
        m.save(spec["save"])
elif kind == "sparse_layer":
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer
    conf = MultiLayerConfiguration.from_json(open(spec["corpus"]).read())
    net = MultiLayerNetwork(conf, device="cpu").init()
    try:
        DistributedTrainer(net, mesh=mesh)
        out["error"] = np.asarray("")
    except NotImplementedError as e:
        out["error"] = np.asarray(str(e))
np.savez(spec["out"], **out)
shutdown_distributed()
"""


def run_ranks(tmp_path, world, scenario, arrays=None, corpus=None, **opts):
    """Run ``_CHILD`` on ``world`` gloo ranks; returns each rank's
    results. A run past RANK_TIMEOUT_S kills every rank and fails."""
    run = tmp_path / f"run{len(list(tmp_path.glob('run*')))}"
    run.mkdir()
    np.savez(run / "data.npz", **(arrays or {"_": np.zeros(1)}))
    (run / "corpus.json").write_text(
        corpus if isinstance(corpus, str) else json.dumps(corpus))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        spec = dict(rank=r, world=world, rdv=str(run / "rdv"),
                    scenario=scenario, data=str(run / "data.npz"),
                    corpus=str(run / "corpus.json"),
                    out=str(run / f"out{r}.npz"), **opts)
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


def zipf_ids(rng, n, v):
    return (rng.zipf(1.3, n) - 1).clip(0, v - 1)


# -- sparse.py ------------------------------------------------------------


@pytest.mark.parametrize("n,v", [(1, 5), (64, 8), (500, 40), (300, 1000)])
def test_dedup_segment_sum_matches_jax(rng, n, v):
    ids = zipf_ids(rng, n, v).astype(np.int32)
    g = rng.randn(n, 6).astype(np.float32)
    ju, js, jn = jsparse.dedup_segment_sum(jnp.asarray(ids), jnp.asarray(g))
    tu, ts, tn = tsparse.dedup_segment_sum(torch.from_numpy(ids),
                                           torch.from_numpy(g))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol, atol)
    table = rng.randn(v, 6).astype(np.float32)
    want = jsparse.apply_rows_dense(jnp.asarray(table), ju, js, 0.25)
    got = tsparse.apply_rows_dense(torch.from_numpy(table.copy()), tu, ts,
                                   0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol, atol)
    fused = tsparse.sgd_rows_(torch.from_numpy(table.copy()),
                              torch.from_numpy(ids), torch.from_numpy(g),
                              0.25)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


def test_segment_sum_is_independent_of_the_occurrence_order(rng):
    """Duplicates are summed by sorted position: permuting equal ids'
    occurrences among themselves is the only freedom, and the result is
    one fixed tree — the same bits on every call."""
    ids = torch.from_numpy(zipf_ids(rng, 4000, 30))
    g = torch.from_numpy(rng.randn(4000, 16).astype(np.float32))
    runs = [tsparse.dedup_segment_sum(ids, g)[1] for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    want = torch.zeros(30, 16, dtype=torch.float64).index_add_(
        0, ids, g.double())
    u, s, n = tsparse.dedup_segment_sum(ids, g)
    np.testing.assert_allclose(s[:int(n)].numpy(),
                               want[u[:int(n)]].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (u[int(n):] == tsparse.PAD_ID).all()


def test_rows_grad_and_flatten_match_jax(rng):
    v = rng.randn(5, 4).astype(np.float32)
    u = rng.randn(5, 3, 4).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jnp.tanh(jnp.einsum("bd,bkd->bk", a, b)))

    def tloss(a, b):
        return torch.tanh(torch.einsum("bd,bkd->bk", a, b)).sum()

    jl, jg = jsparse.rows_grad(jloss, jnp.asarray(v), jnp.asarray(u))
    tl, tg = tsparse.rows_grad(tloss, torch.from_numpy(v),
                               torch.from_numpy(u))
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(float(tl), float(jl), rtol, atol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol, atol)
    ids = rng.randint(0, 9, (5, 3))
    ti, tr = tsparse.flatten_occurrences(torch.from_numpy(ids), tg[1])
    ji, jr = jsparse.flatten_occurrences(jnp.asarray(ids), jg[1])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tuple(tr.shape) == tuple(jr.shape)


# -- ShardedEmbeddingTable --------------------------------------------------


def _table_case(rng, v=37, d=5, n=120):
    return {"rows": rng.randn(v, d).astype(np.float32),
            "ids2d": rng.randint(0, v, (6, 7)),
            "ids": zipf_ids(rng, n, v),
            "grads": rng.randn(n, d).astype(np.float32),
            "lr": np.asarray(0.3)}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_table_equals_unsharded_bitwise(tmp_path, rng, world):
    case = _table_case(rng)
    res = run_ranks(tmp_path, world, "table", case)
    plain = torch.from_numpy(case["rows"].copy())
    want_lookup = plain[torch.from_numpy(case["ids2d"])].numpy()
    u, s, n = tsparse.dedup_segment_sum(torch.from_numpy(case["ids"]),
                                        torch.from_numpy(case["grads"]))
    tsparse.apply_rows_dense(plain, u, s, 0.3)
    for r in res:
        np.testing.assert_array_equal(r["lookup"], want_lookup)
        np.testing.assert_array_equal(r["rows"], plain.numpy())
        assert int(r["touched"]) == int(n)
        assert int(r["shard_bytes"]) == -(-37 // world) * 5 * 4


def test_sharded_table_in_one_process_and_its_gauges(rng):
    from deeplearning4j_tpu_torch.embeddings import table

    case = _table_case(rng)
    t = ShardedEmbeddingTable.from_rows(case["rows"], device="cpu")
    assert t.mesh.data == 1 and t.mesh.backend is None
    np.testing.assert_array_equal(t.lookup(case["ids2d"]).numpy(),
                                  case["rows"][case["ids2d"]])
    touched = t.apply_sparse_grads(case["ids"], case["grads"], 0.3)
    g = table.gauges()
    assert g["embedding_rows_touched"] == touched
    assert g["embedding_shard_bytes"] == t.shard_bytes() == 37 * 5 * 4
    assert g["embedding_lookup_ms"] and g["embedding_scatter_ms"]
    assert t.replicated_bytes() == t.shard_bytes()
    z = ShardedEmbeddingTable.zeros(4, 3, device="cpu")
    assert not z.to_host().any()
    with pytest.raises(ValueError, match="rows shape"):
        t.restore_rows(np.zeros((3, 5), np.float32))


def test_sharded_table_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEmbeddingTable(4, 3)


# -- ShardedWord2Vec ----------------------------------------------------------


def corpus_sentences(seed=0, n=150, length=10, vocab=50):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [[f"w{i}" for i in rng.choice(vocab, size=length, p=p)]
            for _ in range(n)]


W2V_KW = dict(layer_size=8, window=3, negative=4, batch_size=64, epochs=2,
              seed=3)


def _w2v_pair(sents, **kw):
    jc = JVocab(1).build_vocab_from_tokens(sents)
    tc = VocabConstructor(1).build_vocab_from_tokens(sents)
    ids = [np.asarray([jc.index_of(w) for w in s], np.int32) for s in sents]
    return (JShardedW2V(jc, ids, **{**W2V_KW, **kw}),
            ShardedWord2Vec(tc, ids, device="cpu", **{**W2V_KW, **kw}))


def test_sharded_word2vec_matches_jax_sharded_word2vec():
    j, t = _w2v_pair(corpus_sentences())
    np.testing.assert_array_equal(t.lookup.t0.to_host(),
                                  j.lookup.t0.to_host())
    j.fit()
    t.fit()
    for a, b in ((t.lookup.t0, j.lookup.t0), (t.lookup.t1n, j.lookup.t1n)):
        np.testing.assert_allclose(a.to_host(), b.to_host(), FIT_RTOL,
                                   FIT_ATOL)
    assert t.words_nearest("w2", 5) == j.words_nearest("w2", 5)


def test_sharded_word2vec_refuses_hs_and_cbow():
    for kw, match in ((dict(use_hierarchic_softmax=True), "negative"),
                      (dict(algorithm="CBOW"), "SkipGram")):
        with pytest.raises(ValueError, match=match):
            _w2v_pair(corpus_sentences(), **kw)


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_word2vec_at_ranks_equals_one_process(tmp_path, world):
    sents = corpus_sentences()
    _, t = _w2v_pair(sents)
    t.fit()
    res = run_ranks(tmp_path, world, "w2v", corpus=sents, kw=W2V_KW)
    for r in res:
        np.testing.assert_array_equal(r["syn0"], t.lookup.t0.to_host())
        np.testing.assert_array_equal(r["syn1neg"], t.lookup.t1n.to_host())


def test_sharded_word2vec_checkpoints_both_ways(tmp_path):
    """A JAX checkpoint restores in the port (one process and 2 ranks)
    and continues as the JAX trainer does; a port checkpoint restores
    in the JAX package bit for bit."""
    sents = corpus_sentences()
    j, t = _w2v_pair(sents, epochs=1)
    j.fit()
    j.save(str(tmp_path / "j.npz"))
    t.restore(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(t.lookup.t0.to_host(),
                                  j.lookup.t0.to_host())
    np.testing.assert_array_equal(t.lookup.t1n.to_host(),
                                  j.lookup.t1n.to_host())
    t.save(str(tmp_path / "t.npz"))
    j2, _ = _w2v_pair(sents, epochs=1)
    j2.restore(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(j2.lookup.t0.to_host(),
                                  j.lookup.t0.to_host())
    res = run_ranks(tmp_path, 2, "w2v", corpus=sents,
                    kw={**W2V_KW, "epochs": 1},
                    restore=str(tmp_path / "j.npz"),
                    save=str(tmp_path / "ranks.npz"))
    j.fit()
    t.fit()
    for r in res:
        np.testing.assert_array_equal(r["syn0"], t.lookup.t0.to_host())
    np.testing.assert_allclose(t.lookup.t0.to_host(), j.lookup.t0.to_host(),
                               FIT_RTOL, FIT_ATOL)
    j3, _ = _w2v_pair(sents, epochs=1)
    j3.restore(str(tmp_path / "ranks.npz"))
    np.testing.assert_array_equal(j3.lookup.t0.to_host(), res[0]["syn0"])
    with pytest.raises(ValueError, match="do not match"):
        _w2v_pair(sents, epochs=2)[1].restore(str(tmp_path / "t.npz"))


def test_sharded_word2vec_killed_mid_epoch_resumes_exactly(tmp_path):
    sents = corpus_sentences()
    path = str(tmp_path / "ck.npz")
    _, whole = _w2v_pair(sents)
    whole.fit()

    class Killed(Exception):
        pass

    _, dying = _w2v_pair(sents, checkpoint_path=path, checkpoint_every=3)
    real = dying._apply_batch
    calls = {"n": 0}

    def apply(*a):
        calls["n"] += 1
        if calls["n"] == 8:
            raise Killed()
        real(*a)

    dying._apply_batch = apply
    with pytest.raises(Killed):
        dying.fit()
    _, resumed = _w2v_pair(sents)
    resumed.restore(path)
    assert resumed._fit_step == 6 and resumed._fit_epoch == 0
    resumed.fit()
    np.testing.assert_array_equal(resumed.lookup.t0.to_host(),
                                  whole.lookup.t0.to_host())
    np.testing.assert_array_equal(resumed.lookup.t1n.to_host(),
                                  whole.lookup.t1n.to_host())


def test_out_of_range_ids_are_quarantined():
    _, t = _w2v_pair(corpus_sentences())
    before = t.lookup.t1n.to_host()
    count = tsw2v.QUARANTINED["label_range"]
    v = len(t.cache)
    mask = np.ones(64, np.float32)
    bad = np.arange(64) % v
    bad[5] = v + 3
    t._apply_batch(bad, np.arange(64) % v, mask, 0.1, 0)
    t._apply_batch(np.arange(64) % v, -np.ones(64, np.int64), mask, 0.1, 1)
    assert t._quarantined == 2
    assert tsw2v.QUARANTINED["label_range"] == count + 2
    np.testing.assert_array_equal(t.lookup.t1n.to_host(), before)
    mask[5] = 0.0  # a dead slot may hold anything
    t._apply_batch(bad, np.arange(64) % v, mask, 0.1, 2)
    assert t._quarantined == 2
    assert not np.array_equal(t.lookup.t1n.to_host(), before)


# -- EmbeddingLayer / SparseEmbeddingLayer --------------------------------


def _emb_conf(builder, emb, dense, out, sparse=None, **kw):
    layer = sparse if sparse is not None else emb
    return (builder().seed(7).learning_rate(0.05).updater("ADAM").list()
            .layer(layer(n_in=40, n_out=6, **kw))
            .layer(dense(n_in=6, n_out=8, activation="tanh"))
            .layer(out(n_in=8, n_out=3))
            .build())


def _emb_batch(rng, n=32):
    x = rng.randint(0, 40, (n, 1)).astype(np.float32)
    x[:4] = 7  # duplicates
    y = np.eye(3, dtype=np.float32)[x[:, 0].astype(np.int64) % 3]
    return x, y


@pytest.mark.parametrize("sparse", [False, True])
def test_embedding_layer_output_grads_and_training_match_jax(rng, sparse):
    jconf = _emb_conf(JConf.Builder, JEmbedding, JDense, JOutput,
                      JSparseEmb if sparse else None)
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert type(tconf.layers[0]) is (SparseEmbeddingLayer if sparse
                                     else EmbeddingLayer)
    jnet = JNet(jconf).init()
    params = {f"{ln}/{pn}": np.asarray(a) for ln, lp in jnet.params.items()
              for pn, a in lp.items()}
    tnet = MultiLayerNetwork(tconf, device="cpu").init(
        params=tser.params_from_numpy(params, "cpu"))
    x, y = _emb_batch(rng)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol, atol)
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet

    jscores, tscores = [], []
    for i in range(3):
        xb, yb = _emb_batch(np.random.RandomState(i))
        jnet.fit(JDataSet(xb, yb))
        jscores.append(float(jnet.score_value))
        tscores.append(float(tnet.fit_minibatch(DataSet(xb, yb))))
    np.testing.assert_allclose(tscores, jscores, FIT_RTOL, FIT_ATOL)
    for ln, lp in jnet.params.items():
        for pn, a in lp.items():
            np.testing.assert_allclose(tnet.params[ln][pn].numpy(),
                                       np.asarray(a), FIT_RTOL, FIT_ATOL,
                                       err_msg=f"{ln}/{pn}")


def test_embedding_layer_gradient_matches_jax_on_one_step(rng):
    """dL/dW of the embedding table: zero on the rows no index touched,
    duplicates summed, equal to JAX's ``jax.grad`` of the score."""
    import jax

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import core

    jconf = _emb_conf(JConf.Builder, JEmbedding, JDense, JOutput)
    jnet = JNet(jconf).init()
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    params = {f"{ln}/{pn}": np.asarray(a) for ln, lp in jnet.params.items()
              for pn, a in lp.items()}
    x, y = _emb_batch(rng)

    def jscore(p):
        out = jnet._score_pure(p, jnet.state, jnp.asarray(x),
                               jnp.asarray(y), None, None, train=True)
        return out[0] if isinstance(out, tuple) else out

    jg = jax.grad(jscore)(jnet.params)
    tnet = MultiLayerNetwork(tconf, device="cpu").init(
        params=tser.params_from_numpy(params, "cpu"))
    xt, yt, _, _ = tnet.batch_tensors(DataSet(x, y))
    _, grads = core.grad_step(
        lambda p, s, a, b, m, f, rng: tnet._score_pure(
            p, s, a, b, m, train=True, fmask=f, rng=rng),
        tnet.params, tnet.state, xt, yt, None, None)
    name = tnet.layer_names[0]
    w = grads[name]["W"].numpy()
    untouched = np.setdiff1d(np.arange(40), x[:, 0].astype(np.int64))
    assert not w[untouched].any() and w[7].any()
    rtol, atol = kernel_tols()
    for ln, lp in grads.items():
        for pn, g in lp.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[ln][pn]),
                                       rtol, atol, err_msg=f"{ln}/{pn}")


def test_embedding_layer_checkpoints_both_ways(tmp_path, rng):
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet

    jconf = _emb_conf(JConf.Builder, JEmbedding, JDense, JOutput)
    jnet = JNet(jconf).init()
    x, y = _emb_batch(rng)
    jnet.fit(JDataSet(x, y))
    jser.write_model(jnet, str(tmp_path / "j.zip"))
    tnet = tser.restore_multi_layer_network(tmp_path / "j.zip", device="cpu")
    assert isinstance(tnet.conf.layers[0], EmbeddingLayer)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), 2e-4, 2e-5)
    tnet.fit_minibatch(DataSet(x, y))
    tser.write_model(tnet, tmp_path / "t.zip")
    back = jser.restore_multi_layer_network(str(tmp_path / "t.zip"))
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               tnet.output(x).numpy(), 2e-4, 2e-5)
    assert back.iteration_count == tnet.iteration_count == 2
    with zipfile.ZipFile(tmp_path / "t.zip") as zf:
        doc = json.loads(zf.read("configuration.json"))
    assert doc["configuration"]["layers"][0]["@class"] == "EmbeddingLayer"


def test_sparse_embedding_layer_json_round_trips_with_jax():
    jconf = _emb_conf(JConf.Builder, JEmbedding, JDense, JOutput, JSparseEmb,
                      row_sharded=False)
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert tconf.layers[0].row_sharded is False
    again = type(jconf).from_json(tconf.to_json())
    assert again.layers[0] == jconf.layers[0]


def test_sparse_embedding_layer_row_sharded_refuses_several_ranks(tmp_path):
    """The JAX trainer's row-sharded branch is not ported: two ranks
    refuse ``row_sharded=True`` naming the ROADMAP item; one rank, or
    ``row_sharded=False``, trains as the base layer."""
    sharded = _emb_conf(NeuralNetConfiguration.Builder, EmbeddingLayer,
                        DenseLayer, OutputLayer, SparseEmbeddingLayer)
    plain = _emb_conf(NeuralNetConfiguration.Builder, EmbeddingLayer,
                      DenseLayer, OutputLayer, SparseEmbeddingLayer,
                      row_sharded=False)
    res = run_ranks(tmp_path, 2, "sparse_layer", corpus=sharded.to_json())
    assert all("row-sharded" in str(r["error"]) and "ROADMAP" in
               str(r["error"]) for r in res)
    res = run_ranks(tmp_path, 2, "sparse_layer", corpus=plain.to_json())
    assert all(str(r["error"]) == "" for r in res)
    from deeplearning4j_tpu_torch.datasets import DataSet

    x, y = _emb_batch(np.random.RandomState(1))
    one = MultiLayerNetwork(sharded, device="cpu").init()
    base = MultiLayerNetwork(plain, device="cpu").init()
    s1 = float(DistributedTrainer(one).fit_minibatch(DataSet(x, y)))
    s2 = float(base.fit_minibatch(DataSet(x, y)))
    assert s1 == s2
    for ln, lp in one.params.items():
        for pn, t in lp.items():
            assert torch.equal(t, base.params[ln][pn])


def test_embedding_layer_reads_integer_ids_of_any_width(rng):
    conf = _emb_conf(NeuralNetConfiguration.Builder, EmbeddingLayer,
                     DenseLayer, OutputLayer)
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, _ = _emb_batch(rng)
    want = net.output(x)
    for dt in (np.int64, np.int32, np.uint8):
        assert torch.equal(net.output(x.astype(dt)), want)

"""The port's graph embeddings (``deeplearning4j_tpu_torch/graph`` and
``embeddings/deepwalk.py``) against the JAX package's, on the CPU.

Walks, the degree-based Huffman tree and the single-pair lookup-table
contract are host numpy and must agree exactly. Tolerances: a DeepWalk
or ``ShardedDeepWalk`` fit from the same tables within rtol 1e-4, atol
1e-6 (the same batched updates, duplicates summed in another order);
the single-pair ``vectors_and_gradients`` / ``iterate`` within
``kernel_tols()``; ``ShardedDeepWalk`` checkpoints restore bit for bit
in either package, and at 2 gloo ranks equal one process bit for bit.
"""

import numpy as np
import pytest

from conftest import kernel_tols
from deeplearning4j_tpu.embeddings import ShardedDeepWalk as JShardedDW
from deeplearning4j_tpu.graph import api as japi
from deeplearning4j_tpu.graph import deepwalk as jdw
from deeplearning4j_tpu.graph import graph as jgraph
from deeplearning4j_tpu.graph import walks as jwalks
from deeplearning4j_tpu_torch.embeddings import ShardedDeepWalk
from deeplearning4j_tpu_torch.graph import api as tapi
from deeplearning4j_tpu_torch.graph import deepwalk as tdw
from deeplearning4j_tpu_torch.graph import graph as tgraph
from deeplearning4j_tpu_torch.graph import walks as twalks
from test_torch_embeddings import run_ranks

FIT_RTOL, FIT_ATOL = 1e-4, 1e-6


def edges(seed=0, n=40, m=120):
    rng = np.random.RandomState(seed)
    out = set()
    while len(out) < m:
        a, b = rng.randint(0, n, 2)
        if a != b:
            out.add((min(a, b), max(a, b)))
    return n, sorted(out)


def make_graph(mod, n, es, weighted=False):
    g = mod.Graph(n)
    for i, (a, b) in enumerate(es):
        g.add_edge(int(a), int(b), weight=1.0 + (i % 3) if weighted else 1.0)
    return g


@pytest.fixture(scope="module")
def graphs():
    n, es = edges()
    return n, es, make_graph(jgraph, n, es), make_graph(tgraph, n, es)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["SELF_LOOP_ON_DISCONNECTED",
                                  "EXCEPTION_ON_DISCONNECTED"])
def test_walks_equal_jax(weighted, mode):
    n, es = edges(1, n=30, m=60)
    jg, tg = make_graph(jgraph, n, es, weighted), make_graph(tgraph, n, es,
                                                             weighted)
    starts = np.random.RandomState(2).permutation(n).astype(np.int32)
    np.testing.assert_array_equal(
        tgraph.generate_random_walks(tg, 9, starts, 5,
                                     getattr(tapi.NoEdgeHandling, mode),
                                     weighted),
        jgraph.generate_random_walks(jg, 9, starts, 5,
                                     getattr(japi.NoEdgeHandling, mode),
                                     weighted))
    tcls = (twalks.WeightedRandomWalkIterator if weighted
            else twalks.RandomWalkIterator)
    jcls = (jwalks.WeightedRandomWalkIterator if weighted
            else jwalks.RandomWalkIterator)
    ti, ji = tcls(tg, 6, seed=3), jcls(jg, 6, seed=3)
    for _ in range(2):  # reset draws the next epoch's walks
        assert ([s.indices() for s in ti] == [s.indices() for s in ji])
        ti.reset()
        ji.reset()


def test_walk_providers_and_graph_queries_equal_jax(graphs):
    n, es, jg, tg = graphs
    np.testing.assert_array_equal(tg.degrees(), jg.degrees())
    for a, b in zip(tg.csr(), jg.csr()):
        np.testing.assert_array_equal(a, b)
    tp = twalks.RandomWalkGraphIteratorProvider(tg, 5, seed=4)
    jp = jwalks.RandomWalkGraphIteratorProvider(jg, 5, seed=4)
    for ti, ji in zip(tp.get_graph_walk_iterators(3),
                      jp.get_graph_walk_iterators(3)):
        np.testing.assert_array_equal(ti.walks_array(), ji.walks_array())
    lone = tgraph.Graph(3)
    lone.add_edge(0, 1)
    with pytest.raises(tapi.NoEdgesException):
        tgraph.generate_random_walks(
            lone, 3, np.arange(3), 0,
            tapi.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)


def test_graph_huffman_equals_jax(graphs):
    _, _, jg, tg = graphs
    th, jh = tdw.GraphHuffman(tg.degrees()), jdw.GraphHuffman(jg.degrees())
    for name in ("codes", "points", "lengths"):
        np.testing.assert_array_equal(getattr(th, name), getattr(jh, name))
    for v in (0, 5, 39):
        assert th.get_code(v) == jh.get_code(v)
        assert th.get_path_inner_nodes(v) == jh.get_path_inner_nodes(v)
        assert th.get_code_length(v) == jh.get_code_length(v)


def test_single_pair_contract_matches_jax(graphs):
    _, _, jg, tg = graphs
    jt = jdw.InMemoryGraphLookupTable(
        40, 6, jdw.GraphHuffman(jg.degrees()), 0.1, seed=3)
    tt = tdw.InMemoryGraphLookupTable(
        40, 6, tdw.GraphHuffman(tg.degrees()), 0.1, seed=3, device="cpu")
    np.testing.assert_array_equal(tt.get_vertex_vectors(),
                                  jt.get_vertex_vectors())
    rtol, atol = kernel_tols()
    tv, tgr = tt.vectors_and_gradients(2, 9)
    jv, jgr = jt.vectors_and_gradients(2, 9)
    for a, b in zip(tv + tgr, jv + jgr):
        np.testing.assert_allclose(a, b, rtol, atol)
    for first, second in ((2, 9), (9, 2), (4, 4)):
        tt.iterate(first, second)
        jt.iterate(first, second)
    np.testing.assert_allclose(tt.get_vertex_vectors(),
                               jt.get_vertex_vectors(), rtol, atol)
    np.testing.assert_allclose(tt.out_weights.numpy(),
                               np.asarray(jt.out_weights), rtol, atol)


def test_batch_update_step_matches_jax(graphs, rng):
    _, _, jg, tg = graphs
    jt = jdw.InMemoryGraphLookupTable(
        40, 6, jdw.GraphHuffman(jg.degrees()), 0.1, seed=3)
    tt = tdw.InMemoryGraphLookupTable(
        40, 6, tdw.GraphHuffman(tg.degrees()), 0.1, seed=3, device="cpu")
    c, o = rng.randint(0, 40, 128), rng.randint(0, 40, 128)
    rtol, atol = kernel_tols()
    assert tt.batch_update(c, o, 0.05) == pytest.approx(
        jt.batch_update(c, o, 0.05), rel=rtol)
    np.testing.assert_allclose(tt.get_vertex_vectors(),
                               jt.get_vertex_vectors(), rtol, atol)
    np.testing.assert_allclose(tt.out_weights.numpy(),
                               np.asarray(jt.out_weights), rtol, atol)


@pytest.mark.parametrize("route", ["fit", "fit_walks", "fit_iterator"])
def test_deepwalk_fit_matches_jax(graphs, route):
    _, _, jg, tg = graphs
    kw = dict(vector_size=8, window_size=2, learning_rate=0.05, seed=11,
              batch_size=64)
    j, t = jdw.DeepWalk(**kw), tdw.DeepWalk(device="cpu", **kw)
    j.initialize(jg)
    t.initialize(tg)
    if route == "fit":
        j.fit(jg, walk_length=6, epochs=2)
        t.fit(tg, walk_length=6, epochs=2)
    elif route == "fit_walks":
        walks = jgraph.generate_random_walks(jg, 6, np.arange(40), 1)
        assert t.fit_walks(walks) == pytest.approx(j.fit_walks(walks),
                                                   rel=FIT_RTOL)
    else:
        j.fit_iterator(jwalks.RandomWalkIterator(jg, 6, seed=2))
        t.fit_iterator(twalks.RandomWalkIterator(tg, 6, seed=2))
    np.testing.assert_allclose(t.lookup_table.get_vertex_vectors(),
                               j.lookup_table.get_vertex_vectors(),
                               FIT_RTOL, FIT_ATOL)
    assert t.vertices_nearest(3, 5) == j.vertices_nearest(3, 5)
    assert t.similarity(1, 2) == pytest.approx(j.similarity(1, 2), rel=1e-4)


def test_deepwalk_builder_and_short_walk_refusal(graphs):
    _, _, _, tg = graphs
    t = (tdw.DeepWalk.Builder().vector_size(4).window_size(3).seed(1)
         .learning_rate(0.1).batch_size(16).device("cpu").build())
    with pytest.raises(RuntimeError, match="not initialized"):
        t.fit_walks(np.zeros((2, 9), np.int32))
    t.initialize(tg)
    with pytest.raises(ValueError, match="no skip-gram pairs"):
        t.fit_walks(np.zeros((2, 5), np.int32))
    assert t.get_vector_size() == 4 and t.num_vertices() == 40


DW_KW = dict(vector_size=8, window_size=2, learning_rate=0.05, seed=11,
             batch_size=64)


def test_sharded_deepwalk_matches_jax_and_refuses_single_pairs(graphs):
    _, _, jg, tg = graphs
    j, t = JShardedDW(**DW_KW), ShardedDeepWalk(device="cpu", **DW_KW)
    j.initialize(jg)
    t.initialize(tg)
    j.fit(jg, walk_length=6, epochs=2)
    t.fit(tg, walk_length=6, epochs=2)
    for a, b in ((t.lookup_table.t0, j.lookup_table.t0),
                 (t.lookup_table.t1, j.lookup_table.t1)):
        np.testing.assert_allclose(a.to_host(), b.to_host(), FIT_RTOL,
                                   FIT_ATOL)
    np.testing.assert_array_equal(t.lookup_table.get_vector(3),
                                  t.lookup_table.get_vertex_vectors()[3])
    with pytest.raises(NotImplementedError):
        t.lookup_table.iterate(0, 1)
    with pytest.raises(NotImplementedError):
        t.lookup_table.vectors_and_gradients(0, 1)


def test_sharded_deepwalk_checkpoints_both_ways_and_resume(tmp_path,
                                                           graphs):
    """fit(1) + save + restore + fit(1) walks the ground of fit(2); a JAX
    checkpoint restores in the port and a port checkpoint in JAX, bit
    for bit; 2 gloo ranks restoring the same checkpoint equal one
    process."""
    n, es, jg, tg = graphs
    whole = ShardedDeepWalk(device="cpu", **DW_KW)
    whole.fit(tg, walk_length=6, epochs=2)
    first = ShardedDeepWalk(device="cpu", **DW_KW)
    first.fit(tg, walk_length=6, epochs=1)
    first.save(str(tmp_path / "t.npz"))
    resumed = ShardedDeepWalk(device="cpu", **DW_KW)
    resumed.restore(str(tmp_path / "t.npz"))
    assert resumed._epochs_done == 1
    resumed.fit(tg, walk_length=6, epochs=1)
    np.testing.assert_array_equal(resumed.lookup_table.t0.to_host(),
                                  whole.lookup_table.t0.to_host())
    j = JShardedDW(**DW_KW)
    j.restore(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(j.lookup_table.t0.to_host(),
                                  first.lookup_table.t0.to_host())
    j.fit(jg, walk_length=6, epochs=1)
    j.save(str(tmp_path / "j.npz"))
    back = ShardedDeepWalk(device="cpu", **DW_KW)
    back.restore(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(back.lookup_table.t1.to_host(),
                                  j.lookup_table.t1.to_host())
    np.testing.assert_allclose(back.lookup_table.t0.to_host(),
                               whole.lookup_table.t0.to_host(), FIT_RTOL,
                               FIT_ATOL)
    res = run_ranks(tmp_path, 2, "deepwalk",
                    corpus={"n": n, "edges": [list(map(int, e))
                                              for e in es]},
                    kw=DW_KW, restore=str(tmp_path / "t.npz"), walk=6,
                    epochs=1)
    for r in res:
        np.testing.assert_array_equal(r["syn0"],
                                      whole.lookup_table.t0.to_host())
        np.testing.assert_array_equal(r["syn1"],
                                      whole.lookup_table.t1.to_host())
    with pytest.raises(ValueError, match="do not match"):
        ShardedDeepWalk(device="cpu", **{**DW_KW, "seed": 1}).restore(
            str(tmp_path / "t.npz"))

"""The port's clustering (``deeplearning4j_tpu_torch/clustering``) on the
CPU: one counterpart of each test of ``tests/test_clustering.py`` for
what is ported (k-means, the KD-tree, the VP-tree; the SP tree, quad
tree and t-SNE wait for ``plot/``), and each module held against the
JAX package on the same seeded inputs.

Tolerances: the trees are the same host numpy code, so their neighbours
and distances are equal exactly; k-means starts from the same k-means++
centers (the same ``RandomState`` stream) and its Lloyd steps sum in
another order (torch against XLA), so its centers agree within
``kernel_tols()`` (f32: rtol 2e-4, atol 2e-5) and its assignments
exactly (the blobs leave no row near a tie)."""

import numpy as np
import pytest
import torch

from conftest import kernel_tols
from deeplearning4j_tpu.clustering import KDTree as JKDTree
from deeplearning4j_tpu.clustering import KMeansClustering as JKMeans
from deeplearning4j_tpu.clustering import VPTree as JVPTree
from deeplearning4j_tpu_torch.clustering import (
    ClusterSet,
    KDTree,
    KMeansClustering,
    Point,
    VPTree,
)
from deeplearning4j_tpu_torch.clustering import kmeans as tkmeans


def _three_blobs(n_per=30, seed=0):
    rng = np.random.RandomState(seed)
    centers = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    pts = np.concatenate([
        c + 0.5 * rng.randn(n_per, 2) for c in centers
    ])
    labels = np.repeat(np.arange(3), n_per)
    return pts.astype(np.float32), labels


def _blobs(n, d, k, seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d).astype(np.float32) * 8.0
    lab = rng.randint(0, k, n)
    return (centers[lab] + rng.randn(n, d).astype(np.float32)), lab


class TestKMeans:
    def test_recovers_blobs(self):
        x, labels = _three_blobs()
        km = KMeansClustering.setup(3, 50, "euclidean", seed=3,
                                    device="cpu")
        cs = km.apply_to(x)
        assert cs.get_cluster_count() == 3
        sizes = sorted(len(c.points) for c in cs.get_clusters())
        assert sizes == [30, 30, 30]

    def test_convergence_mode_stops_early(self):
        x, _ = _three_blobs()
        km = KMeansClustering.setup_convergence(3, 1e-4, seed=3,
                                                device="cpu")
        km.apply_to(x)
        assert km.iteration_count < 1000

    def test_classify_point(self):
        x, _ = _three_blobs()
        km = KMeansClustering.setup(3, 20, seed=1, device="cpu")
        cs = km.apply_to(x)
        pc = cs.classify_point(Point("q", np.array([10.0, 0.5])))
        assert np.linalg.norm(
            pc.cluster.center.array - np.array([10.0, 0.0])
        ) < 1.0

    def test_unknown_distance_raises(self):
        with pytest.raises(ValueError, match="unknown distance"):
            KMeansClustering.setup(2, 5, "hamming", device="cpu")

    def test_manhattan_and_cosine(self):
        x, _ = _three_blobs()
        for dist in ("manhattan", "cosinesimilarity"):
            cs = KMeansClustering.setup(3, 20, dist, seed=5,
                                        device="cpu").apply_to(x)
            assert cs.get_cluster_count() == 3


@pytest.mark.parametrize("distance", ["euclidean", "manhattan",
                                      "cosinesimilarity"])
def test_kmeans_matches_jax(distance):
    """The same seeded blobs, seed and iteration count: centers within
    ``kernel_tols()``, every assignment equal."""
    x, _ = _blobs(600, 16, 6, seed=4)
    want = JKMeans.setup(6, 8, distance, seed=9).apply_to(x)
    got = KMeansClustering.setup(6, 8, distance, seed=9,
                                 device="cpu").apply_to(x)
    rtol, atol = kernel_tols()
    np.testing.assert_allclose(got.centers(), want.centers(), rtol, atol)
    for a, b in zip(got.get_clusters(), want.get_clusters()):
        assert [p.id for p in a.points] == [p.id for p in b.points]


def test_kmeans_convergence_matches_jax_iterations():
    x, _ = _blobs(400, 8, 4, seed=2)
    j = JKMeans.setup_convergence(4, 1e-4, seed=3)
    j.apply_to(x)
    t = KMeansClustering.setup_convergence(4, 1e-4, seed=3, device="cpu")
    t.apply_to(x)
    assert t.iteration_count == j.iteration_count


def test_kmeans_blocks_of_rows_give_the_whole_distance(monkeypatch):
    """The row blocks of the distance matrix change no entry: a tiny
    block gives the one-block step bit for bit."""
    x, _ = _blobs(300, 8, 5, seed=1)
    xt = torch.from_numpy(x)
    c = xt[:5].clone()
    whole = tkmeans.lloyd_step(xt, c, 5, "euclidean")
    monkeypatch.setattr(tkmeans, "_BLOCK_ELEMS", 7 * 5 * 8)
    blocked = tkmeans.lloyd_step(xt, c, 5, "euclidean")
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_kmeans_without_empty_clusters_drops_them():
    x = np.zeros((6, 2), np.float32)
    x[3:] = 5.0
    km = KMeansClustering(4, 3, allow_empty_clusters=False, device="cpu")
    cs = km.apply_to(x)
    assert isinstance(cs, ClusterSet) and all(c.points for c in
                                              cs.get_clusters())
    assert cs.get_cluster_count() == 2


def test_kmeans_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KMeansClustering.setup(2, 5)


class TestKDTree:
    def test_knn_matches_bruteforce(self):
        rng = np.random.RandomState(7)
        pts = rng.randn(200, 3)
        tree = KDTree(3)
        for p in pts:
            tree.insert(p)
        q = rng.randn(3)
        res = tree.knn(q, 5)
        brute = np.sort(np.linalg.norm(pts - q, axis=1))[:5]
        np.testing.assert_allclose(
            [d for d, _ in res], brute, rtol=1e-10
        )

    def test_nn(self):
        tree = KDTree(2)
        tree.insert([0.0, 0.0])
        tree.insert([5.0, 5.0])
        d, p = tree.nn([4.9, 5.1])
        np.testing.assert_allclose(p, [5.0, 5.0])

    def test_dim_mismatch_raises(self):
        tree = KDTree(2)
        with pytest.raises(ValueError):
            tree.insert([1.0, 2.0, 3.0])


def test_kdtree_neighbours_equal_jax():
    rng = np.random.RandomState(13)
    pts = rng.randn(150, 4)
    trees = (KDTree(4), JKDTree(4))
    for p in pts:
        for t in trees:
            t.insert(p)
    for q in rng.randn(5, 4):
        a, b = (t.knn(q, 6) for t in trees)
        assert [d for d, _ in a] == [d for d, _ in b]
        for (_, pa), (_, pb) in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


class TestVPTree:
    def test_knn_matches_bruteforce_euclidean(self):
        rng = np.random.RandomState(11)
        pts = rng.randn(300, 8)
        tree = VPTree(pts)
        q = rng.randn(8)
        idx, dist = tree.search(q, 7)
        brute_order = np.argsort(np.linalg.norm(pts - q, axis=1))[:7]
        assert set(idx) == set(brute_order.tolist())

    def test_cosine(self):
        pts = np.array([[1.0, 0.0], [0.0, 1.0], [0.9, 0.1], [-1.0, 0.0]])
        tree = VPTree(pts, "cosinesimilarity")
        idx, _ = tree.search(np.array([1.0, 0.05]), 2)
        assert set(idx) == {0, 2}

    def test_bad_similarity_raises(self):
        with pytest.raises(ValueError, match="unknown similarity"):
            VPTree(np.zeros((3, 2)), "chebyshev")


@pytest.mark.parametrize("sim", ["euclidean", "cosinesimilarity"])
def test_vptree_neighbours_equal_jax(sim):
    rng = np.random.RandomState(17)
    pts = rng.randn(250, 6)
    a, b = VPTree(pts, sim, seed=3), JVPTree(pts, sim, seed=3)
    for q in rng.randn(5, 6):
        ia, da = a.search(q, 8)
        ib, db = b.search(q, 8)
        assert list(ia) == list(ib)
        np.testing.assert_array_equal(da, db)

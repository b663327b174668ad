"""The port's t-SNE (``deeplearning4j_tpu_torch/plot``) and Barnes-Hut
trees (``clustering/sptree.py``, ``clustering/quadtree.py``) against the
JAX package's, on the CPU.

Exact t-SNE runs its iterations as torch ops (here on the CPU), JAX's
as one jitted XLA program: the same f32 arithmetic with sums in other
orders, about 1e-7 of scale a step. The gains' sign test makes the
trajectory chaotic (two runs 1e-7 apart at iteration 1 are 1e-3 apart
by iteration 10), so the whole fit is held over its first 5 iterations,
and each step over 60 (across the lie switch at 20 and the momentum
switch at 40) from JAX's own state: y and its increment within 1e-5 of
y's scale, the gains equal, the KL within rtol 1e-5. The joint P, Barnes-Hut t-SNE and
the trees are host numpy in both packages: bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deeplearning4j_tpu.clustering.quadtree import QuadTree as JQuadTree
from deeplearning4j_tpu.clustering.sptree import SPTree as JSPTree
from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu_torch.clustering import QuadTree, SPTree
from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne
from deeplearning4j_tpu_torch.plot import tsne as ptsne

Y_REL = 1e-5
KL_RTOL = 1e-5


def _clusters(n_per=16, k=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(n_per, d) + 4 * c for c in range(k)])


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_exact_fit_matches_jax_over_its_first_iterations():
    x = _clusters()
    kw = dict(max_iter=5, perplexity=10.0)
    ref = jtsne.Tsne(**kw)
    got = Tsne(device="cpu", **kw)
    y = got.fit(x)
    assert y.dtype == np.float32 and y.shape == (64, 2)
    assert _rel(y, ref.fit(x)) < Y_REL
    np.testing.assert_allclose(got.kl, ref.kl, rtol=KL_RTOL)


def test_joint_p_is_the_jax_packages_bitwise():
    x = _clusters(seed=3)
    np.testing.assert_array_equal(Tsne(perplexity=10.0)._joint_p(x),
                                  jtsne.Tsne(perplexity=10.0)._joint_p(x))


def test_each_step_across_the_lie_and_momentum_switches_matches_jax():
    x = _clusters()
    p = jtsne.Tsne(perplexity=10.0)._joint_p(x)
    rng = np.random.RandomState(12345)
    y = (rng.randn(64, 2) * 1e-4).astype(np.float32)
    y_inc, gains = np.zeros_like(y), np.ones_like(y)
    for it in range(60):
        cur = (p * (4.0 if it < 20 else 1.0)).astype(np.float32)
        mom = 0.5 if it < 40 else 0.8
        ref = jtsne._tsne_step(jnp.asarray(cur), jnp.asarray(y),
                               jnp.asarray(y_inc), jnp.asarray(gains),
                               jnp.float32(mom), jnp.float32(200.0))
        got = ptsne._tsne_step(torch.from_numpy(cur), torch.from_numpy(y),
                               torch.from_numpy(y_inc),
                               torch.from_numpy(gains), mom, 200.0,
                               want_kl=True)
        ry, ri, rg, rkl = (np.asarray(a) for a in ref)
        assert _rel(got[0].numpy(), ry) < Y_REL, it
        # the step's increment, against the scale of y it moves
        assert np.abs(got[1].numpy() - ri).max() < Y_REL * np.abs(ry).max()
        np.testing.assert_array_equal(got[2].numpy(), rg)
        np.testing.assert_allclose(float(got[3]), float(rkl), rtol=KL_RTOL)
        y, y_inc, gains = ry.copy(), ri.copy(), rg.copy()


def test_kl_is_read_once_at_the_end_and_falls_after_the_lie(monkeypatch):
    x = _clusters(n_per=8)
    asked = []
    step = ptsne._tsne_step

    def spy(*args, want_kl=False):
        asked.append(want_kl)
        return step(*args, want_kl=want_kl)

    monkeypatch.setattr(ptsne, "_tsne_step", spy)
    kw = dict(device="cpu", perplexity=5.0, stop_lying_iteration=10)
    t = Tsne(max_iter=60, **kw)
    t.fit(x)
    assert asked == [False] * 59 + [True]
    # the KL of the first step on the true P, from a second fit cut there
    after_lie = Tsne(max_iter=t.stop_lying_iteration + 1, **kw)
    after_lie.fit(x)
    assert np.isfinite(t.kl) and after_lie.kl > t.kl


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_exact_tsne_defaults_to_the_card_and_never_takes_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tsne(max_iter=1).fit(_clusters(n_per=4))


def test_barnes_hut_tsne_is_the_jax_packages_bitwise():
    x = _clusters(n_per=10, seed=2)
    kw = dict(theta=0.5, perplexity=5.0, max_iter=25,
              stop_lying_iteration=10, switch_momentum_iteration=15)
    np.testing.assert_array_equal(BarnesHutTsne(**kw).fit(x),
                                  jtsne.BarnesHutTsne(**kw).fit(x))


@pytest.mark.parametrize("dims", [2, 3])
def test_sptree_forces_are_the_jax_packages_bitwise(dims):
    rng = np.random.RandomState(dims)
    y = rng.randn(50, dims)
    y[7] = y[3]  # a duplicate point
    tree, ref = SPTree(y), JSPTree(y)
    assert tree.cum_size == ref.cum_size == 50
    for i in range(50):
        a, b = np.zeros(dims), np.zeros(dims)
        assert tree.compute_non_edge_forces(i, 0.5, a) == \
            ref.compute_non_edge_forces(i, 0.5, b)
        np.testing.assert_array_equal(a, b)
    rows = np.arange(0, 151, 3)
    cols = rng.randint(0, 50, 150)
    vals = rng.rand(150)
    a, b = np.zeros_like(y), np.zeros_like(y)
    SPTree.compute_edge_forces(y, rows, cols, vals, a)
    JSPTree.compute_edge_forces(y, rows, cols, vals, b)
    np.testing.assert_array_equal(a, b)


def test_quadtree_is_the_jax_packages_bitwise():
    rng = np.random.RandomState(4)
    y = rng.randn(80, 2)
    y[10] = y[11] = y[12]  # duplicates
    tree, ref = QuadTree(y), JQuadTree(y)
    assert tree.is_correct() and ref.is_correct()
    assert tree.depth() == ref.depth()
    assert tree.cum_size == ref.cum_size == 80
    np.testing.assert_array_equal(tree.center_of_mass, ref.center_of_mass)
    for q in (y[0], y[12], np.array([0.1, -0.2]), np.array([5.0, 5.0])):
        gi, gd = tree.knn(q, 5)
        ri, rd = ref.knn(q, 5)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gd, rd)
    for i in range(80):
        a, b = np.zeros(2), np.zeros(2)
        assert tree.compute_non_edge_forces(i, 0.5, a) == \
            ref.compute_non_edge_forces(i, 0.5, b)
        np.testing.assert_array_equal(a, b)
    rows = np.arange(0, 161, 2)
    cols = rng.randint(0, 80, 160)
    vals = rng.rand(160)
    a, b = np.zeros_like(y), np.zeros_like(y)
    tree.compute_edge_forces(rows, cols, vals, 80, a)
    ref.compute_edge_forces(rows, cols, vals, 80, b)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="2-D"):
        QuadTree(rng.randn(4, 3))

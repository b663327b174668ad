"""t-SNE (reference ``plot/Tsne.java`` and ``plot/BarnesHutTsne.java:63``).

Counterpart of ``deeplearning4j_tpu/plot/tsne.py``. Two implementations,
mirroring the reference split:

- ``Tsne`` — the exact O(N²) gradient, each iteration a few torch ops
  on ``resolve_device(device)`` (``"cuda"`` unless the caller names
  another): the [N, N] student-t kernel with its diagonal zeroed in
  place, the gains and momentum, and re-centring (JAX's jitted
  ``_tsne_step``). The joint P and its β search stay host numpy in
  f64, as in JAX; the KL divergence is read back once, at the end.
- ``BarnesHutTsne`` — O(N log N) via SPTree (host numpy), matching the
  reference's structure for large N: sparse kNN-P from a VPTree +
  theta-gated cell approximation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.sptree import SPTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


def _binary_search_betas(d2: np.ndarray, perplexity: float,
                         tol: float = 1e-5, max_tries: int = 50):
    """Per-row binary search of precision beta so that the conditional
    distribution's entropy hits log(perplexity). d2: [N, K] squared
    distances to candidate neighbors (self excluded). Vectorized over
    all rows at once (the reference searches row-by-row in
    ``Tsne.hBeta``)."""
    n = d2.shape[0]
    beta = np.ones(n)
    beta_min = np.full(n, -np.inf)
    beta_max = np.full(n, np.inf)
    log_u = np.log(perplexity)
    p = np.zeros_like(d2)
    for _ in range(max_tries):
        p = np.exp(-d2 * beta[:, None])
        sum_p = np.maximum(p.sum(axis=1), 1e-12)
        # H = log(sum_p) + beta * <d2>_p
        h = np.log(sum_p) + beta * (d2 * p).sum(axis=1) / sum_p
        p = p / sum_p[:, None]
        diff = h - log_u
        done = np.abs(diff) < tol
        if done.all():
            break
        hi = (diff > 0) & ~done
        lo = (diff < 0) & ~done
        beta_min[hi] = beta[hi]
        beta[hi] = np.where(
            np.isinf(beta_max[hi]), beta[hi] * 2,
            (beta[hi] + beta_max[hi]) / 2,
        )
        beta_max[lo] = beta[lo]
        beta[lo] = np.where(
            np.isinf(beta_min[lo]), beta[lo] / 2,
            (beta[lo] + beta_min[lo]) / 2,
        )
    return p, beta


def _tsne_step(p, y, y_inc, gains, momentum: float, lr: float,
               want_kl: bool = False):
    """One exact t-SNE gradient step with gains + momentum (reference
    ``Tsne.step``; JAX ``_tsne_step``): returns (y, y_inc, gains, the KL
    as a device scalar where ``want_kl``, else None: the fit asks for it
    at its last iteration only)."""
    n, dims = y.shape
    d2 = torch.zeros((n, n), dtype=y.dtype, device=y.device)
    for k in range(dims):  # no [N, N, dims] temporary
        diff = y[:, k:k + 1] - y[:, k].unsqueeze(0)
        d2.addcmul_(diff, diff)
    num = (d2.add_(1.0)).reciprocal_()
    num.fill_diagonal_(0.0)
    q = (num / num.sum()).clamp_min_(1e-12)
    pq = (p - q).mul_(num)                                 # [N, N]
    grad = 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)
    same_sign = torch.sign(grad) == torch.sign(y_inc)
    gains = torch.where(same_sign, gains * 0.8, gains + 0.2).clamp_min_(0.01)
    y_inc = momentum * y_inc - lr * gains * grad
    y = y + y_inc
    y = y - y.mean(dim=0, keepdim=True)
    kl = (p * torch.log(p.clamp_min(1e-12) / q)).sum() if want_kl else None
    return y, y_inc, gains, kl


class Tsne:
    """Exact t-SNE, one short device program an iteration (reference
    ``plot/Tsne.java`` builder: maxIter, perplexity, learningRate,
    useAdaGrad off → gains+momentum). ``device``: where the iterations
    run (default ``"cuda"``, raising without a card; the UI server
    passes ``"cpu"``)."""

    def __init__(self, max_iter: int = 1000, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_dims: int = 2,
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 stop_lying_iteration: int = 100, lie_factor: float = 4.0,
                 seed: int = 12345, device=None):
        self.max_iter = max_iter
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_dims = n_dims
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.lie_factor = lie_factor
        self.seed = seed
        self.device = device
        self.y: Optional[np.ndarray] = None
        self.kl: float = float("nan")

    def _joint_p(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        d2 = (
            np.sum(x * x, 1)[:, None] + np.sum(x * x, 1)[None, :]
            - 2.0 * (x @ x.T)
        )
        np.fill_diagonal(d2, 0.0)
        # exclude self: search over the off-diagonal entries
        mask = ~np.eye(n, dtype=bool)
        d2_off = d2[mask].reshape(n, n - 1)
        p_cond, _ = _binary_search_betas(d2_off, self.perplexity)
        p = np.zeros((n, n))
        p[mask] = p_cond.ravel()
        p = (p + p.T) / (2.0 * n)
        return np.maximum(p, 1e-12)

    def fit(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        return self._fit_p(self._joint_p(x))

    def _fit_p(self, p: np.ndarray) -> np.ndarray:
        """``fit``'s iterations from a joint P ([N, N], ``_joint_p``'s) on
        ``self.device``; returns y [N, n_dims] (host float32). Apart from
        ``fit`` so that a caller holding P (``chip_smoke.py``'s
        ``[tsne]``, which times ``_joint_p`` alone) need not recompute
        it."""
        dev = resolve_device(self.device)
        n = p.shape[0]
        rng = np.random.RandomState(self.seed)
        y = torch.from_numpy(
            (rng.randn(n, self.n_dims) * 1e-4).astype(np.float32)).to(dev)
        y_inc = torch.zeros_like(y)
        gains = torch.ones_like(y)
        p_lied = torch.from_numpy(
            (p * self.lie_factor).astype(np.float32)).to(dev)
        p_true = torch.from_numpy(p.astype(np.float32)).to(dev)
        kl = None
        for it in range(self.max_iter):
            momentum = (
                self.initial_momentum
                if it < self.switch_momentum_iteration
                else self.final_momentum
            )
            cur_p = p_lied if it < self.stop_lying_iteration else p_true
            y, y_inc, gains, kl = _tsne_step(
                cur_p, y, y_inc, gains, momentum, self.learning_rate,
                want_kl=it == self.max_iter - 1)
        # the one read back: the embedding and the final KL
        self.kl = float(kl) if kl is not None else float("nan")
        self.y = y.cpu().numpy()
        return self.y


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE (reference ``plot/BarnesHutTsne.java:63`` —
    implements the same knobs plus ``theta``; gradient via SPTree,
    sparse input similarities via VPTree kNN)."""

    def __init__(self, theta: float = 0.5, perplexity: float = 30.0,
                 max_iter: int = 1000, learning_rate: float = 200.0,
                 n_dims: int = 2, **kw):
        super().__init__(max_iter=max_iter, perplexity=perplexity,
                         learning_rate=learning_rate, n_dims=n_dims, **kw)
        self.theta = theta

    def _sparse_p(self, x: np.ndarray):
        """Sparse symmetric P over 3·perplexity nearest neighbors
        (reference ``BarnesHutTsne.computeGaussianPerplexity``)."""
        n = x.shape[0]
        k = min(int(3 * self.perplexity), n - 1)
        tree = VPTree(x)
        cols = np.zeros((n, k), np.int64)
        d2 = np.zeros((n, k))
        for i in range(n):
            idx, dist = tree.search(x[i], k + 1)
            # drop self (distance 0 to itself is always found first)
            pairs = [(j, dv) for j, dv in zip(idx, dist) if j != i][:k]
            cols[i] = [j for j, _ in pairs]
            d2[i] = [dv * dv for _, dv in pairs]
        p_cond, _ = _binary_search_betas(d2, self.perplexity)
        # symmetrize: P = (P + P^T) / (2n) over the union sparsity
        from collections import defaultdict
        entries = defaultdict(float)
        for i in range(n):
            for j, v in zip(cols[i], p_cond[i]):
                entries[(i, int(j))] += v / (2.0 * n)
                entries[(int(j), i)] += v / (2.0 * n)
        rows_counts = np.zeros(n, np.int64)
        for (i, _j) in entries:
            rows_counts[i] += 1
        rows = np.zeros(n + 1, np.int64)
        np.cumsum(rows_counts, out=rows[1:])
        cols_flat = np.zeros(len(entries), np.int64)
        vals_flat = np.zeros(len(entries))
        fill = rows[:-1].copy()
        for (i, j), v in sorted(entries.items()):
            cols_flat[fill[i]] = j
            vals_flat[fill[i]] = v
            fill[i] += 1
        return rows, cols_flat, vals_flat

    def fit(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        rows, cols, vals = self._sparse_p(x)
        vals = vals / max(vals.sum(), 1e-12)
        rng = np.random.RandomState(self.seed)
        y = rng.randn(n, self.n_dims) * 1e-4
        y_inc = np.zeros_like(y)
        gains = np.ones_like(y)
        lied = vals * self.lie_factor
        for it in range(self.max_iter):
            cur_vals = lied if it < self.stop_lying_iteration else vals
            momentum = (
                self.initial_momentum
                if it < self.switch_momentum_iteration
                else self.final_momentum
            )
            pos_f = np.zeros_like(y)
            SPTree.compute_edge_forces(y, rows, cols, cur_vals, pos_f)
            tree = SPTree(y)
            neg_f = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                row_neg = np.zeros(self.n_dims)
                sum_q += tree.compute_non_edge_forces(
                    i, self.theta, row_neg
                )
                neg_f[i] = row_neg
            grad = pos_f - neg_f / max(sum_q, 1e-12)
            same_sign = np.sign(grad) == np.sign(y_inc)
            gains = np.maximum(
                np.where(same_sign, gains * 0.8, gains + 0.2), 0.01
            )
            y_inc = momentum * y_inc - self.learning_rate * gains * grad
            y = y + y_inc
            y = y - y.mean(axis=0, keepdims=True)
        self.y = y
        return y

"""KMeans clustering (reference
``clustering/kmeans/KMeansClustering.java`` +
``clustering/algorithm/BaseClusteringAlgorithm.java`` and its
strategy/condition machinery).

Counterpart of ``deeplearning4j_tpu/clustering/kmeans.py``. The
reference iterates points one at a time through ``ClusterUtils``
thread pools; here one Lloyd step works on the whole ``[N, K]``
distance matrix on the device (assign = argmin of a row, update = the
masked mean as a one-hot product), as the JAX package's jitted step
does, in plain torch (the JAX step is ``jnp``, not a Pallas kernel).
The host loop only checks the termination condition (a fixed
iteration count, or the distribution-variation rate of the cost,
mirroring ``FixedIterationCountCondition`` / ``ConvergenceCondition``);
under a fixed count nothing is read back until the end. The k-means++
seeding is the JAX package's ``RandomState`` stream on the host, so
both packages start from the same centers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.cluster import (
    Cluster,
    ClusterSet,
    Point,
)
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device

_DISTANCES = ("euclidean", "manhattan", "cosinesimilarity")

#: Elements of the ``[rows, K, D]`` difference a distance block holds
#: (the euclidean and manhattan distances are taken in row blocks of
#: at most this many; each entry is the same sum either way).
_BLOCK_ELEMS = 1 << 26


def _distances(x: torch.Tensor, centers: torch.Tensor,
               distance: str) -> torch.Tensor:
    """The ``[N, K]`` distance of every row to every center."""
    if distance == "cosinesimilarity":
        xn = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        cn = centers / torch.linalg.norm(centers, dim=1,
                                         keepdim=True).clamp_min(1e-12)
        return 1.0 - xn @ cn.T
    k, d = centers.shape
    step = max(1, _BLOCK_ELEMS // max(k * d, 1))
    out = []
    for lo in range(0, x.shape[0], step):
        diff = x[lo:lo + step, None, :] - centers[None, :, :]
        out.append((diff * diff if distance == "euclidean"
                    else diff.abs()).sum(-1))
    return torch.cat(out) if len(out) > 1 else out[0]


def lloyd_step(x: torch.Tensor, centers: torch.Tensor, k: int,
               distance: str):
    """One Lloyd iteration (JAX ``_lloyd_step``): ``(new centers [K, D],
    assignment [N], cost)``; an empty cluster keeps its center."""
    d = _distances(x, centers, distance)
    dmin, assign = torch.min(d, dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # [N, K]
    counts = onehot.sum(0)                                        # [K]
    sums = onehot.T @ x                                           # [K, D]
    new_centers = torch.where(counts[:, None] > 0,
                              sums / counts[:, None].clamp_min(1.0),
                              centers)
    return new_centers, assign, dmin.sum()


class KMeansClustering:
    """Reference ``KMeansClustering.setup`` twins: fixed iteration
    count, or convergence on the distribution-variation rate. The
    points and centers live on ``device`` (default ``"cuda"``)."""

    def __init__(self, cluster_count: int,
                 max_iteration_count: Optional[int],
                 distance_function: str = "euclidean",
                 min_distribution_variation_rate: Optional[float] = None,
                 allow_empty_clusters: bool = True, seed: int = 12345,
                 device=None):
        if distance_function not in _DISTANCES:
            raise ValueError(
                f"unknown distance {distance_function!r}; "
                f"expected one of {_DISTANCES}"
            )
        self.k = cluster_count
        self.max_iterations = max_iteration_count
        self.distance = distance_function
        self.min_variation = min_distribution_variation_rate
        self.allow_empty = allow_empty_clusters
        self.seed = seed
        self.device = resolve_device(device)
        self.iteration_count = 0
        self.centers: Optional[torch.Tensor] = None
        self.assignment: Optional[torch.Tensor] = None

    @classmethod
    def setup(cls, cluster_count: int, max_iteration_count: int,
              distance_function: str = "euclidean",
              seed: int = 12345, device=None) -> "KMeansClustering":
        return cls(cluster_count, max_iteration_count, distance_function,
                   seed=seed, device=device)

    @classmethod
    def setup_convergence(
        cls, cluster_count: int,
        min_distribution_variation_rate: float,
        distance_function: str = "euclidean",
        allow_empty_clusters: bool = True, seed: int = 12345, device=None,
    ) -> "KMeansClustering":
        return cls(cluster_count, None, distance_function,
                   min_distribution_variation_rate, allow_empty_clusters,
                   seed, device=device)

    def _kmeans_pp_init(self, x: np.ndarray,
                        rng: np.random.RandomState) -> np.ndarray:
        """k-means++ seeding (D² sampling): far-apart initial centers,
        avoiding the bad local optima plain random choice falls into.
        (The reference seeds from random points —
        ``ClusterUtils.randomClusters``; ++ strictly improves on it.)"""
        n = x.shape[0]
        centers = np.empty((self.k, x.shape[1]), x.dtype)
        centers[0] = x[rng.randint(n)]
        d2 = np.sum((x - centers[0]) ** 2, axis=1)
        for i in range(1, self.k):
            total = float(d2.sum())
            if total <= 0.0:
                # remaining points are duplicates of chosen centers
                centers[i] = x[rng.randint(n)]
                continue
            centers[i] = x[rng.choice(n, p=d2 / total)]
            d2 = np.minimum(d2, np.sum((x - centers[i]) ** 2, axis=1))
        return centers

    def fit_tensors(self, x: np.ndarray):
        """The Lloyd loop on the device from the k-means++ seeding of the
        host rows ``x [N, D]``: ``(centers [K, D], assignment [N])`` as
        device tensors (also kept as ``centers`` / ``assignment``)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if self.k > n:
            raise ValueError(f"k={self.k} > n_points={n}")
        rng = np.random.RandomState(self.seed)
        centers = torch.from_numpy(self._kmeans_pp_init(x, rng)).to(
            self.device)
        xd = torch.from_numpy(x).to(self.device)
        prev_cost = None
        assign = None
        self.iteration_count = 0
        for _ in range(self.max_iterations or 1000):
            centers, assign, cost = lloyd_step(xd, centers, self.k,
                                               self.distance)
            self.iteration_count += 1
            if self.min_variation is None:
                continue
            cost = float(cost)
            if prev_cost is not None:
                denom = max(abs(prev_cost), 1e-12)
                if abs(prev_cost - cost) / denom < self.min_variation:
                    break
            prev_cost = cost
        self.centers, self.assignment = centers, assign
        return centers, assign

    def apply_to(self, points) -> ClusterSet:
        """Cluster the points (reference
        ``BaseClusteringAlgorithm.applyTo``)."""
        if isinstance(points, np.ndarray):
            pts = Point.to_points(points)
            x = np.asarray(points, np.float32)
        else:
            pts = list(points)
            x = np.stack([p.array for p in pts]).astype(np.float32)
        centers, assign = self.fit_tensors(x)
        assign = assign.cpu().numpy()
        centers = centers.cpu().numpy()
        clusters = [
            Cluster(Point(f"center-{i}", centers[i]), id=str(i))
            for i in range(self.k)
        ]
        for idx, p in zip(assign, pts):
            clusters[int(idx)].add_point(p)
        if not self.allow_empty:
            clusters = [c for c in clusters if c.points]
        return ClusterSet(clusters)

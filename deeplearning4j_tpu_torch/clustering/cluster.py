"""Cluster model objects (reference
``clustering/cluster/Point.java``, ``Cluster.java``,
``ClusterSet.java``, ``PointClassification.java``).

Counterpart of ``deeplearning4j_tpu/clustering/cluster.py``: host numpy,
the same code."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Point:
    """A point with id + array (reference ``Point.java``)."""

    id: str
    array: np.ndarray
    label: Optional[str] = None

    @staticmethod
    def to_points(matrix: np.ndarray) -> List["Point"]:
        return [Point(str(i), np.asarray(row)) for i, row in
                enumerate(matrix)]


@dataclass
class Cluster:
    """A center plus its member points (reference ``Cluster.java``)."""

    center: Point
    points: List[Point] = field(default_factory=list)
    id: str = ""

    def add_point(self, p: Point) -> None:
        self.points.append(p)

    def get_distance_to_center(self, p: Point) -> float:
        return float(np.linalg.norm(p.array - self.center.array))


@dataclass
class PointClassification:
    """Result of classifying one point into a ClusterSet (reference
    ``PointClassification.java``)."""

    cluster: Cluster
    distance_from_center: float
    new_location: bool


class ClusterSet:
    """All clusters of one run (reference ``ClusterSet.java``)."""

    def __init__(self, clusters: Optional[List[Cluster]] = None):
        self.clusters: List[Cluster] = clusters or []

    def get_clusters(self) -> List[Cluster]:
        return self.clusters

    def get_cluster_count(self) -> int:
        return len(self.clusters)

    def centers(self) -> np.ndarray:
        return np.stack([c.center.array for c in self.clusters])

    def classify_point(self, p: Point,
                       move: bool = True) -> PointClassification:
        centers = self.centers()
        d = np.linalg.norm(centers - p.array[None, :], axis=1)
        best = int(np.argmin(d))
        cluster = self.clusters[best]
        was_member = any(q.id == p.id for q in cluster.points)
        if move and not was_member:
            for c in self.clusters:
                c.points = [q for q in c.points if q.id != p.id]
            cluster.add_point(p)
        return PointClassification(cluster, float(d[best]), not was_member)

"""Clustering and spatial indexes (reference
``deeplearning4j-core/.../clustering``): KMeans on the device, KD-tree,
VP-tree.

Counterpart of ``deeplearning4j_tpu/clustering``. The quad tree and SP
tree (``quadtree.py``, ``sptree.py``, Barnes-Hut for t-SNE) are queued
with ``plot/`` (ROADMAP queue 1), the only package that uses them."""

from deeplearning4j_tpu_torch.clustering.cluster import (
    Cluster,
    ClusterSet,
    Point,
    PointClassification,
)
from deeplearning4j_tpu_torch.clustering.kdtree import HyperRect, KDTree
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.vptree import DataPoint, VPTree

__all__ = [
    "Cluster", "ClusterSet", "Point", "PointClassification",
    "HyperRect", "KDTree", "KMeansClustering", "DataPoint", "VPTree",
]

"""Clustering and spatial indexes (reference
``deeplearning4j-core/.../clustering``): KMeans on the device, KD-tree,
VP-tree, and the quad tree and SP tree of Barnes-Hut t-SNE.

Counterpart of ``deeplearning4j_tpu/clustering``; the trees
(``quadtree.py``, ``sptree.py``) are host numpy, as there, and
``plot.BarnesHutTsne`` runs on them."""

from deeplearning4j_tpu_torch.clustering.cluster import (
    Cluster,
    ClusterSet,
    Point,
    PointClassification,
)
from deeplearning4j_tpu_torch.clustering.kdtree import HyperRect, KDTree
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.quadtree import (
    Cell as QuadCell,
    QuadTree,
)
from deeplearning4j_tpu_torch.clustering.sptree import Cell, SPTree
from deeplearning4j_tpu_torch.clustering.vptree import DataPoint, VPTree

__all__ = [
    "Cluster", "ClusterSet", "Point", "PointClassification",
    "HyperRect", "KDTree", "KMeansClustering", "Cell", "QuadTree",
    "SPTree", "DataPoint", "VPTree", "QuadCell",
]

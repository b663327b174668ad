"""Graph embeddings (reference ``deeplearning4j-graph``): adjacency-list
graph, vectorized random walks, DeepWalk with hierarchical softmax over
a degree-based Huffman tree.

Counterpart of ``deeplearning4j_tpu/graph``. The edge-list loaders and
the txt vector serializer are not ported yet (ROADMAP queue 1)."""

from deeplearning4j_tpu_torch.graph.api import (
    Edge,
    NoEdgeHandling,
    NoEdgesException,
    ParseException,
    Vertex,
    VertexSequence,
)
from deeplearning4j_tpu_torch.graph.deepwalk import (
    DeepWalk,
    GraphHuffman,
    GraphVectorsImpl,
    InMemoryGraphLookupTable,
)
from deeplearning4j_tpu_torch.graph.graph import Graph, generate_random_walks
from deeplearning4j_tpu_torch.graph.walks import (
    RandomWalkGraphIteratorProvider,
    RandomWalkIterator,
    WeightedRandomWalkGraphIteratorProvider,
    WeightedRandomWalkIterator,
)

__all__ = [
    "Edge", "NoEdgeHandling", "NoEdgesException", "ParseException",
    "Vertex", "VertexSequence", "DeepWalk", "GraphHuffman",
    "GraphVectorsImpl", "InMemoryGraphLookupTable", "Graph",
    "generate_random_walks",
    "RandomWalkGraphIteratorProvider", "RandomWalkIterator",
    "WeightedRandomWalkGraphIteratorProvider",
    "WeightedRandomWalkIterator",
]

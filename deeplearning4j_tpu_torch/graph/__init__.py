"""Graph embeddings (reference ``deeplearning4j-graph``): adjacency-list
graph, vectorized random walks, DeepWalk with hierarchical softmax over
a degree-based Huffman tree, edge-list loaders, txt serialization.

Counterpart of ``deeplearning4j_tpu/graph``."""

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
from deeplearning4j_tpu_torch.graph.loader import (
    load_undirected_graph_edge_list_file,
    load_vertex_values,
    load_weighted_edge_list_file,
)
from deeplearning4j_tpu_torch.graph.serializer import (
    load_txt_vectors,
    write_graph_vectors,
)
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
    "generate_random_walks", "load_undirected_graph_edge_list_file",
    "load_vertex_values", "load_weighted_edge_list_file",
    "load_txt_vectors", "write_graph_vectors",
    "RandomWalkGraphIteratorProvider", "RandomWalkIterator",
    "WeightedRandomWalkGraphIteratorProvider",
    "WeightedRandomWalkIterator",
]

from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    GraphBuilder,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    ListBuilder,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
    ShapeContext,
)

__all__ = [
    "CnnToFeedForwardPreProcessor",
    "ComputationGraphConfiguration",
    "FeedForwardToCnnPreProcessor",
    "FeedForwardToRnnPreProcessor",
    "GraphBuilder",
    "InputPreProcessor",
    "InputType",
    "ListBuilder",
    "MultiLayerConfiguration",
    "NeuralNetConfiguration",
    "RnnToFeedForwardPreProcessor",
    "ShapeContext",
]

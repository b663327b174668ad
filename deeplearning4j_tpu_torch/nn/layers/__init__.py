"""Layers ported so far (their names register for ``layer_from_json``)."""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    LayerNormalization,
    MultiHeadSelfAttention,
    PositionalEncoding,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    LAYER_REGISTRY,
    FeedForwardLayerSpec,
    LayerSpec,
    layer_from_json,
    layer_to_json,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    BatchNormalization,
    ConvolutionLayer,
    LocalResponseNormalization,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    LossLayer,
    OutputLayer,
    SparseEmbeddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GravesBidirectionalLSTM,
    GravesLSTM,
    RnnOutputLayer,
)

__all__ = [
    "LAYER_REGISTRY",
    "ActivationLayer",
    "BatchNormalization",
    "ConvolutionLayer",
    "DenseLayer",
    "DropoutLayer",
    "EmbeddingLayer",
    "FeedForwardLayerSpec",
    "GravesBidirectionalLSTM",
    "GravesLSTM",
    "LayerNormalization",
    "LayerSpec",
    "LocalResponseNormalization",
    "LossLayer",
    "MultiHeadSelfAttention",
    "OutputLayer",
    "PositionalEncoding",
    "RnnOutputLayer",
    "SparseEmbeddingLayer",
    "SubsamplingLayer",
    "TransformerBlock",
    "layer_from_json",
    "layer_to_json",
    "register_layer",
]

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
from deeplearning4j_tpu_torch.nn.layers.moe import MixtureOfExperts
from deeplearning4j_tpu_torch.nn.layers.pretrain import RBM, AutoEncoder
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GravesBidirectionalLSTM,
    GravesLSTM,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.variational import (
    BernoulliReconstructionDistribution,
    CompositeReconstructionDistribution,
    ExponentialReconstructionDistribution,
    GaussianReconstructionDistribution,
    LossFunctionWrapper,
    ReconstructionDistribution,
    VariationalAutoencoder,
    register_distribution,
)

__all__ = [
    "LAYER_REGISTRY",
    "RBM",
    "ActivationLayer",
    "AutoEncoder",
    "BatchNormalization",
    "BernoulliReconstructionDistribution",
    "CompositeReconstructionDistribution",
    "ConvolutionLayer",
    "DenseLayer",
    "DropoutLayer",
    "EmbeddingLayer",
    "ExponentialReconstructionDistribution",
    "FeedForwardLayerSpec",
    "GaussianReconstructionDistribution",
    "GravesBidirectionalLSTM",
    "GravesLSTM",
    "LayerNormalization",
    "LayerSpec",
    "LocalResponseNormalization",
    "LossFunctionWrapper",
    "LossLayer",
    "MixtureOfExperts",
    "MultiHeadSelfAttention",
    "OutputLayer",
    "PositionalEncoding",
    "ReconstructionDistribution",
    "RnnOutputLayer",
    "SparseEmbeddingLayer",
    "SubsamplingLayer",
    "TransformerBlock",
    "VariationalAutoencoder",
    "layer_from_json",
    "layer_to_json",
    "register_distribution",
    "register_layer",
]

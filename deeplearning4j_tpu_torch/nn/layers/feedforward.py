"""Feed-forward layers: Dense, Output, Loss, Activation, Dropout and the
embedding lookups.

Counterpart of ``deeplearning4j_tpu/nn/layers/feedforward.py``.
``DenseLayer`` routes to the fused ``matmul_block`` kernel when its
activation is one of the kernel's epilogues; the softmax
``OutputLayer`` keeps its pre-output product on ``torch.addmm`` (the
JAX package leaves it to XLA: the row-wise softmax is no per-element
epilogue), followed by the plain softmax. ``W`` is ``[n_in, n_out]``
and ``y = x @ W + b``, as in the JAX package. An output layer scores
its pre-output with its loss (``compute_score``, ``nn/losses.py``);
``LossLayer`` scores its input, with no parameters. Dense (and Output)
layers drop their input, or with ``drop_connect`` their ``W``, in
training (``LayerSpec.maybe_dropout`` / ``maybe_drop_connect``), and
``DropoutLayer`` is input dropout alone.
``ActivationLayer`` applies its activation alone, to any input family
(ResNet's ReLU after each residual add). ``EmbeddingLayer`` maps a
column of integer indices to rows of ``W`` (plus ``b``, then the
activation); its gradient is autograd's indexed accumulate, which sums
duplicate indices in a fixed order on the card. ``SparseEmbeddingLayer``
is the same layer marked for row sharding: under a data-parallel world
of more than one rank it raises until the trainer's row-sharded branch
is ported (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn.layers.base import (
    FeedForwardLayerSpec,
    LayerSpec,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops import SUPPORTED_EPILOGUES, matmul_block


@register_layer
@dataclass(frozen=True)
class DenseLayer(FeedForwardLayerSpec):
    """Fully connected layer."""

    def init_params(self, gen, dtype=torch.float32) -> dict:
        w = init_weights(
            gen, (self.n_in, self.n_out), self.weight_init,
            fan_in=self.n_in, fan_out=self.n_out,
            distribution=self.dist, dtype=dtype,
        )
        b = torch.full((self.n_out,), float(self.bias_init), dtype=dtype)
        return {"W": w, "b": b}

    def pre_output(self, params, x):
        return torch.addmm(params["b"], x, params["W"])

    def supports_drop_connect(self) -> bool:
        return True

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        params = self.maybe_drop_connect(params, train=train, rng=rng)
        act = self.activation.lower()
        if x.dim() == 2 and act in SUPPORTED_EPILOGUES:
            return matmul_block(x, params["W"], params["b"],
                                activation=act), state
        return self.activate_fn()(self.pre_output(params, x)), state


@dataclass(frozen=True)
class BaseOutputLayerSpec(DenseLayer):
    """Base for output layers carrying a loss function."""

    loss: str = "MCXENT"

    def has_loss(self) -> bool:
        return True

    def compute_score(self, params, x, labels, mask=None, average=True):
        return losses_mod.score(self.loss, labels,
                                self.pre_output(params, x),
                                self.activation, mask, average)


@register_layer
@dataclass(frozen=True)
class OutputLayer(BaseOutputLayerSpec):
    """Standard classification/regression head. Default
    softmax+MCXENT."""

    activation: str = "softmax"


@register_layer
@dataclass(frozen=True)
class LossLayer(LayerSpec):
    """A loss without parameters: the activation and the loss on its
    input (reference ``nn/conf/layers/LossLayer.java``)."""

    loss: str = "MCXENT"
    activation: str = "identity"

    def has_loss(self) -> bool:
        return True

    def pre_output(self, params, x):
        return x

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.activate_fn()(x), state

    def compute_score(self, params, x, labels, mask=None, average=True):
        return losses_mod.score(self.loss, labels, x, self.activation, mask,
                                average)


@register_layer
@dataclass(frozen=True)
class ActivationLayer(LayerSpec):
    """Pure activation (reference ``nn/conf/layers/ActivationLayer``).
    Shape-agnostic: consumes any input family unchanged (e.g. the ReLU
    after a residual ElementWiseVertex add in conv stacks)."""

    def input_kind(self) -> str:
        return "any"

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.activate_fn()(x), state


@register_layer
@dataclass(frozen=True)
class DropoutLayer(LayerSpec):
    """Dropout alone, on any input family (the JAX package's
    convenience layer; the reference applies dropout as a per-layer
    flag)."""

    activation: str = "identity"

    def input_kind(self) -> str:
        return "any"

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        return self.maybe_dropout(x, train=train, rng=rng), state


@register_layer
@dataclass(frozen=True)
class EmbeddingLayer(FeedForwardLayerSpec):
    """Index -> row lookup (reference
    ``nn/layers/feedforward/embedding/EmbeddingLayer.java:41``): the
    input is a column of integer indices (any dtype; widened on the
    device), the forward ``W[idx] + b`` and the activation."""

    activation: str = "identity"

    def init_params(self, gen, dtype=torch.float32) -> dict:
        w = init_weights(
            gen, (self.n_in, self.n_out), self.weight_init,
            fan_in=self.n_in, fan_out=self.n_out,
            distribution=self.dist, dtype=dtype,
        )
        b = torch.full((self.n_out,), float(self.bias_init), dtype=dtype)
        return {"W": w, "b": b}

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        idx = x.reshape(-1).long()
        return self.activate_fn()(params["W"][idx] + params["b"]), state


@register_layer
@dataclass(frozen=True)
class SparseEmbeddingLayer(EmbeddingLayer):
    """``EmbeddingLayer`` whose ``[vocab, dim]`` table is meant to shard
    its rows over the data-parallel world (the ``embeddings/``
    subsystem's layout). The forward is the base layer's gather. The
    JAX trainer's row-sharded branch is not ported yet:
    ``DistributedTrainer`` over more than one rank refuses a layer with
    ``row_sharded=True`` (ROADMAP queue 1); at one rank, or with
    ``row_sharded=False``, it trains as the base layer does."""

    row_sharded: bool = True

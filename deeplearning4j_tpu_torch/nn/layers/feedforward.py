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
is the same layer marked for row sharding: under ``DistributedTrainer``
over more than one rank, rank ``i`` of ``N`` holds rows ``[i·V/N,
(i+1)·V/N)`` of the table, the forward gathers the batch's rows from
their owners and the backward scatters each row's gradient to its
owner, both through ``parallel/row_exchange.py``. Its one raise is the
check that a ``W`` holding fewer rows than ``n_in`` is one shard of the
world it runs in. Under tensor parallelism (``parallel/
tensor_parallel.py``) the engine hands a dense or output layer its
column shard, and an ``EmbeddingLayer`` its row shard, as a
``ShardParams`` that carries the mesh; they split their product over
its model ranks.
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
from deeplearning4j_tpu_torch.parallel import tensor_parallel


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
        if tensor_parallel.holds_shard(params):
            return tensor_parallel.dense(self, params, x, "pre")
        return torch.addmm(params["b"], x, params["W"])

    def supports_drop_connect(self) -> bool:
        return True

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        params = self.maybe_drop_connect(params, train=train, rng=rng)
        act = self.activation.lower()
        if tensor_parallel.holds_shard(params):
            return tensor_parallel.dense(
                self, params, x,
                act if act in SUPPORTED_EPILOGUES else None), state
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
        rows = (tensor_parallel.lookup(params, idx)
                if tensor_parallel.holds_shard(params) else params["W"][idx])
        return self.activate_fn()(rows + params["b"]), state


@register_layer
@dataclass(frozen=True)
class SparseEmbeddingLayer(EmbeddingLayer):
    """``EmbeddingLayer`` whose ``[vocab, dim]`` table shards its rows
    over the data-parallel world (the ``embeddings/`` subsystem's
    layout). ``DistributedTrainer`` over ``N`` ranks keeps on rank ``i``
    rows ``[i·V/N, (i+1)·V/N)`` of ``W`` and of its updater state, and
    nothing else of them (``row_sharded=False``, ``zero=True``, or a
    vocabulary ``N`` does not divide: replicated, as in the JAX
    trainer). A ``W`` that holds fewer rows than ``n_in`` is such a
    shard: the forward then gathers the batch's rows from their owners
    and the backward sends each row's gradient to its owner
    (``parallel/row_exchange.py``), a collective every rank of the
    default group joins with the same batch size. With the whole table
    the forward is the base layer's gather."""

    row_sharded: bool = True

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        w = params["W"]
        if w.shape[0] == self.n_in:
            return super().apply(params, x, state, train=train, rng=rng,
                                 mask=mask)
        from deeplearning4j_tpu_torch.parallel import row_exchange

        n, rank = row_exchange.world()
        if w.shape[0] * n != self.n_in:
            raise RuntimeError(
                f"SparseEmbeddingLayer: W holds {w.shape[0]} of "
                f"{self.n_in} rows, which is not one shard of a world of "
                f"{n}; gather the table (the engines' fit, write_model) "
                "before leaving the world")
        rows = row_exchange.gather_rows(w, x.reshape(-1), n, rank)
        return self.activate_fn()(rows + params["b"]), state

    def whole_sum(self, name, p, term):
        """A shard's penalty term summed over the ranks (each rank's
        score then holds the whole table's term, and each owner the
        gradient of its rows)."""
        if name != "W" or p.shape[0] == self.n_in:
            return term
        from deeplearning4j_tpu_torch.parallel import row_exchange

        return row_exchange.sum_ranks(term)

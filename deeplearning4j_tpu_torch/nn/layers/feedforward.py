"""Feed-forward layers: Dense and Output.

Counterpart of ``deeplearning4j_tpu/nn/layers/feedforward.py``.
``DenseLayer`` routes to the fused ``matmul_block`` kernel when its
activation is one of the kernel's epilogues; the softmax
``OutputLayer`` keeps its pre-output product on ``torch.addmm`` (the
JAX package leaves it to XLA: the row-wise softmax is no per-element
epilogue), followed by the plain softmax. ``W`` is ``[n_in, n_out]``
and ``y = x @ W + b``, as in the JAX package. An output layer scores
its pre-output with its loss (``compute_score``, ``nn/losses.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn.layers.base import (
    FeedForwardLayerSpec,
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

    def apply(self, params, x, state, *, train=False, gen=None):
        self.check_train(train)
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

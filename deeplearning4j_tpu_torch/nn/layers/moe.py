"""The mixture-of-experts layer of the layer-stack API.

Counterpart of ``deeplearning4j_tpu/nn/layers/moe.py``: a Switch-style
FFN block (router -> top-1 expert two-layer FFN -> combine) with a
residual connection, so a token past its expert's capacity keeps its
input; ``n_out == n_in``. It takes ``[b, f]`` rows or the recurrent
layout ``[b, f, t]`` (tokens ``[b * t, f]``), whose ``[b, t]`` features
mask keeps padding tokens out of routing and zeroes their output. The
FFN is ``parallel/expert.py``'s slot-index dispatch (``moe_ffn``);
``aux_loss`` is the Switch load-balancing loss for custom loops.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.exceptions import DL4JInvalidConfigException
from deeplearning4j_tpu_torch.nn.layers.base import (
    FeedForwardLayerSpec,
    register_layer,
)


@register_layer
@dataclass(frozen=True)
class MixtureOfExperts(FeedForwardLayerSpec):
    """Switch MoE FFN block with a residual connection (n_in ==
    n_out)."""

    n_experts: int = 4
    hidden_size: int = 0  # 0 -> 4 * n_in
    capacity_factor: float = 1.25

    def with_input_type(self, input_type) -> "MixtureOfExperts":
        layer = super().with_input_type(input_type)
        if not layer.n_out:  # residual block: width preserved
            layer = dataclasses.replace(layer, n_out=layer.n_in)
        if layer.n_out and layer.n_in and layer.n_out != layer.n_in:
            raise DL4JInvalidConfigException(
                "MixtureOfExperts is residual: n_out must equal n_in "
                f"(got {layer.n_in} -> {layer.n_out})")
        return layer

    def _hidden(self) -> int:
        return self.hidden_size or 4 * self.n_in

    def init_params(self, gen, dtype=torch.float32) -> dict:
        from deeplearning4j_tpu_torch.parallel.expert import init_moe_params

        return init_moe_params(gen, self.n_in, self._hidden(),
                               self.n_experts, dtype)

    def regularizable_params(self) -> tuple:
        return ("w1", "w2")

    def apply(self, params, x, state, *, train=False, rng=None, mask=None):
        from deeplearning4j_tpu_torch.parallel.expert import moe_ffn

        x = self.maybe_dropout(x, train=train, rng=rng)
        seq = x.dim() == 3
        if seq:  # [b, f, t] -> tokens [b * t, f]
            b, f, t = x.shape
            tokens = x.transpose(1, 2).reshape(b * t, f)
            token_mask = mask.reshape(b * t) if mask is not None else None
        else:
            tokens, token_mask = x, mask
        out = tokens + moe_ffn(params, tokens, self.capacity_factor,
                               token_mask)
        out = self.activate_fn()(out)
        if token_mask is not None:
            out = out * token_mask[:, None].to(out.dtype)
        if seq:
            out = out.reshape(b, t, f).transpose(1, 2)
        return out, state

    def aux_loss(self, params, x) -> torch.Tensor:
        """The load-balancing auxiliary loss of ``x``'s routing."""
        from deeplearning4j_tpu_torch.parallel.expert import (
            aux_load_balance_loss,
        )

        tokens = (x.transpose(1, 2).reshape(-1, x.shape[1])
                  if x.dim() == 3 else x)
        return aux_load_balance_loss(tokens @ params["router"])

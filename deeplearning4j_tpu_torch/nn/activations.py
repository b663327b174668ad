"""Activation functions, keyed by the reference's string vocabulary.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same 23
names with the same numerics, written as PyTorch functions on tensors.
Where the two libraries' defaults differ, the JAX package's meaning
wins: ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default),
leaky relu's slope is 0.01, ``sqrt`` clamps at 0 and softmax runs over
axis 1 (the feature axis of ``[b, size]`` and ``[b, c, h, w]``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


_REGISTRY: dict[str, Activation] = {
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "softmax": lambda x: torch.softmax(x, dim=1),
    "softsign": F.softsign,
    "softplus": F.softplus,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "hardsigmoid": F.hardsigmoid,
    "cube": lambda x: x * x * x,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "rationaltanh": lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    "rectifiedtanh": lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    "sin": torch.sin,
    "step": lambda x: (x > 0).to(x.dtype),
    "sign": torch.sign,
    "abs": torch.abs,
    "sqrt": lambda x: torch.sqrt(torch.clamp_min(x, 0.0)),
    "exp": torch.exp,
}


def get(name: str) -> Activation:
    """Resolve an activation by its reference-vocabulary name."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(_REGISTRY)}"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)

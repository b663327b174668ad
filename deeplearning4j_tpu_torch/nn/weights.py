"""Weight initialization schemes on an explicit ``torch.Generator``.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: the same scheme
names and the same fan-in / fan-out formulas. The JAX package draws
from ``jax.random`` keys, so the same seed gives other numbers here;
parity between the two packages comes from carrying weights over
(``util/model_serializer.params_from_numpy``), never from seeds.
Weights are drawn on the CPU generator and moved to the model's device
by the caller, so a seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class Distribution:
    """Config bean for ``WeightInit.DISTRIBUTION``."""

    kind: str = "normal"  # normal | uniform | binomial
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    n_trials: int = 1
    prob: float = 0.5

    def sample(self, gen: torch.Generator, shape: Sequence[int],
               dtype) -> torch.Tensor:
        if self.kind == "normal":
            return self.mean + self.std * _normal(gen, shape, dtype)
        if self.kind == "uniform":
            return _uniform(gen, shape, dtype, self.lower, self.upper)
        if self.kind == "binomial":
            counts = torch.full(tuple(shape), float(self.n_trials))
            probs = torch.full(tuple(shape), float(self.prob))
            return torch.binomial(counts, probs, generator=gen).to(dtype)
        raise ValueError(f"Unknown distribution kind '{self.kind}'")

    def to_json(self) -> dict:
        return {
            "kind": self.kind, "mean": self.mean, "std": self.std,
            "lower": self.lower, "upper": self.upper,
            "n_trials": self.n_trials, "prob": self.prob,
        }

    @staticmethod
    def from_json(d: dict) -> "Distribution":
        return Distribution(**d)


def _normal(gen, shape, dtype) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32
                       ).to(dtype)


def _uniform(gen, shape, dtype, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(dtype)


def init_weights(
    gen: torch.Generator,
    shape: Sequence[int],
    weight_init: str,
    *,
    fan_in: float,
    fan_out: float,
    distribution: Distribution | None = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Initialize a CPU weight tensor per the named scheme.

    ``fan_in``/``fan_out`` are passed explicitly because for conv
    kernels they are receptive-field products, not raw dims.
    """
    shape = tuple(int(s) for s in shape)
    wi = weight_init.upper()
    if wi == "ZERO":
        return torch.zeros(shape, dtype=dtype)
    if wi == "ONES":
        return torch.ones(shape, dtype=dtype)
    if wi == "IDENTITY":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-d shape")
        return torch.eye(shape[0], dtype=dtype)
    if wi == "DISTRIBUTION":
        dist = distribution or Distribution()
        return dist.sample(gen, shape, dtype)
    if wi in ("NORMAL", "LECUN_NORMAL", "XAVIER_FAN_IN"):
        return _normal(gen, shape, dtype) / math.sqrt(max(fan_in, 1.0))
    if wi == "XAVIER":
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return _normal(gen, shape, dtype) * std
    if wi in ("XAVIER_UNIFORM", "VI"):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if wi == "RELU":  # He init
        return _normal(gen, shape, dtype) * math.sqrt(2.0 / max(fan_in, 1.0))
    if wi == "RELU_UNIFORM":
        a = math.sqrt(6.0 / max(fan_in, 1.0))
        return _uniform(gen, shape, dtype, -a, a)
    if wi == "SIGMOID_UNIFORM":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -a, a)
    if wi == "UNIFORM":
        a = 1.0 / math.sqrt(max(fan_in, 1.0))
        return _uniform(gen, shape, dtype, -a, a)
    raise ValueError(f"Unknown weight init '{weight_init}'")

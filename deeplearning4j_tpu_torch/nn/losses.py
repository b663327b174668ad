"""Loss functions.

Counterpart of ``deeplearning4j_tpu/nn/losses.py``, the same registry
of 16 names with the same semantics: a loss consumes the output layer's
*pre-activation* plus the layer's activation name, so softmax+MCXENT
runs through ``log_softmax`` and sigmoid+XENT through softplus, the
stable forms.

Shape convention:
- 2-d labels/preout ``[batch, nOut]``: one score row per example;
- 3-d ``[batch, nOut, time]``: one row per (example, timestep), with an
  optional ``[batch, time]`` mask; masked rows add zero score and zero
  gradient.

Gradients come from autograd through these scores, as the JAX package
takes them from ``jax.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import activations

_EPS = 1e-8

# Each row fn: (labels2d, preout2d, activation_name) -> per-row score [rows]


def _activate(preout: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "softmax":
        return torch.softmax(preout, dim=-1)
    return activations.get(activation)(preout)


def _mse(labels, preout, act):
    d = _activate(preout, act) - labels
    return torch.sum(d * d, dim=-1) / labels.shape[-1]


def _l2(labels, preout, act):
    d = _activate(preout, act) - labels
    return torch.sum(d * d, dim=-1)


def _l1(labels, preout, act):
    return torch.sum(torch.abs(_activate(preout, act) - labels), dim=-1)


def _mae(labels, preout, act):
    return _l1(labels, preout, act) / labels.shape[-1]


def _mape(labels, preout, act):
    out = _activate(preout, act)
    return 100.0 * torch.sum(
        torch.abs((labels - out) / (torch.abs(labels) + _EPS)), dim=-1
    ) / labels.shape[-1]


def _msle(labels, preout, act):
    out = _activate(preout, act)
    d = torch.log1p(torch.clamp(out, min=-1 + _EPS)) - torch.log1p(
        torch.clamp(labels, min=-1 + _EPS))
    return torch.sum(d * d, dim=-1) / labels.shape[-1]


def _xent(labels, preout, act):
    """Binary cross-entropy; stable-from-logits when act == sigmoid."""
    if act == "sigmoid":
        # log(sigmoid(x)) = -softplus(-x); log(1-sigmoid(x)) = -softplus(x)
        return torch.sum(labels * F.softplus(-preout)
                         + (1.0 - labels) * F.softplus(preout), dim=-1)
    out = torch.clamp(_activate(preout, act), _EPS, 1.0 - _EPS)
    return -torch.sum(labels * torch.log(out)
                      + (1.0 - labels) * torch.log(1.0 - out), dim=-1)


def _mcxent(labels, preout, act):
    """Multi-class cross-entropy; stable-from-logits when act ==
    softmax."""
    if act == "softmax":
        return -torch.sum(labels * torch.log_softmax(preout, dim=-1), dim=-1)
    out = torch.clamp(_activate(preout, act), _EPS, 1.0)
    return -torch.sum(labels * torch.log(out), dim=-1)


def _kl(labels, preout, act):
    out = torch.clamp(_activate(preout, act), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    return torch.sum(labels * (torch.log(lab) - torch.log(out)), dim=-1)


def _cosine(labels, preout, act):
    out = _activate(preout, act)
    num = torch.sum(labels * out, dim=-1)
    den = (torch.linalg.vector_norm(labels, dim=-1)
           * torch.linalg.vector_norm(out, dim=-1))
    return -num / (den + _EPS)


def _hinge(labels, preout, act):
    # labels in {-1, +1}
    return torch.sum(torch.clamp(1.0 - labels * _activate(preout, act),
                                 min=0.0), dim=-1)


def _squared_hinge(labels, preout, act):
    h = torch.clamp(1.0 - labels * _activate(preout, act), min=0.0)
    return torch.sum(h * h, dim=-1)


def _poisson(labels, preout, act):
    out = torch.clamp(_activate(preout, act), min=_EPS)
    return torch.sum(out - labels * torch.log(out), dim=-1)


def _nll(labels, preout, act):
    return _mcxent(labels, preout, act)


_REGISTRY: Dict[str, Callable] = {
    "MSE": _mse,
    "SQUARED_LOSS": _l2,
    "L2": _l2,
    "L1": _l1,
    "MEAN_ABSOLUTE_ERROR": _mae,
    "MEAN_ABSOLUTE_PERCENTAGE_ERROR": _mape,
    "MEAN_SQUARED_LOGARITHMIC_ERROR": _msle,
    "XENT": _xent,
    "MCXENT": _mcxent,
    "NEGATIVELOGLIKELIHOOD": _nll,
    "RECONSTRUCTION_CROSSENTROPY": _xent,
    "KL_DIVERGENCE": _kl,
    "COSINE_PROXIMITY": _cosine,
    "HINGE": _hinge,
    "SQUARED_HINGE": _squared_hinge,
    "POISSON": _poisson,
}


def names() -> List[str]:
    return sorted(_REGISTRY)


def register(name: str, row_fn: Callable) -> None:
    """Register a custom loss ``row_fn(labels2d, preout2d, activation)
    -> per-row scores``."""
    _REGISTRY[name.upper()] = row_fn


def _to_rows(a: torch.Tensor) -> torch.Tensor:
    """[b, n] -> [b, n]; [b, n, t] -> [b*t, n] (time-major rows within
    each example, as the JAX package's transpose + reshape)."""
    if a.dim() == 2:
        return a
    if a.dim() == 3:
        return a.permute(0, 2, 1).reshape(-1, a.shape[1])
    raise ValueError(f"Loss expects 2-d or 3-d arrays, got shape "
                     f"{tuple(a.shape)}")


def score(loss: str, labels: torch.Tensor, preout: torch.Tensor,
          activation: str, mask: Optional[torch.Tensor] = None,
          average: bool = True) -> torch.Tensor:
    """Scalar loss score. ``average=True`` divides by the number of
    unmasked rows (examples, or example-timesteps for 3-d input)."""
    rows = per_row_scores(loss, labels, preout, activation, mask)
    total = torch.sum(rows)
    if not average:
        return total
    if mask is not None:
        return total / torch.clamp(torch.sum(mask), min=1.0)
    return total / rows.shape[0]


def per_row_scores(loss: str, labels: torch.Tensor, preout: torch.Tensor,
                   activation: str,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row (example / example-timestep) scores, mask applied."""
    try:
        fn = _REGISTRY[loss.upper()]
    except KeyError:
        raise ValueError(f"Unknown loss '{loss}'. Known: {names()}") from None
    rows = fn(_to_rows(labels), _to_rows(preout), activation)
    if mask is not None:
        # [b] (2-d case) or [b, t]: row-major flattening matches _to_rows
        rows = rows * mask.reshape(-1)
    return rows

"""Per-layer optimizer machinery.

Counterpart of ``deeplearning4j_tpu/nn/updaters.py``: ``UpdaterSettings``
per layer, the host-side learning-rate policies (``scheduled_lr``), the
seven update rules (``apply_updater``), gradient normalization and the
network-wide ``MultiLayerUpdaterDef``. Updater state is a dictionary
shaped like the parameters, ``{layer: {param: (tensor, ...)}}``, keyed
as in the JAX package so ``updaterState.npz`` moves between the two.

The rules are plain functions on tensors, run under ``torch.no_grad``.
``torch.optim`` is not used: its Nesterov rule is not the reference's.
The functions return new tensors and never write into their inputs, so
a caller may keep the previous step's parameters and state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, Dict[str, torch.Tensor]]
State = Dict[str, Dict[str, Tuple[torch.Tensor, ...]]]


@dataclass(frozen=True)
class UpdaterSettings:
    """Everything the per-layer updater needs for one layer."""

    updater: str = "SGD"
    learning_rate: float = 0.1
    bias_learning_rate: Optional[float] = None
    bias_params: tuple = ("b",)
    momentum: float = 0.9  # NESTEROVS
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    rho: float = 0.95  # ADADELTA
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    gradient_normalization: str = "None"
    gradient_normalization_threshold: float = 1.0
    # LR policy (host-side schedule)
    lr_policy: str = "None"
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_score_decay: float = 0.0
    max_num_iterations: int = 100000
    lr_schedule: Optional[dict] = None  # {iteration: lr}
    regularizable: tuple = ("W",)  # param names subject to l1/l2


def scheduled_lr(s: UpdaterSettings, iteration: int) -> float:
    """The learning rate at ``iteration`` (reference
    ``LearningRatePolicy``)."""
    lr = s.learning_rate
    p = s.lr_policy
    if p in ("None", "Score", None):
        return lr
    if p == "Exponential":
        return lr * (s.lr_policy_decay_rate ** iteration)
    if p == "Inverse":
        return lr / ((1.0 + s.lr_policy_decay_rate * iteration)
                     ** s.lr_policy_power)
    if p == "Poly":
        frac = min(iteration / max(s.max_num_iterations, 1), 1.0)
        return lr * ((1.0 - frac) ** s.lr_policy_power)
    if p == "Sigmoid":
        return lr / (1.0 + math.exp(
            -s.lr_policy_decay_rate * (iteration - s.lr_policy_steps)))
    if p == "Step":
        return lr * (s.lr_policy_decay_rate
                     ** math.floor(iteration / s.lr_policy_steps))
    if p == "TorchStep":
        # each iteration i in [2, iteration] with steps % i == 0
        # compounds one decay factor (reference LayerUpdater.java:142)
        n_decays = sum(1 for i in range(2, iteration + 1)
                       if s.lr_policy_steps % i == 0)
        return lr * (s.lr_policy_decay_rate ** n_decays)
    if p == "Schedule":
        if s.lr_schedule:
            best = None
            for k, v in s.lr_schedule.items():
                if int(k) <= iteration and (best is None or int(k) > best[0]):
                    best = (int(k), v)
            if best is not None:
                return best[1]
        return lr
    raise ValueError(f"Unknown LR policy '{p}'")


_STATE_SLOTS = {"SGD": 0, "NONE": 0, "NESTEROVS": 1, "ADAGRAD": 1,
                "RMSPROP": 1, "ADAM": 2, "ADADELTA": 2}


def init_param_state(s: UpdaterSettings, param: torch.Tensor) -> tuple:
    try:
        n = _STATE_SLOTS[s.updater.upper()]
    except KeyError:
        raise ValueError(f"Unknown updater '{s.updater}'") from None
    return tuple(torch.zeros_like(param) for _ in range(n))


def _bias_correction(decay: float, t: int, like: torch.Tensor) -> float:
    """``1 - decay**t`` in the state's precision, as the JAX package
    computes Adam's bias correction (in f32 for f32 moments: at
    decay 0.999 the f64 value differs by 1e-5 relative)."""
    return float(1.0 - torch.tensor(decay, dtype=like.dtype) ** t)


@torch.no_grad()
def apply_updater(s: UpdaterSettings, grad: torch.Tensor, state: tuple,
                  lr: float, t: int) -> Tuple[torch.Tensor, tuple]:
    """Return ``(step, new_state)``; the caller applies ``param -=
    step``. ``t`` is the 1-based iteration count (Adam's bias
    correction)."""
    u = s.updater.upper()
    if u == "SGD":
        return lr * grad, ()
    if u == "NONE":
        return grad, ()
    if u == "NESTEROVS":
        (v,) = state
        v_new = s.momentum * v - lr * grad
        # reference Nesterovs: ret = -(mu * v_prev - (1 + mu) * v_new)
        step = s.momentum * v - (1.0 + s.momentum) * v_new
        return step, (v_new,)
    if u == "ADAGRAD":
        (h,) = state
        h_new = h + grad * grad
        return lr * grad / (torch.sqrt(h_new) + s.epsilon), (h_new,)
    if u == "RMSPROP":
        (h,) = state
        h_new = s.rms_decay * h + (1.0 - s.rms_decay) * grad * grad
        return lr * grad / torch.sqrt(h_new + s.epsilon), (h_new,)
    if u == "ADAM":
        m, v = state
        b1, b2 = s.adam_mean_decay, s.adam_var_decay
        m_new = b1 * m + (1.0 - b1) * grad
        v_new = b2 * v + (1.0 - b2) * grad * grad
        m_hat = m_new / _bias_correction(b1, t, m_new)
        v_hat = v_new / _bias_correction(b2, t, v_new)
        return lr * m_hat / (torch.sqrt(v_hat) + s.epsilon), (m_new, v_new)
    if u == "ADADELTA":
        eg, ex = state
        rho = s.rho
        eg_new = rho * eg + (1.0 - rho) * grad * grad
        dx = grad * torch.sqrt(ex + s.epsilon) / torch.sqrt(eg_new
                                                            + s.epsilon)
        ex_new = rho * ex + (1.0 - rho) * dx * dx
        return dx, (eg_new, ex_new)
    raise ValueError(f"Unknown updater '{s.updater}'")


@torch.no_grad()
def normalize_layer_grads(s: UpdaterSettings,
                          grads: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Reference ``GradientNormalization``, on one layer's gradients."""
    gn = s.gradient_normalization
    if gn in ("None", None):
        return grads
    thr = s.gradient_normalization_threshold
    if gn == "RenormalizeL2PerLayer":
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values())
                          + 1e-12)
        return {k: g / norm for k, g in grads.items()}
    if gn == "RenormalizeL2PerParamType":
        return {k: g / torch.sqrt(torch.sum(g * g) + 1e-12)
                for k, g in grads.items()}
    if gn == "ClipElementWiseAbsoluteValue":
        return {k: torch.clamp(g, -thr, thr) for k, g in grads.items()}
    if gn == "ClipL2PerLayer":
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values())
                          + 1e-12)
        scale = torch.clamp(thr / norm, max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if gn == "ClipL2PerParamType":
        return {k: g * torch.clamp(thr / torch.sqrt(torch.sum(g * g)
                                                    + 1e-12), max=1.0)
                for k, g in grads.items()}
    raise ValueError(f"Unknown gradient normalization '{gn}'")


class MultiLayerUpdaterDef:
    """Per-layer ``UpdaterSettings``; init and update over the whole
    network's ``{layer: {param: tensor}}``."""

    def __init__(self, settings: Dict[str, UpdaterSettings]):
        self.settings = settings

    def init(self, params: Params) -> State:
        return {ln: {pn: init_param_state(self.settings[ln], p)
                     for pn, p in lp.items()}
                for ln, lp in params.items()}

    def scheduled_lrs(self, iteration: int) -> Dict[str, float]:
        return {ln: scheduled_lr(s, iteration)
                for ln, s in self.settings.items()}

    @torch.no_grad()
    def update(self, grads: Params, state: State, params: Params,
               lrs: Dict[str, float], t: int) -> Tuple[Params, State]:
        """Return ``(new_params, new_state)``.

        L1/L2 are not added here: the penalty is part of the network's
        score, so the gradient already holds it once. Biases (names in
        ``bias_params``) use ``bias_learning_rate`` when it is set.
        Parameters and state keep their dtypes."""
        new_params: Params = {}
        new_state: State = {}
        for ln, lgrads in grads.items():
            s = self.settings[ln]
            lgrads = normalize_layer_grads(s, lgrads)
            lr = lrs[ln]
            bias_scale = (s.bias_learning_rate / s.learning_rate
                          if (s.bias_learning_rate is not None
                              and s.learning_rate != 0) else 1.0)
            np_, ns_ = {}, {}
            for pn, g in lgrads.items():
                p = params[ln][pn]
                p_lr = lr * bias_scale if pn in s.bias_params else lr
                step, st = apply_updater(s, g, state[ln][pn], p_lr, t)
                np_[pn] = (p - step).to(p.dtype)
                ns_[pn] = tuple(a.to(o.dtype)
                                for a, o in zip(st, state[ln][pn]))
            new_params[ln] = np_
            new_state[ln] = ns_
        return new_params, new_state

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

import numpy as np
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


def _bias_correction(decay: float, t, like: torch.Tensor) -> torch.Tensor:
    """``1 - decay**t`` in the state's precision on the state's device,
    as the JAX package computes Adam's bias correction (``decay`` and
    ``t`` cast to the moments' dtype: at decay 0.999 the f64 value
    differs by 1e-5 relative in f32). ``t`` is an int or a 0-d tensor
    (a CUDA-graph chunk's step count); both give the same value, by the
    same device operations, and nothing here reads the device back."""
    if not torch.is_tensor(t):
        t = torch.full((), float(t), dtype=torch.float32,
                        device=like.device)
    base = torch.full((), decay, dtype=like.dtype, device=like.device)
    return 1.0 - torch.pow(base, t.to(like.dtype))


def _lr_times(lr, t: torch.Tensor) -> torch.Tensor:
    """``lr * t`` as the JAX package computes it: its learning rate is
    an f32 array, so a half-precision ``t`` is promoted to f32 (a Python
    float would keep the product in bf16 / f16 and round it twice).
    ``lr`` is a float or a 0-d f32 tensor holding the same f32 value:
    either way one f32 multiply, so the two give the same bits."""
    return t.to(torch.promote_types(t.dtype, torch.float32)) * lr


@torch.no_grad()
def apply_updater(s: UpdaterSettings, grad: torch.Tensor, state: tuple,
                  lr, t) -> Tuple[torch.Tensor, tuple]:
    """Return ``(step, new_state)``; the caller applies ``param -=
    step``. ``t`` is the 1-based iteration count (Adam's bias
    correction), an int or a 0-d tensor; ``lr`` a float or a 0-d f32
    tensor."""
    u = s.updater.upper()
    if u == "SGD":
        return _lr_times(lr, grad), ()
    if u == "NONE":
        return grad, ()
    if u == "NESTEROVS":
        (v,) = state
        v_new = s.momentum * v - _lr_times(lr, grad)
        # reference Nesterovs: ret = -(mu * v_prev - (1 + mu) * v_new)
        step = s.momentum * v - (1.0 + s.momentum) * v_new
        return step, (v_new,)
    if u == "ADAGRAD":
        (h,) = state
        h_new = h + grad * grad
        return (_lr_times(lr, grad) / (torch.sqrt(h_new) + s.epsilon),
                (h_new,))
    if u == "RMSPROP":
        (h,) = state
        h_new = s.rms_decay * h + (1.0 - s.rms_decay) * grad * grad
        return _lr_times(lr, grad) / torch.sqrt(h_new + s.epsilon), (h_new,)
    if u == "ADAM":
        m, v = state
        b1, b2 = s.adam_mean_decay, s.adam_var_decay
        m_new = b1 * m + (1.0 - b1) * grad
        v_new = b2 * v + (1.0 - b2) * grad * grad
        m_hat = m_new / _bias_correction(b1, t, m_new)
        v_hat = v_new / _bias_correction(b2, t, v_new)
        return (_lr_times(lr, m_hat) / (torch.sqrt(v_hat) + s.epsilon),
                (m_new, v_new))
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

    def has_bias_lr(self, ln: str) -> bool:
        s = self.settings[ln]
        return s.bias_learning_rate is not None and s.learning_rate != 0

    def param_lr(self, ln: str, pn: str, lrs: dict):
        """The learning rate of one parameter: biases (names in
        ``bias_params``) take ``bias_learning_rate`` when it is set,
        from ``lrs[(ln, "bias")]`` where the caller resolved it (a
        chunk's table of device values), else scaled from ``lrs[ln]``."""
        s = self.settings[ln]
        if pn in s.bias_params and self.has_bias_lr(ln):
            if (ln, "bias") in lrs:
                return lrs[(ln, "bias")]
            return lrs[ln] * (s.bias_learning_rate / s.learning_rate)
        return lrs[ln]

    def lr_table(self, iteration: int, steps: int):
        """The learning rates of ``steps`` steps from ``iteration`` as
        ``(names, rows)``: ``names`` the keys ``update`` reads (each
        layer, and ``(layer, "bias")`` where a bias rate is set), rows an
        f32 ``[steps, len(names)]`` array of the values ``param_lr``
        gives on the host."""
        names = list(self.settings)
        names += [(ln, "bias") for ln in self.settings if self.has_bias_lr(ln)]
        rows = []
        for i in range(steps):
            lrs = self.scheduled_lrs(iteration + i)
            rows.append([lrs[n] if isinstance(n, str) else
                         self.param_lr(n[0], self.settings[n[0]].bias_params[0],
                                       lrs) for n in names])
        return names, np.asarray(rows, dtype=np.float32).reshape(
            steps, len(names))

    @torch.no_grad()
    def update_param(self, ln: str, pn: str, g: torch.Tensor, state: tuple,
                     p: torch.Tensor, lrs: Dict[str, float], t: int):
        """The rule on one parameter (or any slice of it: every rule is
        elementwise); returns ``(new_param, new_state)`` in the dtypes
        of ``p`` and ``state``."""
        step, st = apply_updater(self.settings[ln], g, state,
                                 self.param_lr(ln, pn, lrs), t)
        return ((p - step).to(p.dtype),
                tuple(a.to(o.dtype) for a, o in zip(st, state)))

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
            lgrads = normalize_layer_grads(self.settings[ln], lgrads)
            np_, ns_ = {}, {}
            for pn, g in lgrads.items():
                np_[pn], ns_[pn] = self.update_param(
                    ln, pn, g, state[ln][pn], params[ln][pn], lrs, t)
            new_params[ln] = np_
            new_state[ln] = ns_
        return new_params, new_state

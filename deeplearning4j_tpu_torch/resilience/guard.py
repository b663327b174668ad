"""Divergence guard: NaN/Inf and statistical anomaly detection before
the optimizer update.

Counterpart of ``deeplearning4j_tpu/resilience/guard.py``. The check
rides inside the train step: the loss and the gradients' global norm
are tested for finiteness on the device, and when the step is bad its
parameter, updater-state and layer-state updates are not applied (a
``torch.where`` select on the step's outputs, so the step waits for no
host read). ``StatGuardConfig`` adds the statistical half: an EWMA mean
and variance of the loss and of the gradient norm ride through the step
like the loss-scale state (seven 0-d tensors on the device), and a step
whose loss or norm lands ``z_threshold`` standard deviations out, or
``spike_factor`` times the running mean, is suppressed by the same
select. Tripped and non-finite samples are not folded into the EWMA,
and the first ``warmup`` clean steps only accumulate.

The host policy then decides what a bad step means. ``"skip"`` drops
the minibatch's update and goes on (``skipped_steps`` and
``skipped_batches`` record it); ``"rollback"`` also restores the last
verified checkpoint of its ``checkpoint_manager`` into the model
(``resilience/checkpoint.py`` ``restore_into``): for slow-onset
divergence whose bad state predates the first non-finite loss. A
rollback reads the ok flag at once (the dispatch window's lag is 0
under it) and a megastep chunk is refused under it: the restore must
land before the next step. ``max_consecutive`` bad steps in a row raise
``DL4JFaultException`` instead of spinning. A trip is recorded on the
flight recorder, which then dumps its ring.

The statistical guard's counters go to the metrics registry under the
JAX package's names (``guard_spike_trips_total{signal}``,
``guard_loss_ewma``, ``guard_gradnorm_ewma``) and are mirrored on the
guard object, ``guard.metrics``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.exceptions import DL4JFaultException

SKIP = "skip"
ROLLBACK = "rollback"

_GUARD_METRICS = None


def _guard_metrics():
    global _GUARD_METRICS
    if _GUARD_METRICS is None:
        from deeplearning4j_tpu_torch.observability.metrics import (
            default_registry,
        )

        reg = default_registry()
        _GUARD_METRICS = (
            reg.counter(
                "guard_spike_trips_total", labels=("signal",),
                help="statistical-guard trips by signal "
                     "(loss | gradnorm)",
            ),
            reg.gauge(
                "guard_loss_ewma",
                help="statistical guard: EWMA of the training loss",
            )._default(),
            reg.gauge(
                "guard_gradnorm_ewma",
                help="statistical guard: EWMA of the gradient "
                     "global norm",
            )._default(),
        )
    return _GUARD_METRICS


def grad_global_norm_sq(grads) -> torch.Tensor:
    """Squared global norm over the floating leaves of ``{layer: {param:
    tensor}}`` (or any nesting of dicts, lists and tuples), summed in
    f32 on the device. An overflow to inf is fine: the guard only asks
    whether the result is finite."""
    total = None
    for leaf in _leaves(grads):
        if leaf.is_floating_point():
            g = leaf.float()
            term = torch.sum(g * g)
            total = term if total is None else total + term
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def divergence_ok(score, grads=None, *, norm_sq=None) -> torch.Tensor:
    """0-d bool tensor: the step's loss and gradients are all finite.
    ``norm_sq``, the gradients' ``grad_global_norm_sq`` where the caller
    has it already, stands in for ``grads``."""
    if norm_sq is None:
        norm_sq = grad_global_norm_sq(grads)
    return torch.logical_and(torch.isfinite(score).reshape(()),
                             torch.isfinite(norm_sq))


def _select(ok, new, old):
    if isinstance(new, dict):
        return {k: _select(ok, v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        return tuple(_select(ok, n, o) for n, o in zip(new, old))
    return torch.where(ok, new, old)


def _same_structure(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return torch.is_tensor(a) and torch.is_tensor(b)


def select_updates(ok, new_params, params, new_upd, upd_state,
                   new_state, state):
    """The step's outputs where ``ok``, else the trees from before the
    step, selected on the device. Layer-state entries whose structure
    changed during the step (a recurrent carry appearing) pass through
    as they are: they are per-minibatch scratch, not trajectory
    state."""
    sel_state = {}
    for ln, st in new_state.items():
        old = state.get(ln, {})
        sel_state[ln] = (_select(ok, st, old) if _same_structure(st, old)
                         else st)
    return (_select(ok, new_params, params),
            _select(ok, new_upd, upd_state), sel_state)


# --- the statistical anomaly guard (the in-step half) ------------------------


@dataclass(frozen=True)
class StatGuardConfig:
    """Knobs of the statistical anomaly guard: ``alpha`` the EWMA
    smoothing factor, ``z_threshold`` the z-score past which a signal
    trips, ``spike_factor`` the multiple of the mean that trips before
    the variance has warmed up to a spike, ``warmup`` the clean samples
    accumulated before either condition arms."""

    alpha: float = 0.02
    z_threshold: float = 6.0
    spike_factor: float = 10.0
    warmup: int = 20


# stable key order: the state dict and its doc both use it
STAT_STATE_KEYS = ("loss_mean", "loss_var", "gnorm_mean", "gnorm_var",
                   "count", "trips_loss", "trips_gnorm")
_INT_KEYS = ("count", "trips_loss", "trips_gnorm")


def stat_guard_state(device=None) -> dict:
    """Fresh EWMA state on ``device``: f32 means and variances, int32
    counts."""
    return {k: torch.zeros((), dtype=torch.int32 if k in _INT_KEYS
                           else torch.float32, device=device)
            for k in STAT_STATE_KEYS}


def _signal_trip(x, mean, var, count, cfg: StatGuardConfig):
    """0-d bool: is this (finite) sample anomalous against its EWMA?"""
    warmed = count >= cfg.warmup
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    z = torch.abs(x - mean) / std
    spike = x > cfg.spike_factor * torch.clamp(mean, min=1e-12)
    return warmed & ((z > cfg.z_threshold) | spike)


def _ewma_fold(mean, var, x, alpha: float, take):
    """One EWMA step where ``take``. ``alpha`` and ``1 - alpha`` are the
    f32 values JAX computes them as, held as Python floats (exact in
    f32), so no host tensor is made in the step (it captures in a CUDA
    graph)."""
    a32 = np.float32(alpha)
    a, one_minus_a = float(a32), float(np.float32(1.0) - a32)
    delta = x - mean
    new_mean = mean + a * delta
    new_var = one_minus_a * (var + a * delta * delta)
    return torch.where(take, new_mean, mean), torch.where(take, new_var, var)


def stat_guard_update(sg: dict, cfg: StatGuardConfig, score, gnorm,
                      finite_ok):
    """One step of the statistical guard: the trip decision and the EWMA
    fold, on the device. Returns ``(ok, new_state)``; ``ok`` is False
    when either signal trips (the caller ANDs it into the select).
    Non-finite and tripped samples stay out of the fold."""
    x_loss = score.float().reshape(())
    x_gn = gnorm.float().reshape(())
    count = sg["count"]
    trip_loss = finite_ok & _signal_trip(x_loss, sg["loss_mean"],
                                         sg["loss_var"], count, cfg)
    trip_gn = finite_ok & _signal_trip(x_gn, sg["gnorm_mean"],
                                       sg["gnorm_var"], count, cfg)
    ok = torch.logical_not(trip_loss | trip_gn)
    take = finite_ok & ok
    loss_mean, loss_var = _ewma_fold(sg["loss_mean"], sg["loss_var"],
                                     x_loss, cfg.alpha, take)
    gn_mean, gn_var = _ewma_fold(sg["gnorm_mean"], sg["gnorm_var"], x_gn,
                                 cfg.alpha, take)
    i32 = torch.int32
    return ok, {
        "loss_mean": loss_mean, "loss_var": loss_var,
        "gnorm_mean": gn_mean, "gnorm_var": gn_var,
        "count": count + take.to(i32),
        "trips_loss": sg["trips_loss"] + trip_loss.to(i32),
        "trips_gnorm": sg["trips_gnorm"] + trip_gn.to(i32),
    }


def stat_guard_state_doc(state: Optional[dict]) -> Optional[dict]:
    """The manifest form of the EWMA state: an f32 is exact in JSON's
    f64, so the round trip back through ``stat_guard_state_from_doc`` is
    bitwise."""
    if state is None:
        return None
    return {k: int(state[k]) if k in _INT_KEYS else float(state[k])
            for k in STAT_STATE_KEYS}


def stat_guard_state_from_doc(doc: dict, device=None) -> dict:
    return {k: torch.tensor(int(doc.get(k, 0)) if k in _INT_KEYS
                            else float(doc.get(k, 0)),
                            dtype=torch.int32 if k in _INT_KEYS
                            else torch.float32, device=device)
            for k in STAT_STATE_KEYS}


class DivergenceGuard:
    """The host-side divergence policy. Construct once and hand to an
    engine's ``set_divergence_guard`` or to
    ``DistributedTrainer(divergence_guard=...)``. With ``stats`` (a
    :class:`StatGuardConfig`, or ``True`` for the defaults) the step
    also threads the statistical anomaly guard. Consulting the guard
    reads the step's ok flag back from the device, which waits for the
    step: the cost of supervision, which the fit loops' dispatch window
    defers by ``guard_lag`` steps."""

    def __init__(self, policy: str = SKIP, checkpoint_manager=None,
                 max_consecutive: int = 10, stats=None):
        if policy not in (SKIP, ROLLBACK):
            raise ValueError(
                f"policy must be '{SKIP}' or '{ROLLBACK}', got {policy!r}")
        if policy == ROLLBACK and checkpoint_manager is None:
            raise ValueError("rollback policy needs a checkpoint_manager")
        self.policy = policy
        self.checkpoint_manager = checkpoint_manager
        self.max_consecutive = max_consecutive
        if stats is True:
            stats = StatGuardConfig()
        if stats is not None and not isinstance(stats, StatGuardConfig):
            raise ValueError("stats must be a StatGuardConfig, True, or "
                             f"None; got {stats!r}")
        self.stats = stats
        self.skipped_steps = 0
        self.rollbacks = 0
        self.consecutive_bad = 0
        # iteration indices whose update was suppressed
        self.skipped_batches: List[int] = []
        # the JAX package's guard metrics, kept here by the same names
        self.metrics = {"guard_spike_trips_total": {"loss": 0,
                                                    "gradnorm": 0},
                        "guard_loss_ewma": 0.0,
                        "guard_gradnorm_ewma": 0.0}

    def good_step(self) -> None:
        self.consecutive_bad = 0

    def publish_stats(self, model) -> None:
        """Mirror the device EWMA state of ``model`` into the registry's
        gauges and its labeled trip counter (the increase since the last
        publish) and into ``metrics`` (the state's own totals). A model
        without statistical-guard state is left alone."""
        state = getattr(model, "_stat_guard_state", None)
        if state is None:
            return
        trips_c, g_loss, g_gn = _guard_metrics()
        self.metrics["guard_loss_ewma"] = float(state["loss_mean"])
        self.metrics["guard_gradnorm_ewma"] = float(state["gnorm_mean"])
        g_loss.set(self.metrics["guard_loss_ewma"])
        g_gn.set(self.metrics["guard_gradnorm_ewma"])
        trips = self.metrics["guard_spike_trips_total"]
        for signal, key in (("loss", "trips_loss"),
                            ("gradnorm", "trips_gnorm")):
            now = int(state[key])
            if now > trips[signal]:
                trips_c.labels(signal).inc(now - trips[signal])
            trips[signal] = now

    def bad_step(self, model, step_index=None, on_restore=None) -> None:
        """One bad step was seen (non-finite, or anomalous when
        ``stats`` is armed); its update was already suppressed in the
        step. Records it and applies the policy: under ``"rollback"``
        the manager's newest restorable checkpoint is restored into
        ``model``, then ``on_restore()`` runs. ``step_index`` names the
        offending step (the dispatch window reads flags late)."""
        from deeplearning4j_tpu_torch.observability import flightrec

        if step_index is None:
            step_index = int(getattr(model, "iteration_count", 0)) - 1
        self.skipped_batches.append(int(step_index))
        if self.stats is not None:
            self.publish_stats(model)
        self.consecutive_bad += 1
        flightrec.record_event("guard_trip", step=int(step_index),
                               policy=self.policy,
                               consecutive=self.consecutive_bad)
        flightrec.dump_on_crash("guard_trip")
        if self.consecutive_bad > self.max_consecutive:
            raise DL4JFaultException(
                f"divergence guard: {self.consecutive_bad} consecutive "
                "non-finite steps — aborting instead of spinning")
        if self.policy == SKIP:
            self.skipped_steps += 1
            return
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            restore_into,
        )

        restore_into(model, self.checkpoint_manager)
        self.rollbacks += 1
        if on_restore is not None:
            on_restore()

    def consult(self, model, ok) -> None:
        """The host policy after one step: read ``ok`` (a device sync)
        and record a good or a bad step."""
        if bool(ok):
            self.good_step()
        else:
            self.bad_step(model)


# --- checkpoint-manifest capture and apply -----------------------------------


def guard_state_doc(model) -> Optional[dict]:
    """The manifest ``guard`` field of ``model``: the statistical
    guard's EWMA state (bitwise-exact floats) and the guard's
    skipped-batch ledger (a ``DistributedTrainer`` keeps its guard
    apart and leaves the model a ``_ckpt_guard`` reference to it); None
    when nothing is armed."""
    guard = (getattr(model, "divergence_guard", None)
             or getattr(model, "_ckpt_guard", None))
    sg = getattr(model, "_stat_guard_state", None)
    doc: dict = {}
    if sg is not None:
        doc["ewma"] = stat_guard_state_doc(sg)
        if guard is not None:
            guard.publish_stats(model)
    if guard is not None:
        doc["skipped"] = [int(i) for i in guard.skipped_batches]
        if guard.skipped_steps:
            doc["skipped_steps"] = int(guard.skipped_steps)
        if guard.rollbacks:
            doc["rollbacks"] = int(guard.rollbacks)
    data = getattr(model, "_data_ledger", None)
    if data:
        doc["data"] = dict(data)
    return doc or None


def apply_guard_state_doc(model, doc: Optional[dict]) -> None:
    """The inverse of ``guard_state_doc``: the EWMA state (on the
    model's device) and the ledger back onto ``model`` and its guard,
    so a resumed run makes the same trip decisions."""
    if not doc:
        return
    ewma = doc.get("ewma")
    if ewma is not None:
        model._stat_guard_state = stat_guard_state_from_doc(
            ewma, getattr(model, "device", None))
    guard = (getattr(model, "divergence_guard", None)
             or getattr(model, "_ckpt_guard", None))
    if guard is not None:
        guard.skipped_batches = [int(i) for i in doc.get("skipped", [])]
        guard.skipped_steps = int(doc.get("skipped_steps", 0))
        guard.rollbacks = int(doc.get("rollbacks", 0))
        if ewma is not None:
            guard.metrics["guard_spike_trips_total"] = {
                "loss": int(ewma.get("trips_loss", 0)),
                "gradnorm": int(ewma.get("trips_gnorm", 0))}
    if doc.get("data"):
        model._data_ledger = dict(doc["data"])

"""Elastic data-parallel training: heartbeat liveness, host-RAM
snapshot ring, survivor-world recovery, straggler detection.

Counterpart of ``deeplearning4j_tpu/parallel/elastic.py``. A lost rank
kills a collective outright: the all-reduce hangs or fails, the run
dies, and everything since the last published checkpoint is gone. The
reference got elasticity from Spark (a lost worker's partition is
re-run); this module is the per-step-training equivalent, and it
recovers WITHOUT disk I/O:

- :class:`HeartbeatMonitor`: per-shard heartbeats with a timeout; a
  shard silent for ``timeout`` seconds is declared dead
  (``heartbeat_missed_total{shard=}``). Chaos tests inject death with
  :meth:`HeartbeatMonitor.mark_dead`.
- :class:`SnapshotRing`: a small ring of full training snapshots
  (parameters, updater state, layer state, the ``nn/random.py`` base
  key, step and epoch counters) copied to host RAM every K steps.
  Recovery restores the newest entry, so a run loses at most
  ``snapshot_every - 1`` steps.
- :class:`ElasticTrainer`: wraps :class:`~.trainer.DistributedTrainer`.
  The JAX package drives every device from one process and rebuilds
  its mesh over the surviving devices in-process; here one process
  drives one device, so a shard is a rank of the ``torch.distributed``
  world (named by its rank in the first world). Every rank calls
  :meth:`ElasticTrainer.inject_device_loss` at the same step (the chaos
  listener); at the next step boundary each survivor re-forms the group
  over the survivors (ranks renumbered in survivor order, through a
  rendezvous every rank derives alike from the first one and the
  recovery count; a ``file://`` store is never reused), rolls back to
  the newest snapshot and builds a fresh trainer, which re-places (and
  for ZeRO re-shards) the state. A rank declared dead leaves the group
  and raises :class:`DeviceLostException`. The trajectory stays exact:
  the restored step counter re-derives the same dropout keys, learning
  rates and updater ``t``.
- :class:`StragglerDetector`: per-shard step-time EWMA; a shard whose
  EWMA exceeds ``factor`` x the median of its peers' is flagged
  (``straggler_detected_total{shard=}``).
- :class:`HostElasticTrainer`: the same recovery driven by the
  control plane's lease coordinator (``control_plane.WorkerAgent``)
  across processes that may die outright (SIGKILL).

Elasticity is data-parallel only (``tensor_parallel=True`` is
refused): a tensor-parallel weight shard on a dead device has no
replica to recover from.
"""

from __future__ import annotations

import collections
import logging
import random
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.exceptions import DL4JFaultException
from deeplearning4j_tpu_torch.parallel.mesh import build_mesh
from deeplearning4j_tpu_torch.parallel.trainer import DistributedTrainer

logger = logging.getLogger(__name__)


def _default_registry():
    from deeplearning4j_tpu_torch.observability.metrics import (
        default_registry,
    )

    return default_registry()


def _mean_score(scores: Dict[int, object]) -> float:
    """The mean of an epoch's step scores (0-d tensors or floats), read
    once."""
    vals = [scores[k] for k in sorted(scores)]
    if not vals:
        return float("nan")
    return float(torch.stack([(v if torch.is_tensor(v) else torch.tensor(v))
                              .detach().double().cpu() for v in vals]).mean())


def _epoch_listeners(model, hook: str) -> None:
    for listener in model.listeners:
        if hasattr(listener, hook):
            getattr(listener, hook)(model)


class DeviceLostException(DL4JFaultException):
    """A shard was declared dead and recovery was impossible (no
    snapshot, no survivors left), or this rank is the one declared
    dead."""

    def __init__(self, message: str, dead: Sequence[str] = ()):
        super().__init__(message)
        self.dead = tuple(dead)


class HeartbeatMonitor:
    """Liveness ledger: every shard must beat every step; silence
    past ``timeout`` seconds means dead. The clock is injectable so
    tests advance time by hand instead of sleeping.

    ``epoch`` tracks the control-plane membership epoch the ledger
    belongs to: ``reset`` advances it, and :meth:`clear` un-declares a
    shard only when the caller proves it holds the CURRENT epoch (a
    rejoined member is welcomed back, a zombie clearing itself with a
    stale epoch is not)."""

    def __init__(self, shards: Sequence[str], timeout: float = 30.0,
                 clock=time.monotonic, jitter: float = 0.0,
                 seed: Optional[int] = None, registry=None):
        if timeout <= 0:
            raise ValueError("heartbeat timeout must be > 0")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.timeout = float(timeout)
        self.clock = clock
        self.jitter = float(jitter)
        self.epoch = 0
        registry = registry if registry is not None else _default_registry()
        self._m_missed = registry.counter(
            "heartbeat_missed_total",
            help="shards declared dead after a heartbeat timeout",
            labels=("shard",),
        )
        self._seed = 0 if seed is None else int(seed)
        self._rngs: Dict[str, random.Random] = {}
        self._last: Dict[str, float] = {}
        self._declared: set = set()
        self._counted: set = set()
        self.reset(shards)

    def reset(self, shards: Sequence[str]) -> None:
        """Restart the ledger over ``shards`` (after a recovery: the
        survivor set) and advance the epoch. Everyone gets a fresh
        grace period."""
        now = self.clock()
        self._last = {str(s): now for s in shards}
        self._declared = set()
        self._counted = set()
        self.epoch += 1
        # a rng per shard seeded by (seed, shard id) decorrelates each
        # shard's beat cadence from its peers'; crc32, not hash(): the
        # latter is salted per process
        self._rngs = {s: random.Random(self._shard_seed(s))
                      for s in self._last}

    def _shard_seed(self, shard: str) -> int:
        return (self._seed << 32) ^ zlib.crc32(str(shard).encode())

    def next_interval(self, shard) -> float:
        """The shard's next beat interval: a third of the timeout,
        jittered by its own seeded rng. Deterministic per (seed,
        shard): two ranks never share a schedule."""
        s = str(shard)
        rng = self._rngs.get(s)
        if rng is None:
            raise KeyError(f"unknown shard {s!r}")
        base = self.timeout / 3.0
        if self.jitter <= 0.0:
            return base
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def clear(self, shard, epoch: int) -> bool:
        """Epoch-fenced un-declare: a member readmitted at control
        epoch ``epoch`` stops being sticky-dead, but only if that IS
        the current epoch (a zombie's stale clear is refused). Returns
        whether the shard is alive afterwards."""
        s = str(shard)
        if int(epoch) != self.epoch:
            logger.warning(
                "heartbeat clear refused for shard %s: epoch %d != "
                "current %d", s, int(epoch), self.epoch)
            return False
        self._declared.discard(s)
        self._counted.discard(s)
        self._last[s] = self.clock()
        self._rngs.setdefault(s, random.Random(self._shard_seed(s)))
        return True

    @property
    def shards(self) -> List[str]:
        return list(self._last)

    def beat(self, shard, step: Optional[int] = None) -> None:
        """Record a heartbeat. Beats from a shard already declared dead
        are ignored: death is sticky until ``reset`` (a zombie host must
        not rejoin mid-world)."""
        s = str(shard)
        if s in self._declared:
            return
        if s not in self._last:
            raise KeyError(f"unknown shard {s!r}")
        self._last[s] = self.clock()

    def mark_dead(self, shard) -> None:
        """Chaos injection: declare ``shard`` dead at once (the
        simulated loss, as if its heartbeats had timed out)."""
        s = str(shard)
        if s not in self._last:
            raise KeyError(f"unknown shard {s!r}")
        self._declared.add(s)

    def dead(self) -> List[str]:
        """Shards currently declared dead (injected or timed out). The
        first transition of each shard increments
        ``heartbeat_missed_total{shard=}``."""
        now = self.clock()
        out = set(self._declared)
        for s, t in self._last.items():
            if now - t >= self.timeout:
                out.add(s)
        for s in out - self._counted:
            self._counted.add(s)
            self._m_missed.labels(s).inc()
            logger.warning("shard %s declared dead (no heartbeat)", s)
        return sorted(out)

    def alive(self) -> List[str]:
        gone = set(self.dead())
        return [s for s in self._last if s not in gone]


class StragglerDetector:
    """Per-shard step-time EWMA -> straggler flag. A shard is a
    straggler while its EWMA exceeds ``factor`` x the median of the
    OTHER shards' EWMAs (after ``warmup`` observations each); entering
    the state increments ``straggler_detected_total``."""

    def __init__(self, alpha: float = 0.3, factor: float = 2.0,
                 warmup: int = 3, registry=None):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        if factor <= 1:
            raise ValueError("factor must be > 1")
        self.alpha = float(alpha)
        self.factor = float(factor)
        self.warmup = int(warmup)
        registry = registry if registry is not None else _default_registry()
        self._m_straggler = registry.counter(
            "straggler_detected_total",
            help="shards whose step-time EWMA exceeded factor x the "
                 "median of their peers'",
            labels=("shard",),
        )
        self._ewma: Dict[str, float] = {}
        self._n: Dict[str, int] = collections.defaultdict(int)
        self._flagged: set = set()

    def observe(self, shard, step_time_s: float) -> None:
        s = str(shard)
        prev = self._ewma.get(s)
        self._ewma[s] = (
            step_time_s if prev is None
            else self.alpha * step_time_s + (1 - self.alpha) * prev
        )
        self._n[s] += 1

    def ewma(self, shard) -> Optional[float]:
        return self._ewma.get(str(shard))

    def stragglers(self) -> List[str]:
        """Current stragglers; transitions into the state count."""
        warm = {s: v for s, v in self._ewma.items()
                if self._n[s] >= self.warmup}
        current = set()
        if len(warm) >= 2:
            for s, v in warm.items():
                peers = [w for p, w in warm.items() if p != s]
                if v > self.factor * float(np.median(peers)):
                    current.add(s)
        for s in sorted(current - self._flagged):
            self._m_straggler.labels(s).inc()
            logger.warning("shard %s is straggling (ewma %.4fs)",
                           s, self._ewma[s])
        self._flagged = current
        return sorted(current)

    def forget(self, shard) -> None:
        """Drop a shard's history (after a recovery: it left)."""
        s = str(shard)
        self._ewma.pop(s, None)
        self._n.pop(s, None)
        self._flagged.discard(s)


class SnapshotRing:
    """Bounded ring of host-RAM training snapshots. Each ``push``
    copies the parameters, updater state, layer state, the
    ``nn/random.py`` base key and the step and epoch counters off the
    device into fresh CPU tensors: the ring shares no storage with the
    live model, so an update after the snapshot can never corrupt a
    recovery point. ``restore_into_model`` puts each tensor back on the
    model's device as a fresh copy in fresh dicts (never a captured
    chunk's static tensors); the next trainer re-places it. No disk
    I/O."""

    def __init__(self, capacity: int = 2, registry=None):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        registry = registry if registry is not None else _default_registry()
        self._m_saves = registry.counter(
            "snapshot_ring_saves_total",
            help="host-RAM recovery snapshots taken",
        )._default()

    @staticmethod
    def _host(tree):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            host_snapshot_tree,
        )

        return host_snapshot_tree(tree)

    @staticmethod
    def _base_key(model) -> np.ndarray:
        """The model's base key ``PRNGKey(conf.seed)`` (JAX
        ``model._base_key``) as uint32 words."""
        from deeplearning4j_tpu_torch.nn import random as nn_random

        return np.array(nn_random.host_key(model.conf.seed), dtype=np.uint32)

    def push(self, model, epoch_index: int = 0) -> dict:
        """Snapshot ``model`` at its current step. ``epoch_index`` is
        the batch index within the current epoch (so the fit loop can
        replay from the right batch after a rollback).

        ZeRO-sharded updater state (``model._zero_layout``) is gathered
        to its canonical shapes first (a collective: every rank pushes
        at the same step): the ring holds ONE host copy of each moment,
        never N padded slices, and it re-shards onto whatever world
        recovery builds. Row-sharded embedding tables are gathered the
        same way."""
        from deeplearning4j_tpu_torch.nn import core

        params, upd = core.canonical_trees(model)
        snap = {
            "step": int(model.iteration_count),
            "epoch": int(model.epoch_count),
            "epoch_index": int(epoch_index),
            "params": self._host(params),
            "updater_state": self._host(upd),
            "state": self._host(model.state),
            "rng": self._base_key(model),
        }
        self._ring.append(snap)
        self._m_saves.inc()
        return snap

    def latest(self) -> Optional[dict]:
        return self._ring[-1] if self._ring else None

    def __len__(self) -> int:
        return len(self._ring)

    def restore_into_model(self, model) -> dict:
        """Roll ``model`` back to the newest snapshot (fresh copies on
        the model's device; the caller's next trainer re-places them).
        Raises ``DeviceLostException`` when the ring is empty."""
        from deeplearning4j_tpu_torch.util.model_serializer import _map_leaves

        snap = self.latest()
        if snap is None:
            raise DeviceLostException(
                "no recovery snapshot in the ring"
            )
        if not np.array_equal(snap["rng"], self._base_key(model)):
            raise ValueError("the snapshot's base key is not this model's "
                             "(a snapshot of another configuration)")
        dev = model.device

        def back(tree):
            return _map_leaves(lambda t: t.to(dev, copy=True), tree)

        model.params = back(snap["params"])
        model.updater_state = back(snap["updater_state"])
        model.state = back(snap["state"])
        # ring snapshots are canonical-shaped: any ZeRO flat layout is
        # gone until the next trainer re-places (and re-shards) state
        model._zero_layout = None
        model._row_layout = None
        model._tp_layout = None
        model.iteration_count = snap["step"]
        model.epoch_count = snap["epoch"]
        return snap


REFORM_TIMEOUT_S = 60.0  # ElasticTrainer: the survivors' re-formation


def derive_rendezvous(first: str, recovery: int) -> str:
    """The rendezvous of the world formed at recovery ``recovery`` (1,
    2, ...), derived alike on every rank from the first world's:
    ``file:///p`` -> ``file:///p.elastic<k>`` (a file store is never
    reused), ``tcp://host:port`` -> ``tcp://host:<port + k>``."""
    k = int(recovery)
    if first.startswith("file://"):
        return f"{first}.elastic{k}"
    if first.startswith("tcp://"):
        host, _, port = first[len("tcp://"):].rpartition(":")
        return f"tcp://{host}:{int(port) + k}"
    raise ValueError(f"unsupported rendezvous {first!r} (file:// or tcp://)")


class ElasticTrainer:
    """Data-parallel training that survives the loss of ranks (module
    docstring). Wraps a :class:`DistributedTrainer`; drives the same
    ``fit_minibatch`` step, adding per-step heartbeats, periodic
    host-RAM snapshots, straggler EWMAs and, on a declared death,
    survivor-world re-formation + snapshot rollback + replay.

    A re-formation derives its rendezvous from the one this process's
    world was formed through (``derive_rendezvous``) and waits at most
    ``REFORM_TIMEOUT_S`` for the survivors. ``fit`` materializes the
    iterator (elastic replay needs random access to the current epoch's
    batches)."""

    def __init__(self, model, mesh=None, *, snapshot_every: int = 8,
                 ring_capacity: int = 2, heartbeat_timeout: float = 30.0,
                 straggler_factor: float = 2.0, clock=time.monotonic,
                 registry=None, **trainer_kwargs):
        from deeplearning4j_tpu_torch.parallel.mesh import world_rendezvous

        if trainer_kwargs.get("tensor_parallel"):
            raise ValueError(
                "ElasticTrainer is data-parallel only: a dead "
                "device's tensor-parallel weight shard has no "
                "surviving replica (use checkpoint restore instead)"
            )
        self.model = model
        self.clock = clock
        self._trainer_kwargs = dict(trainer_kwargs)
        self.trainer = DistributedTrainer(model, mesh=mesh,
                                          **self._trainer_kwargs)
        self.rendezvous = world_rendezvous()
        # shards are named by their rank in the first world
        self._ranks = list(range(self.trainer.mesh.data))
        self.origin_rank = self.trainer.mesh.rank
        self.snapshot_every = max(int(snapshot_every), 1)
        registry = registry if registry is not None else _default_registry()
        self.ring = SnapshotRing(ring_capacity, registry=registry)
        self.monitor = HeartbeatMonitor(
            self._shard_names(), timeout=heartbeat_timeout,
            clock=clock, registry=registry,
        )
        self.straggler = StragglerDetector(
            factor=straggler_factor, registry=registry,
        )
        self._m_recoveries = registry.counter(
            "elastic_recoveries_total",
            help="survivor-world recoveries after device loss",
        )._default()
        self._m_recovery_ms = registry.summary(
            "elastic_recovery_ms",
            help="device-loss recovery latency: snapshot rollback + "
                 "survivor-world re-formation + re-placement (ms)",
        )._default()
        self._m_devices = registry.gauge(
            "elastic_mesh_devices",
            help="devices in the current training world",
        )._default()
        self._m_devices.set(len(self.devices()))
        self.recoveries = 0

    # -- world introspection --------------------------------------------

    @property
    def mesh(self):
        return self.trainer.mesh

    def devices(self) -> List[int]:
        """The ranks (in the first world's numbering) of the current
        world, one device each."""
        return list(self._ranks)

    def _shard_names(self) -> List[str]:
        return [str(r) for r in self._ranks]

    # -- chaos hooks ----------------------------------------------------

    def inject_device_loss(self, shards) -> None:
        """Chaos: declare the given shards (first-world ranks, or their
        string names) dead; the next step boundary recovers onto the
        survivors. Every rank calls it at the same step."""
        for s in shards:
            self.monitor.mark_dead(s)

    # -- recovery -------------------------------------------------------

    def _reform(self, survivors: List[int]):
        """Leave the current world and join the survivors' (this rank's
        new rank: its place among them)."""
        from deeplearning4j_tpu_torch.parallel.mesh import (
            init_distributed,
            shutdown_distributed,
        )

        backend = self.mesh.backend
        shutdown_distributed()
        init_distributed(derive_rendezvous(self.rendezvous,
                                           self.recoveries + 1),
                         len(survivors), survivors.index(self.origin_rank),
                         device=self.model.device, backend=backend,
                         timeout_s=REFORM_TIMEOUT_S)
        return build_mesh(data=len(survivors))

    def recover(self, dead: Sequence[str]) -> dict:
        """Roll back to the newest snapshot and rebuild over the
        survivors. Returns the snapshot used. Raises
        ``DeviceLostException`` when nothing survives, when no snapshot
        exists, or on a rank that is itself declared dead (it leaves
        the world first)."""
        from deeplearning4j_tpu_torch.parallel.mesh import (
            shutdown_distributed,
        )

        t0 = self.clock()
        dead = {str(s) for s in dead}
        survivors = [r for r in self._ranks if str(r) not in dead]
        if not survivors:
            raise DeviceLostException(
                f"all {len(dead)} shards lost; nothing to rebuild on",
                dead=sorted(dead),
            )
        if str(self.origin_rank) in dead:
            shutdown_distributed()
            raise DeviceLostException(
                f"rank {self.origin_rank} was declared dead and left the "
                "world", dead=sorted(dead))
        snap = self.ring.restore_into_model(self.model)
        new_mesh = self._reform(survivors)
        # a fresh DistributedTrainer broadcasts and re-places the
        # restored state over the survivor world (and re-shards ZeRO)
        self.trainer = DistributedTrainer(self.model, mesh=new_mesh,
                                          **self._trainer_kwargs)
        self._ranks = survivors
        for s in dead:
            self.straggler.forget(s)
        self.monitor.reset(self._shard_names())
        self.recoveries += 1
        self._m_recoveries.inc()
        self._m_devices.set(len(survivors))
        self._m_recovery_ms.observe((self.clock() - t0) * 1000.0)
        logger.warning(
            "recovered from loss of %s: %d survivors, rolled back to "
            "step %d", sorted(dead), len(survivors), snap["step"],
        )
        return snap

    # -- the elastic fit loop -------------------------------------------

    def fit(self, batches, epochs: int = 1) -> list:
        """Fit ``epochs`` passes over ``batches`` (materialized), one
        optimizer step per batch, with liveness and snapshots at every
        step boundary. Returns per-epoch mean scores, as
        ``DistributedTrainer.fit``."""
        from deeplearning4j_tpu_torch.resilience import preemption

        batches = list(batches)
        m = self.model
        epoch_scores = []
        for _ in range(epochs):
            _epoch_listeners(m, "on_epoch_start")
            scores: Dict[int, object] = {}
            i = 0
            steps_since_snap = None  # force a snapshot at epoch start
            while i < len(batches):
                preemption.check_fit(m)
                if steps_since_snap is None or (
                    steps_since_snap >= self.snapshot_every
                ):
                    self.ring.push(m, epoch_index=i)
                    steps_since_snap = 0
                dead = self.monitor.dead()
                if dead:
                    snap = self.recover(dead)
                    i = snap["epoch_index"]
                    scores = {k: v for k, v in scores.items() if k < i}
                    steps_since_snap = 0
                    continue
                t0 = self.clock()
                scores[i] = self.trainer.fit_minibatch(batches[i])
                dt = self.clock() - t0
                for s in self.monitor.shards:
                    self.monitor.beat(s)
                    self.straggler.observe(s, dt)
                self.straggler.stragglers()
                steps_since_snap += 1
                i += 1
            epoch_scores.append(_mean_score(scores))
            _epoch_listeners(m, "on_epoch_end")
            m.epoch_count += 1
        return epoch_scores


class HostElasticTrainer:
    """Cross-HOST elastic training: one per worker process, driven by
    a ``control_plane.WorkerAgent``. Extends the
    :class:`ElasticTrainer` recipe to the loss of a whole process:

    - every step ends at a coordinator **barrier** (which doubles as a
      lease renewal), so all survivors agree on the recovery point;
    - every K steps each worker pushes a host-RAM snapshot, in
      lockstep, because the barrier keeps step counters aligned;
    - when the barrier returns a :class:`~.control_plane.RecoveryPlan`
      (a peer's lease expired, or a member was admitted), recovery
      runs: adopt the plan (renewals go on under the new epoch while
      the world is rebuilt), leave the old process group and join the
      survivors' over the plan's fresh rendezvous
      (``mesh.reform_distributed``), roll back to the newest ring
      snapshot, and hand the restored canonical state to a fresh
      :class:`~.trainer.DistributedTrainer`, which re-places (for ZeRO
      re-shards) it onto the smaller world;
    - **coordinator loss** degrades gracefully: a checkpoint (when a
      manager is configured) and a ``PreemptedException`` (reason
      ``"coordinator-lost"``), so ``exit_on_preemption`` exits 75/76
      instead of hanging;
    - a **fence** (this host was declared dead but is alive, e.g.
      un-partitioned) propagates without a save: a zombie's state is
      never checkpointed.

    Trajectory equivalence is the piecewise claim of
    ``ElasticTrainer``: full width to the snapshot, survivor width
    after. ``reform`` (a callable ``plan -> mesh``) replaces the
    default re-formation."""

    def __init__(self, model, agent, *, mesh=None,
                 snapshot_every: int = 8, ring_capacity: int = 2,
                 checkpoint_manager=None, reform=None,
                 reform_timeout_s: float = 30.0, clock=time.monotonic,
                 registry=None, **trainer_kwargs):
        if trainer_kwargs.get("tensor_parallel"):
            raise ValueError(
                "HostElasticTrainer is data-parallel only: a dead "
                "host's tensor-parallel weight shard has no "
                "surviving replica (use checkpoint restore instead)"
            )
        self.model = model
        self.agent = agent
        self.clock = clock
        self._trainer_kwargs = dict(trainer_kwargs)
        self.trainer = DistributedTrainer(model, mesh=mesh,
                                          **self._trainer_kwargs)
        self.snapshot_every = max(int(snapshot_every), 1)
        registry = registry if registry is not None else _default_registry()
        self.ring = SnapshotRing(ring_capacity, registry=registry)
        self.manager = checkpoint_manager
        self._reform = reform
        self.reform_timeout_s = float(reform_timeout_s)
        self._m_recoveries = registry.counter(
            "host_recoveries_total",
            help="host-loss recoveries: the world re-formed over the "
                 "survivor process set",
        )._default()
        self._m_recovery_ms = registry.summary(
            "host_recovery_ms",
            help="host-loss recovery latency: process-group "
                 "re-formation + snapshot rollback + re-placement (ms)",
        )._default()
        self.recoveries = 0
        self.last_recovery: Optional[dict] = None
        self.last_recovery_snapshot: Optional[dict] = None

    @property
    def mesh(self):
        return self.trainer.mesh

    # -- recovery --------------------------------------------------------

    def _reform_mesh(self, plan):
        if self._reform is not None:
            return self._reform(plan)
        from deeplearning4j_tpu_torch.parallel.mesh import reform_distributed

        return reform_distributed(plan, device=self.model.device,
                                  backend=self.mesh.backend,
                                  timeout_s=self.reform_timeout_s)

    def recover(self, plan) -> dict:
        """Execute a recovery plan: the new epoch adopted first (so the
        renewal thread keeps the lease alive under it while the world
        re-forms), then the re-formation, then ring rollback + a fresh
        trainer. Returns the snapshot restored."""
        from deeplearning4j_tpu_torch.observability import flightrec
        from deeplearning4j_tpu_torch.observability.trace import get_tracer

        t0 = self.clock()
        with get_tracer().start_span(
                "control.host_recover",
                attrs={"epoch": plan.epoch,
                       "survivors": plan.num}) as span:
            self.agent.adopt(plan)
            new_mesh = self._reform_mesh(plan)
            snap = self.ring.restore_into_model(self.model)
            self.trainer = DistributedTrainer(
                self.model, mesh=new_mesh, **self._trainer_kwargs)
            span.set_attr("rolled_back_to", snap["step"])
        dt_ms = (self.clock() - t0) * 1000.0
        self.recoveries += 1
        self._m_recoveries.inc()
        self._m_recovery_ms.observe(dt_ms)
        self.last_recovery = {
            "epoch": plan.epoch, "term": plan.term,
            "dead": list(plan.dead), "admitted": list(plan.admitted),
            "survivors": plan.num,
            "rolled_back_to": snap["step"],
        }
        self.last_recovery_snapshot = snap
        flightrec.record_event(
            "host_recovery", epoch=plan.epoch, dead=list(plan.dead),
            survivors=plan.num, rolled_back_to=snap["step"],
            ms=round(dt_ms, 3))
        logger.warning(
            "host recovery: epoch %d, dead=%s, %d survivors, rolled "
            "back to step %d in %.0fms", plan.epoch, list(plan.dead),
            plan.num, snap["step"], dt_ms)
        return snap

    def _coordinator_lost(self, step: int, cause) -> None:
        """Membership truth is gone: checkpoint what we have and exit
        through the preemption machinery (75 with a checkpoint, 76
        without) instead of hanging or training a partitioned brain.
        The save is synchronous: it has landed when this raises."""
        from deeplearning4j_tpu_torch.observability import flightrec
        from deeplearning4j_tpu_torch.resilience.preemption import (
            PreemptedException,
        )

        info = None
        failed = False
        if self.manager is not None:
            try:
                info = self.manager.save(self.model, mode="sync")
            except Exception as e:
                failed = True
                logger.error(
                    "coordinator lost AND the exit checkpoint "
                    "failed: %r", e)
        flightrec.record_event("coordinator_lost", step=int(step),
                               checkpointed=info is not None)
        raise PreemptedException(
            f"control coordinator lost at step {step}; "
            + ("checkpoint saved" if info is not None
               else "no checkpoint manager configured" if not failed
               else "checkpoint FAILED"),
            step=int(step), checkpoint=info, checkpoint_failed=failed,
            reason="coordinator-lost",
        ) from cause

    def _step_barrier(self, step: int):
        from deeplearning4j_tpu_torch.parallel.control_plane import (
            CoordinatorLostException,
        )

        try:
            return self.agent.step_barrier(step)
        except CoordinatorLostException as e:
            self._coordinator_lost(step, e)
        # HostFencedException propagates: zombie state stays un-saved

    # -- the cross-host fit loop ----------------------------------------

    def fit(self, batches, epochs: int = 1) -> list:
        """Fit ``epochs`` passes over ``batches`` (materialized), one
        optimizer step per batch, a coordinator barrier at every step
        boundary, a lockstep snapshot every ``snapshot_every`` steps.
        Returns per-epoch mean scores, as ``DistributedTrainer.fit``."""
        from deeplearning4j_tpu_torch.parallel import control_plane
        from deeplearning4j_tpu_torch.resilience import preemption

        batches = list(batches)
        m = self.model
        epoch_scores = []
        control_plane.install_agent(self.agent)
        try:
            for _ in range(epochs):
                _epoch_listeners(m, "on_epoch_start")
                scores: Dict[int, object] = {}
                i = 0
                steps_since_snap = None  # snapshot at epoch start
                while i < len(batches):
                    preemption.check_fit(m)
                    if steps_since_snap is None or (
                        steps_since_snap >= self.snapshot_every
                    ):
                        self.ring.push(m, epoch_index=i)
                        steps_since_snap = 0
                    plan = self._step_barrier(m.iteration_count)
                    if plan is not None:
                        snap = self.recover(plan)
                        i = snap["epoch_index"]
                        scores = {k: v for k, v in scores.items()
                                  if k < i}
                        steps_since_snap = 0
                        continue
                    scores[i] = self.trainer.fit_minibatch(batches[i])
                    steps_since_snap += 1
                    i += 1
                epoch_scores.append(_mean_score(scores))
                _epoch_listeners(m, "on_epoch_end")
                m.epoch_count += 1
        finally:
            control_plane.uninstall_agent(self.agent)
        return epoch_scores

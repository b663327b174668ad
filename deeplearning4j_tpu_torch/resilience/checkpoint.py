"""Atomic, versioned, write-behind training checkpoints with a sharded
two-phase commit and background scrub and repair.

Counterpart of ``deeplearning4j_tpu/resilience/checkpoint.py``, with
its directory layout, file names, manifest keys and CRC-32, so each
package restores the other's directories. Every checkpoint is:

- **atomic and durable**: staged to a temp file, fsync'd,
  ``os.replace``d into place, the directory fsync'd;
- **versioned**: ``<prefix>-<step 8 digits>.zip`` by the model's
  iteration count, ``keep_last`` retained (``protect`` names steps
  pruning never deletes);
- **verified**: a manifest records step, epoch, CRC-32 and size;
  restore checks the bytes and falls back to the previous version when
  the newest fails, raising ``CheckpointCorruptedException`` only when
  none survives.

Manifest format 1 (one zip), ``<prefix>-<step>.json``:

    {"format": 1, "step": 128, "epoch": 2,
     "file": "checkpoint-00000128.zip", "crc32": ..., "size": ...}

Manifest format 2 (sharded), ``<prefix>-<step>/manifest.json``:

    {"format": 2, "step": 128, "epoch": 2, "dir": "checkpoint-00000128",
     "nshards": 2, "shards": {"0": {"file": "shard-0.npz", "crc32": ..,
     "size": .., "keys": 7}, ...}, "model": {"model_type": ..,
     "configuration": {..}, "iteration_count": 128, "epoch_count": 2}}

**Write-behind saves** (``mode="async"``): the training thread only
takes the snapshot. On the card that is non-blocking copies of the
parameters, updater state and layer state into one of two pinned
staging sets, enqueued on the compute stream with an event recorded
after them: the steps enqueued later write those tensors (a graphed
megastep chunk ``copy_``s into them in place) only once the copies have
read them, and the writer thread waits on the event before it
serializes. The stall the training thread sees (``checkpoint_stall_ms``)
is the launch of the copies. Serialization, CRC, manifest, replica
mirroring and pruning run on one background writer; at most one save
is queued besides the one being written, and a newer save supersedes
the queued one (its handle resolves None with ``superseded``).
``flush()`` drains the writer, ``stop()`` joins it, and a synchronous
save (the preemption path) flushes first.

**Sharded layout and two-phase commit** (``commit=`` a barrier): each
rank writes its slice of the flat state map (sorted keys dealt
round-robin) to ``<prefix>-<step>/shard-<rank>.npz``; every rank
arrives at a barrier with its shard's digest, rank 0 writes
``manifest.json`` last as the commit point, and a second barrier
releases the peers. A directory without a manifest is uncommitted:
``available()`` ignores it and GC removes it. ``LocalCommitBarrier``
is the one-process barrier and ``ProcessGroupCommitBarrier`` the
port's over a ``torch.distributed`` world; ``LeaseCommitBarrier`` rides
the control plane's lease coordinator (``parallel/control_plane.py``).

**Scrub and repair**: ``scrub_once()`` (or the background scrubber)
re-verifies every retained checkpoint's CRCs at shard granularity,
repairs a corrupt component from ``replica_store`` (a second
``ObjectStore`` every committed checkpoint is mirrored to) when the
replica's bytes match the manifest, and quarantines the step
otherwise; restore walks back past a quarantined step. ``artifacts``
are named side blobs under the same CRC bookkeeping that never gate a
model restore. ``CheckpointListener`` plugs a manager into any fit loop
through the ``IterationListener`` SPI. Metrics (the JAX package's
names): ``checkpoint_async_pending``, ``checkpoint_write_ms``,
``checkpoint_stall_ms``, ``checkpoint_commit_barrier_ms``,
``checkpoint_scrub_corrupt_total``, ``checkpoint_repair_total``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import shutil
import threading
import time
import zipfile
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.exceptions import (
    CheckpointCommitAbortedException, CheckpointCorruptedException,
)
from deeplearning4j_tpu_torch.observability import flightrec
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

logger = logging.getLogger(__name__)

MANIFEST_FORMAT = 1
SHARDED_MANIFEST_FORMAT = 2


def _default_registry():
    from deeplearning4j_tpu_torch.observability.metrics import default_registry

    return default_registry()


def atomic_write_bytes(path, data: bytes) -> None:
    """Durably write ``data`` to ``path``: temp file in the same
    directory, fsync, ``os.replace``, directory fsync."""
    from deeplearning4j_tpu_torch.util import model_serializer

    model_serializer.atomic_write_bytes(path, data)


def _crc32_of(path, chunk: int = 1 << 20) -> Tuple[int, int]:
    """(crc32, size) of a file, streamed."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            crc = zlib.crc32(b, crc)
            size += len(b)
    return crc & 0xFFFFFFFF, size


@dataclass(frozen=True)
class CheckpointInfo:
    """One verified-writable checkpoint version. ``artifacts`` maps
    artifact name -> {file, crc32, size} for side blobs (the flight
    recorder's dump of an emergency save) that ride the manifest's CRC
    story without gating the model restore. Format-2 (sharded) versions carry ``nshards``
    / ``shards`` / ``dir`` / ``model`` instead of a single zip's
    crc32/size."""

    step: int
    epoch: int
    file: str   # zip filename (format 1) / directory name (format 2)
    crc32: int
    size: int
    format: int = MANIFEST_FORMAT
    artifacts: dict = field(default_factory=dict)
    # ZeRO layout the model trained under at save time (e.g.
    # {"shards": 8}) — informational: the checkpoint always holds
    # canonical (gathered) updater state, so restore works on ANY
    # mesh; the field lets operators see which runs were sharded.
    # Manifests without it parse as zero=None.
    zero: Optional[dict] = None
    # Anomaly-defense trajectory state (resilience.guard_state_doc):
    # statistical-guard EWMA scalars as bitwise-exact floats, the
    # guard's skipped-batch ledger, and the data-plane quarantine
    # ledger. Restoring it makes a killed+resumed defended run replay
    # the identical skip decisions. Manifests without it parse as
    # guard=None.
    guard: Optional[dict] = None
    # sharded (format 2) fields: shard count, per-shard digests
    # ({"<rank>": {"file", "crc32", "size", "keys"}}), the directory
    # name, and the embedded model config document (shard npz files
    # hold only arrays)
    nshards: Optional[int] = None
    shards: dict = field(default_factory=dict)
    dir: Optional[str] = None
    model: Optional[dict] = None

    @property
    def is_sharded(self) -> bool:
        return self.nshards is not None

    def to_manifest(self) -> dict:
        if self.is_sharded:
            doc = {
                "format": SHARDED_MANIFEST_FORMAT, "step": self.step,
                "epoch": self.epoch, "dir": self.dir or self.file,
                "nshards": self.nshards, "shards": self.shards,
                "model": self.model,
            }
        else:
            doc = {
                "format": self.format, "step": self.step,
                "epoch": self.epoch, "file": self.file,
                "crc32": self.crc32, "size": self.size,
            }
        if self.artifacts:
            doc["artifacts"] = self.artifacts
        if self.zero:
            doc["zero"] = self.zero
        if self.guard:
            doc["guard"] = self.guard
        return doc

    @classmethod
    def from_manifest(cls, doc: dict) -> "CheckpointInfo":
        fmt = int(doc.get("format", MANIFEST_FORMAT))
        common = dict(
            step=int(doc["step"]), epoch=int(doc.get("epoch", 0)),
            format=fmt,
            artifacts=dict(doc.get("artifacts") or {}),
            zero=dict(doc["zero"]) if doc.get("zero") else None,
            guard=dict(doc["guard"]) if doc.get("guard") else None,
        )
        if fmt >= SHARDED_MANIFEST_FORMAT:
            return cls(
                file=doc["dir"], crc32=0, size=0,
                nshards=int(doc["nshards"]),
                shards=dict(doc.get("shards") or {}),
                dir=doc["dir"], model=dict(doc.get("model") or {}),
                **common,
            )
        return cls(
            file=doc["file"], crc32=int(doc["crc32"]),
            size=int(doc["size"]), **common,
        )


class AsyncSaveHandle:
    """Ticket for one write-behind save. ``wait()`` blocks until the
    background writer commits (returns the :class:`CheckpointInfo`),
    the save is superseded by a newer one (returns ``None``,
    ``superseded`` set), or the write fails (re-raises the writer's
    exception — e.g. :class:`CheckpointCommitAbortedException` when
    the cross-host commit fence aborted)."""

    def __init__(self, step: int):
        self.step = int(step)
        self.info: Optional[CheckpointInfo] = None
        self.error: Optional[BaseException] = None
        self.superseded = False
        self._event = threading.Event()

    def _resolve(self, info, error=None, superseded=False) -> None:
        self.info = info
        self.error = error
        self.superseded = bool(superseded)
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None
             ) -> Optional[CheckpointInfo]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"write-behind save of step {self.step} still in "
                f"flight after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.info


class LocalCommitBarrier:
    """Trivial commit fence for a single process: forces the sharded
    ``<prefix>-<step>/`` layout without a control plane (tests, or a
    single-host run that wants shard-granular scrub/repair). The
    barrier trivially proceeds with this rank's own digest."""

    def __init__(self, rank: int = 0, nshards: int = 1):
        self.rank = int(rank)
        self.nshards = int(nshards)

    def barrier(self, token: str, payload: dict) -> Dict[int, dict]:
        return {self.rank: payload}


class ProcessGroupCommitBarrier:
    """The commit fence of a ``torch.distributed`` world without a
    control plane (``LeaseCommitBarrier`` fences over one): each
    rank's shard digest is all-gathered over a gloo group of its own
    (made here, on every rank, in lockstep), so the barrier may run on
    the write-behind writer while the training thread's collectives use
    the default group. A rank that fails the gather aborts the
    commit."""

    def __init__(self, timeout_s: Optional[float] = None):
        import datetime

        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("ProcessGroupCommitBarrier needs an "
                               "initialized torch.distributed world")
        self._dist = dist
        kw = {} if timeout_s is None else {
            "timeout": datetime.timedelta(seconds=timeout_s)}
        self.group = dist.new_group(backend="gloo", **kw)
        self.rank = dist.get_rank()
        self.nshards = dist.get_world_size()

    def barrier(self, token: str, payload: dict) -> Dict[int, dict]:
        got = [None] * self.nshards
        try:
            self._dist.all_gather_object(got, (token, payload),
                                         group=self.group)
        except Exception as e:
            raise CheckpointCommitAbortedException(
                f"commit barrier {token!r} failed: {e}") from e
        if any(t != token for t, _ in got):
            raise CheckpointCommitAbortedException(
                f"commit barrier {token!r} met "
                f"{sorted({t for t, _ in got})}")
        return {r: p for r, (_, p) in enumerate(got)}


class LeaseCommitBarrier:
    """The cross-host commit fence: rides ``WorkerAgent.sync_barrier``
    (``parallel/control_plane.py``: a payload-carrying named barrier
    over the lease coordinator), so commit membership is exactly the
    lease membership: a host dying mid-save bumps the epoch, the
    barrier reports it, and the commit aborts instead of publishing a
    manifest over a missing shard. ``rank`` / ``nshards`` track the
    agent's current grant, so an elastic downscale narrows the shard
    layout of the next save."""

    def __init__(self, agent, timeout_s: Optional[float] = None):
        self.agent = agent
        self.timeout_s = timeout_s

    @property
    def rank(self) -> int:
        return int(self.agent.rank or 0)

    @property
    def nshards(self) -> int:
        return int(self.agent.num or 1)

    def barrier(self, token: str, payload: dict) -> Dict[int, dict]:
        from deeplearning4j_tpu_torch.parallel.control_plane import (
            ControlPlaneException,
        )

        try:
            got = self.agent.sync_barrier(
                token, payload, timeout_s=self.timeout_s)
        except ControlPlaneException as e:
            raise CheckpointCommitAbortedException(
                f"commit barrier {token!r} failed: {e}") from e
        if got is None:
            raise CheckpointCommitAbortedException(
                f"membership changed during commit barrier {token!r}: "
                "the epoch the shards were written under no longer "
                "exists")
        return got


class CheckpointManager:
    """Atomic versioned checkpoint store over a local directory.

    ``save(model)`` stamps the version from ``model.iteration_count``;
    ``restore_latest()`` walks versions newest-first, skipping any that
    fail CRC/zip verification or are quarantined (with a warning), and
    returns the restored model + its info.

    Knobs beyond the classic ones:

    - ``mode``: default save mode — ``"sync"`` (write on the calling
      thread, the historical behavior) or ``"async"`` (write-behind:
      snapshot on the calling thread, everything else on a background
      writer; ``save`` returns an :class:`AsyncSaveHandle`). Either
      can be overridden per call via ``save(..., mode=)``.
    - ``commit``: a commit barrier (:class:`LeaseCommitBarrier` /
      :class:`LocalCommitBarrier`). When set, saves use the sharded
      ``<prefix>-<step>/shard-<rank>.npz`` layout with the two-phase
      commit; when ``None`` (default) the single-process zip path is
      unchanged.
    - ``replica_store``: a second ``ObjectStore`` (wrap it in
      ``RetryingObjectStore`` for flaky backends): committed
      checkpoints are mirrored there, and scrub/restore repair
      corrupt local components from it.
    - ``scrub_interval_s``: start a background scrubber re-verifying
      retained checkpoints' CRCs every interval (``scrub_once()``
      runs one deterministic pass for tests).
    - ``gc_grace_s``: minimum age before an *uncommitted* shard
      directory (no manifest — a torn or aborted commit) is
      garbage-collected; directories older than this, or below the
      newest committed step, are removed at prune time.
    """

    def __init__(self, directory, keep_last: int = 3,
                 prefix: str = "checkpoint", protect=None, *,
                 mode: str = "sync", commit=None, replica_store=None,
                 scrub_interval_s: Optional[float] = None,
                 gc_grace_s: float = 300.0, registry=None, device=None):
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        if not re.fullmatch(r"[A-Za-z0-9._]+", prefix):
            raise ValueError(
                f"prefix {prefix!r} must be filename-safe "
                "(letters/digits/dot/underscore)"
            )
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', "
                             f"got {mode!r}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.prefix = prefix
        # retention guard: a callable returning step numbers that
        # pruning must NEVER delete, consulted at each save (a rollback
        # target that must outlive the keep_last window)
        self.protect = protect
        self.mode = mode
        self.commit = commit
        self.replica = replica_store
        self.scrub_interval_s = scrub_interval_s
        self.gc_grace_s = float(gc_grace_s)
        # where restore_latest / restore build their models (None: the
        # port's default device, the card)
        self.device = device
        # the two pinned staging sets of write-behind saves on the card
        # (one may be being written while the other is queued), each
        # with the tree signature it was made for
        self._pinned: List[Optional[tuple]] = [None, None]
        self._wbusy_slot: Optional[int] = None
        # write-behind writer state: a single-slot pending queue
        # (newest wins) plus one busy flag — "at most one save in
        # flight" by construction
        self._wcond = threading.Condition()
        self._wpending: Optional[tuple] = None
        self._wbusy = False
        self._wstop = False
        self._wthread: Optional[threading.Thread] = None
        self._active_steps: set = set()   # sharded writes in flight
        self._scrub_stop: Optional[threading.Event] = None
        self._scrub_thread: Optional[threading.Thread] = None
        registry = registry if registry is not None \
            else _default_registry()
        self._m_pending = registry.gauge(
            "checkpoint_async_pending",
            help="write-behind checkpoint saves queued or in flight",
        )._default()
        self._m_write = registry.summary(
            "checkpoint_write_ms",
            help="checkpoint serialize+write+commit time (ms), off "
                 "the training thread for async saves",
        )._default()
        self._m_stall = registry.summary(
            "checkpoint_stall_ms",
            help="training-thread stall per checkpoint save (ms): "
                 "host-snapshot copy only for async, the full write "
                 "for sync",
        )._default()
        self._m_commit = registry.summary(
            "checkpoint_commit_barrier_ms",
            help="two-phase commit barrier wait per sharded save (ms)",
        )._default()
        self._m_scrub = registry.counter(
            "checkpoint_scrub_corrupt_total",
            help="corrupt checkpoint components found by the scrubber",
        )._default()
        self._m_repair = registry.counter(
            "checkpoint_repair_total",
            help="checkpoint components repaired from the replica "
                 "store",
        )._default()
        if scrub_interval_s is not None:
            self.start_scrubber(scrub_interval_s)

    # -- naming ---------------------------------------------------------

    def _zip_name(self, step: int) -> str:
        return f"{self.prefix}-{step:08d}.zip"

    def _manifest_name(self, step: int) -> str:
        return f"{self.prefix}-{step:08d}.json"

    def _dir_name(self, step: int) -> str:
        return f"{self.prefix}-{step:08d}"

    def _quarantine_name(self, step: int) -> str:
        return f"{self.prefix}-{step:08d}.quarantined"

    def _artifact_file_name(self, step: int, name: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9._-]+", name):
            raise ValueError(
                f"artifact name {name!r} must be filename-safe "
                "(letters/digits/dot/underscore/dash)"
            )
        return f"{self.prefix}-{step:08d}.{name}.aot"

    # -- write ----------------------------------------------------------

    def save(self, model, artifacts=None, mode: Optional[str] = None):
        """Checkpoint ``model`` at its current iteration count (re-saving
        a step overwrites that version atomically). ``artifacts``
        (``{name: bytes}``) are written as side files, CRC-recorded in
        the manifest, never gating the model restore.

        ``mode="sync"`` writes on the calling thread (after draining the
        writer, so it is the newest bytes on disk when it returns) and
        returns the :class:`CheckpointInfo`; ``mode="async"`` takes the
        snapshot here, hands the write to the background writer and
        returns an :class:`AsyncSaveHandle` at once."""
        mode = self.mode if mode is None else mode
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', "
                             f"got {mode!r}")
        t0 = time.perf_counter()
        if mode == "async":
            with self._wcond:
                # the snapshot is taken under the lock, so the writer
                # cannot pick up the queued save whose staging it reuses
                handle = self._enqueue_async_locked(model, artifacts)
            self._m_stall.observe((time.perf_counter() - t0) * 1000.0)
            return handle
        # sync: order after any write in flight, then write inline (the
        # emergency path rides this)
        self.flush()
        payload = self._snapshot_payload(model, artifacts)
        self._record_start(payload, mode)
        info = self._write_payload(payload)
        self._m_stall.observe((time.perf_counter() - t0) * 1000.0)
        return info

    def _record_start(self, payload: dict, mode: str) -> None:
        flightrec.record_event(
            "checkpoint_save_start", step=payload["step"], mode=mode,
            shards=(self.commit.nshards if self.commit is not None
                    else None))

    def _enqueue_async_locked(self, model, artifacts) -> "AsyncSaveHandle":
        """The training-thread half of a write-behind save, under the
        writer's lock: the snapshot (on the card into the pinned
        staging set the writer is not writing; the queued save that
        held it is superseded below), then the queue's one slot."""
        slot = None
        if getattr(getattr(model, "device", None), "type", None) == "cuda":
            slot = 1 if self._wbusy_slot == 0 else 0
        payload = self._snapshot_payload(model, artifacts, slot=slot)
        self._record_start(payload, "async")
        handle = AsyncSaveHandle(payload["step"])
        if self._wpending is not None:
            _, old = self._wpending
            old._resolve(None, superseded=True)
            logger.info("write-behind save of step %d superseded by step "
                        "%d", old.step, handle.step)
        self._wpending = (payload, handle)
        self._ensure_writer_locked()
        self._set_pending_gauge_locked()
        self._wcond.notify_all()
        return handle

    def _staging(self, slot: int, trees: dict) -> dict:
        """Pinned staging set ``slot`` for ``trees`` (``snapshot_trees``),
        made anew when their shapes change."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            pinned_like,
            tree_signature,
        )

        sig = tuple(None if v is None else tree_signature(v)
                    for v in trees.values())
        have = self._pinned[slot]
        if have is None or have[0] != sig:
            have = self._pinned[slot] = (sig, {
                k: (None if v is None else pinned_like(v))
                for k, v in trees.items()})
        return have[1]

    def _snapshot_payload(self, model, artifacts, slot=None) -> dict:
        """The training-thread half of a save: host copies of everything
        the writer needs (``slot``: non-blocking, into that pinned
        staging set), so the model may train on the moment this
        returns."""
        from deeplearning4j_tpu_torch.resilience.guard import (
            guard_state_doc,
        )
        from deeplearning4j_tpu_torch.util.model_serializer import (
            snapshot_model,
            snapshot_trees,
        )

        pinned = None
        if slot is not None:
            pinned = self._staging(slot, snapshot_trees(model))
        return {
            "step": int(model.iteration_count),
            "epoch": int(getattr(model, "epoch_count", 0)),
            "snap": snapshot_model(model, pinned=pinned),
            "slot": slot,
            "artifacts": dict(artifacts or {}),
            "zero": dict(getattr(model, "_zero_layout", None) or {})
            or None,
            "guard": guard_state_doc(model),
        }

    # -- the background writer ------------------------------------------

    def _ensure_writer_locked(self) -> None:
        if self._wthread is not None and self._wthread.is_alive():
            return
        self._wstop = False
        self._wthread = threading.Thread(
            target=self._writer_loop, name="ckpt-writer", daemon=True)
        self._wthread.start()

    def _set_pending_gauge_locked(self) -> None:
        self._m_pending.set(
            float((self._wpending is not None) + self._wbusy))

    def _writer_loop(self) -> None:
        while True:
            with self._wcond:
                while self._wpending is None and not self._wstop:
                    self._wcond.wait()
                if self._wpending is None and self._wstop:
                    return
                payload, handle = self._wpending
                self._wpending = None
                self._wbusy = True
                self._wbusy_slot = payload.get("slot")
                self._set_pending_gauge_locked()
            try:
                info = self._write_payload(payload)
                handle._resolve(info)
            except BaseException as e:
                handle._resolve(None, error=e)
                logger.warning(
                    "write-behind checkpoint save of step %d failed: "
                    "%r", handle.step, e)
            finally:
                with self._wcond:
                    self._wbusy = False
                    self._wbusy_slot = None
                    self._set_pending_gauge_locked()
                    self._wcond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Drain the write-behind writer: block until no save is
        queued or in flight. Returns False on timeout (the writer
        keeps going; only the wait gives up)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._wcond:
            while self._wpending is not None or self._wbusy:
                if deadline is None:
                    self._wcond.wait(1.0)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._wcond.wait(remaining)
        return True

    def stop(self, timeout: Optional[float] = None) -> None:
        """Flush pending writes, stop the writer thread and the
        scrubber. The manager stays usable (sync saves; a subsequent
        async save restarts the writer)."""
        self.flush(timeout)
        with self._wcond:
            self._wstop = True
            self._wcond.notify_all()
            t = self._wthread
            self._wthread = None
        if t is not None:
            t.join(timeout=5)
        self.stop_scrubber()

    # -- the write itself -----------------------------------------------

    def _write_payload(self, payload: dict) -> CheckpointInfo:
        from deeplearning4j_tpu_torch.observability.trace import get_tracer

        step = payload["step"]
        t0 = time.perf_counter()
        sharded = self.commit is not None
        with get_tracer().start_span("checkpoint.save", attrs={
                "step": step, "prefix": self.prefix,
                "sharded": sharded}) as span:
            if sharded:
                with self._wcond:
                    self._active_steps.add(step)
                try:
                    info = self._write_sharded(payload)
                except CheckpointCommitAbortedException as e:
                    flightrec.record_event("checkpoint_abort", step=step,
                                           reason=str(e)[:200])
                    span.set_attr("outcome", "aborted")
                    raise
                finally:
                    with self._wcond:
                        self._active_steps.discard(step)
            else:
                info = self._write_zip(payload)
            ms = (time.perf_counter() - t0) * 1000.0
            self._m_write.observe(ms)
            flightrec.record_event("checkpoint_commit", step=step,
                                   ms=round(ms, 3), shards=info.nshards)
            span.set_attr("bytes", info.size)
        return info

    def _write_zip(self, payload: dict) -> CheckpointInfo:
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_snapshot,
        )

        step, epoch = payload["step"], payload["epoch"]
        zpath = self.directory / self._zip_name(step)
        write_snapshot(payload["snap"], zpath)  # atomic + fsync
        crc, size = _crc32_of(zpath)
        artifact_map = {}
        for name, data in sorted(payload["artifacts"].items()):
            fname = self._artifact_file_name(step, name)
            atomic_write_bytes(self.directory / fname, data)
            artifact_map[name] = {
                "file": fname,
                "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                "size": len(data),
            }
        info = CheckpointInfo(
            step=step, epoch=epoch, file=zpath.name, crc32=crc,
            size=size, artifacts=artifact_map,
            zero=payload["zero"], guard=payload["guard"],
        )
        # manifest lands after the zip: a crash between the two
        # leaves an orphan zip that available() ignores, never a
        # manifest pointing at a missing/half zip
        atomic_write_bytes(
            self.directory / self._manifest_name(step),
            json.dumps(info.to_manifest(), indent=2).encode(),
        )
        self._clear_quarantine(step)
        self._mirror(info)
        self._prune()
        return info

    def _write_sharded(self, payload: dict) -> CheckpointInfo:
        from deeplearning4j_tpu_torch.util.model_serializer import (
            snapshot_conf_doc, snapshot_flat_arrays,
        )

        step, epoch = payload["step"], payload["epoch"]
        rank = int(self.commit.rank)
        nshards = max(int(self.commit.nshards), 1)
        dirname = self._dir_name(step)
        dpath = self.directory / dirname
        dpath.mkdir(parents=True, exist_ok=True)
        flat = snapshot_flat_arrays(payload["snap"])
        mine = sorted(flat)[rank::nshards]
        buf = io.BytesIO()
        np.savez(buf, **{k: flat[k] for k in mine})
        data = buf.getvalue()
        fname = f"shard-{rank}.npz"
        atomic_write_bytes(dpath / fname, data)
        digest = {
            "rank": rank, "file": fname,
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
            "size": len(data), "keys": len(mine),
        }
        # phase 1: every rank's shard is durable before anyone may
        # commit — leaving this barrier hands rank 0 all digests
        t0 = time.perf_counter()
        got = self.commit.barrier(f"{self.prefix}:{step}:shards",
                                  digest)
        info: Optional[CheckpointInfo] = None
        if rank == 0:
            shards_doc = {}
            for p in got.values():
                shards_doc[str(int(p["rank"]))] = {
                    "file": str(p["file"]), "crc32": int(p["crc32"]),
                    "size": int(p["size"]), "keys": int(p["keys"]),
                }
            artifact_map = {}
            for name, adata in sorted(payload["artifacts"].items()):
                self._artifact_file_name(step, name)  # validates name
                rel = f"{dirname}/{name}.aot"
                atomic_write_bytes(self.directory / rel, adata)
                artifact_map[name] = {
                    "file": rel,
                    "crc32": zlib.crc32(adata) & 0xFFFFFFFF,
                    "size": len(adata),
                }
            info = CheckpointInfo(
                step=step, epoch=epoch, file=dirname, crc32=0, size=0,
                format=SHARDED_MANIFEST_FORMAT, artifacts=artifact_map,
                zero=payload["zero"], guard=payload["guard"],
                nshards=len(shards_doc), shards=shards_doc,
                dir=dirname, model=snapshot_conf_doc(payload["snap"]),
            )
            # THE commit point: the manifest lands last, atomic +
            # fsync'd — until it exists this directory is invisible
            # to restore and fair game for GC
            atomic_write_bytes(
                dpath / "manifest.json",
                json.dumps(info.to_manifest(), indent=2).encode(),
            )
        # phase 2: peers block until the manifest is durable (or the
        # epoch moved). Once rank 0 has written the manifest the
        # checkpoint IS committed — a phase-2 abort after that point
        # is a reporting hiccup for rank 0, a real abort for peers
        # (they cannot know whether the manifest landed).
        try:
            self.commit.barrier(f"{self.prefix}:{step}:commit",
                                {"rank": rank})
        except CheckpointCommitAbortedException:
            if info is None:
                raise
            logger.warning(
                "commit barrier phase 2 of step %d aborted after the "
                "manifest was written; checkpoint is committed", step)
        self._m_commit.observe((time.perf_counter() - t0) * 1000.0)
        if info is None:
            doc = json.loads((dpath / "manifest.json").read_text())
            info = CheckpointInfo.from_manifest(doc)
        self._clear_quarantine(step)
        self._mirror(info, shard_rank=rank, shard_bytes=data)
        if rank == 0:
            self._prune()
        return info

    # -- replica mirroring ----------------------------------------------

    def _mirror(self, info: CheckpointInfo, shard_rank=None,
                shard_bytes=None) -> None:
        """Mirror a just-committed checkpoint to the replica store
        (best-effort: a mirror failure is logged, never fails the
        save — the local copy is already durable). Sharded saves
        mirror only this rank's shard; rank 0 adds the manifest and
        artifacts. Keys are the paths relative to the manager
        directory, so repair is a straight read-back."""
        if self.replica is None:
            return
        try:
            if info.is_sharded:
                d = info.dir or info.file
                if shard_rank is not None and shard_bytes is not None:
                    ent = info.shards.get(str(shard_rank))
                    if ent:
                        self.replica.write(f"{d}/{ent['file']}",
                                           shard_bytes)
                if shard_rank in (None, 0):
                    self.replica.write(
                        f"{d}/manifest.json",
                        (self.directory / d / "manifest.json"
                         ).read_bytes())
                    for ent in info.artifacts.values():
                        rel = ent.get("file")
                        if rel:
                            self.replica.write(
                                rel,
                                (self.directory / rel).read_bytes())
            else:
                self.replica.write(
                    info.file,
                    (self.directory / info.file).read_bytes())
                self.replica.write(
                    self._manifest_name(info.step),
                    (self.directory
                     / self._manifest_name(info.step)).read_bytes())
                for ent in info.artifacts.values():
                    rel = ent.get("file")
                    if rel:
                        self.replica.write(
                            rel, (self.directory / rel).read_bytes())
        except Exception as e:
            logger.warning(
                "replica mirror of step %d failed (local copy is "
                "durable): %r", info.step, e)

    # -- retention ------------------------------------------------------

    def _delete_version(self, info: CheckpointInfo) -> None:
        if info.is_sharded:
            shutil.rmtree(self.directory / (info.dir or info.file),
                          ignore_errors=True)
        else:
            names = [info.file, self._manifest_name(info.step)]
            for name in names:
                try:
                    os.unlink(self.directory / name)
                except OSError:
                    pass
        for a in info.artifacts.values():
            if isinstance(a, dict) and a.get("file"):
                try:
                    os.unlink(self.directory / a["file"])
                except OSError:
                    pass
        self._clear_quarantine(info.step)

    def _prune(self) -> None:
        versions = self.available()
        protected: set = set()
        if self.protect is not None:
            try:
                protected = {int(s) for s in self.protect()}
            except Exception:
                # a broken guard must fail SAFE: protect everything
                logger.warning("checkpoint protect callable failed; "
                               "skipping pruning", exc_info=True)
                return
        for info in versions[:-self.keep_last]:
            if info.step in protected:
                continue  # protected: never delete
            self._delete_version(info)
        self._gc_uncommitted(versions)

    def _gc_uncommitted(self, versions: List[CheckpointInfo]) -> None:
        """Remove shard directories whose commit never happened (no
        manifest): a torn two-phase commit, a host dead mid-save, or
        an aborted barrier. Never touches a step currently being
        written, and ages unknown directories past ``gc_grace_s``
        before collecting (a peer's save may still be in flight);
        directories below the newest committed step are garbage
        immediately."""
        newest = versions[-1].step if versions else -1
        pat = re.compile(re.escape(self.prefix) + r"-(\d{8})\Z")
        now = time.time()
        for p in self.directory.iterdir():
            if not p.is_dir():
                continue
            m = pat.fullmatch(p.name)
            if not m or (p / "manifest.json").exists():
                continue
            step = int(m.group(1))
            with self._wcond:
                if step in self._active_steps:
                    continue
            try:
                age = now - p.stat().st_mtime
            except OSError:
                continue
            if step < newest or age >= self.gc_grace_s:
                shutil.rmtree(p, ignore_errors=True)
                flightrec.record_event("checkpoint_gc", step=step)
                logger.info(
                    "collected uncommitted checkpoint directory %s",
                    p.name)

    # -- read -----------------------------------------------------------

    def available(self) -> List[CheckpointInfo]:
        """Committed versions, oldest first: format-1 sibling
        manifests plus format-2 ``<prefix>-<step>/manifest.json``
        commit points. Orphan zips, uncommitted shard directories
        (manifest never landed) and unreadable manifests are
        skipped."""
        out = []
        fpat = re.compile(re.escape(self.prefix) + r"-(\d{8})\.json\Z")
        dpat = re.compile(re.escape(self.prefix) + r"-(\d{8})\Z")
        for p in sorted(self.directory.iterdir()):
            mp: Optional[Path] = None
            if p.is_file() and fpat.fullmatch(p.name):
                mp = p
            elif p.is_dir() and dpat.fullmatch(p.name):
                mp = p / "manifest.json"
                if not mp.is_file():
                    continue  # uncommitted: restore must not see it
            if mp is None:
                continue
            try:
                out.append(CheckpointInfo.from_manifest(
                    json.loads(mp.read_text())
                ))
            except (ValueError, KeyError, OSError):
                logger.warning("skipping unreadable manifest %s", mp)
        out.sort(key=lambda i: i.step)
        return out

    def list_steps(self) -> List[int]:
        """Step numbers of every committed version, ascending — the
        public enumeration the promoter/shadow loop uses instead of
        touching manifest internals."""
        return [info.step for info in self.available()]

    def latest_step(self) -> Optional[int]:
        """Newest committed step, or None when the store is empty."""
        versions = self.available()
        return versions[-1].step if versions else None

    def last_step(self) -> Optional[int]:
        """Back-compat alias of ``latest_step``."""
        return self.latest_step()

    # -- quarantine ------------------------------------------------------

    def is_quarantined(self, step: int) -> bool:
        return (self.directory
                / self._quarantine_name(step)).exists()

    def quarantine(self, step: int, reason: str = "") -> None:
        """Mark a step corrupt-beyond-repair: restore walks back past
        it (the corrupted-newest fallback, at shard granularity) and
        prune eventually removes it. The marker is a sibling file, so
        quarantining never mutates the (possibly half-readable)
        checkpoint bytes themselves."""
        atomic_write_bytes(
            self.directory / self._quarantine_name(step),
            json.dumps({"step": int(step), "reason": reason,
                        "time": time.time()}).encode(),
        )
        flightrec.record_event("checkpoint_quarantined", step=step,
                               reason=reason[:200])
        logger.warning("checkpoint step %d quarantined: %s", step,
                       reason)

    def _clear_quarantine(self, step: int) -> None:
        try:
            os.unlink(self.directory / self._quarantine_name(step))
        except OSError:
            pass

    # -- verification ----------------------------------------------------

    def _corrupt_components(self, info: CheckpointInfo
                            ) -> List[Tuple[str, int, int]]:
        """Components of ``info`` whose on-disk bytes no longer match
        the manifest, as (relpath, expected_crc32, expected_size) —
        shard granularity for format 2, the whole zip for format 1."""
        bad = []
        if info.is_sharded:
            d = info.dir or info.file
            for _, ent in sorted(info.shards.items(),
                                 key=lambda kv: int(kv[0])):
                rel = f"{d}/{ent['file']}"
                try:
                    crc, size = _crc32_of(self.directory / rel)
                except OSError:
                    crc, size = -1, -1
                if (crc != int(ent["crc32"])
                        or size != int(ent["size"])):
                    bad.append((rel, int(ent["crc32"]),
                                int(ent["size"])))
        else:
            try:
                crc, size = _crc32_of(self.directory / info.file)
            except OSError:
                crc, size = -1, -1
            if crc != info.crc32 or size != info.size:
                bad.append((info.file, info.crc32, info.size))
        return bad

    def verify(self, info: CheckpointInfo) -> bool:
        """CRC + size + container-structure check without restoring
        (zip structure for format 1, npz readability per shard for
        format 2)."""
        if self._corrupt_components(info):
            return False
        try:
            if info.is_sharded:
                d = info.dir or info.file
                for _, ent in info.shards.items():
                    with np.load(self.directory / d / ent["file"],
                                 allow_pickle=False) as z:
                        list(z.files)
                return True
            with zipfile.ZipFile(self.directory / info.file) as zf:
                return zf.testzip() is None
        except (OSError, ValueError, zipfile.BadZipFile):
            return False

    def _repair(self, info: CheckpointInfo,
                bad: List[Tuple[str, int, int]]) -> bool:
        """Re-fetch corrupt components from the replica store; each
        replacement must match the manifest CRC before it lands
        (atomically). True iff every bad component was repaired."""
        if self.replica is None:
            return False
        for rel, crc, size in bad:
            try:
                data = self.replica.read(rel)
            except Exception as e:
                logger.warning(
                    "repair of %s from replica failed: %r", rel, e)
                return False
            if (len(data) != size
                    or (zlib.crc32(data) & 0xFFFFFFFF) != crc):
                logger.warning(
                    "replica copy of %s fails the manifest CRC too; "
                    "cannot repair", rel)
                return False
            atomic_write_bytes(self.directory / rel, data)
            self._m_repair.inc()
            flightrec.record_event("checkpoint_repair",
                                   step=info.step, file=rel)
            logger.info("repaired %s from the replica store", rel)
        return True

    # -- scrub ----------------------------------------------------------

    def scrub_once(self) -> dict:
        """One scrub pass: re-verify every committed version's CRCs
        at shard granularity; repair corrupt components from the
        replica when possible, quarantine the step otherwise. Returns
        a summary dict (checked/corrupt/repaired/quarantined)."""
        report = {"checked": 0, "corrupt": 0, "repaired": 0,
                  "quarantined": []}
        for info in self.available():
            if self.is_quarantined(info.step):
                continue
            report["checked"] += 1
            bad = self._corrupt_components(info)
            if not bad:
                continue
            report["corrupt"] += len(bad)
            self._m_scrub.inc(len(bad))
            flightrec.record_event(
                "checkpoint_scrub_corrupt", step=info.step,
                components=[b[0] for b in bad])
            if self._repair(info, bad):
                report["repaired"] += len(bad)
            else:
                self.quarantine(
                    info.step,
                    reason="scrub: " + ", ".join(b[0] for b in bad))
                report["quarantined"].append(info.step)
        return report

    def start_scrubber(self, interval_s: float) -> None:
        """Start the background scrubber (idempotent)."""
        if self._scrub_thread is not None \
                and self._scrub_thread.is_alive():
            return
        self.scrub_interval_s = float(interval_s)
        stop = threading.Event()
        self._scrub_stop = stop

        def _loop():
            while not stop.wait(self.scrub_interval_s):
                try:
                    self.scrub_once()
                except Exception:
                    logger.warning("checkpoint scrub pass failed",
                                   exc_info=True)

        self._scrub_thread = threading.Thread(
            target=_loop, name="ckpt-scrubber", daemon=True)
        self._scrub_thread.start()

    def stop_scrubber(self) -> None:
        if self._scrub_stop is not None:
            self._scrub_stop.set()
        if self._scrub_thread is not None:
            self._scrub_thread.join(timeout=5)
        self._scrub_thread = None
        self._scrub_stop = None

    # -- artifacts -------------------------------------------------------

    def load_artifact(self, info: CheckpointInfo,
                      name: str) -> Optional[bytes]:
        """Bytes of one named side artifact, CRC-verified against the
        manifest — or ``None`` when absent, unreadable, or corrupted
        (logged; the consumer falls back to computing the artifact's
        content). Never
        raises and never affects model-restore eligibility."""
        entry = info.artifacts.get(name)
        if not isinstance(entry, dict) or not entry.get("file"):
            return None
        path = self.directory / entry["file"]
        try:
            data = path.read_bytes()
        except OSError:
            logger.warning("artifact %r of step %d is missing (%s)",
                           name, info.step, path)
            return None
        if (len(data) != int(entry.get("size", -1))
                or (zlib.crc32(data) & 0xFFFFFFFF)
                != int(entry.get("crc32", -1))):
            logger.warning(
                "artifact %r of step %d failed CRC verification; "
                "ignoring it", name, info.step,
            )
            return None
        return data

    def load_artifacts(self, info: CheckpointInfo) -> dict:
        """All verifiable side artifacts of ``info`` as
        ``{name: bytes}`` (corrupted/missing ones silently absent)."""
        out = {}
        for name in info.artifacts:
            data = self.load_artifact(info, name)
            if data is not None:
                out[name] = data
        return out

    # -- restore ---------------------------------------------------------

    def restore(self, info: CheckpointInfo, load_updater: bool = True,
                device=None):
        """Restore one version onto ``device`` (default the manager's),
        verified (a quarantined step fails verification by definition).
        A corrupt component is repaired from the replica first where
        one is configured; only then does the version fail."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            model_from_flat,
            restore_model,
        )

        device = self.device if device is None else device
        if self.is_quarantined(info.step):
            raise CheckpointCorruptedException(
                f"checkpoint step {info.step} is quarantined")
        if not self.verify(info):
            bad = self._corrupt_components(info)
            if not (bad and self._repair(info, bad)
                    and self.verify(info)):
                raise CheckpointCorruptedException(
                    f"checkpoint step {info.step} ({info.file}) "
                    "failed verification")
        if info.is_sharded:
            d = info.dir or info.file
            flat: Dict[str, np.ndarray] = {}
            for _, ent in sorted(info.shards.items(),
                                 key=lambda kv: int(kv[0])):
                with np.load(self.directory / d / ent["file"],
                             allow_pickle=False) as z:
                    for k in z.files:
                        flat[k] = z[k]
            return model_from_flat(info.model, flat,
                                   load_updater=load_updater, device=device)
        return restore_model(self.directory / info.file, device=device,
                             load_updater=load_updater)

    def restore_latest(self, load_updater: bool = True, device=None):
        """(model, info) of the newest restorable version, falling back
        to earlier ones when the newest is corrupted or quarantined.
        Raises ``CheckpointCorruptedException`` when none survives. One
        ``checkpoint.restore`` span brackets it (the JAX package's
        name and attributes)."""
        from deeplearning4j_tpu_torch.observability.trace import get_tracer

        with get_tracer().start_span(
                "checkpoint.restore", attrs={"prefix": self.prefix}) as span:
            versions = self.available()
            if not versions:
                span.set_attr("outcome", "none_available")
                raise CheckpointCorruptedException(
                    f"no checkpoints under {self.directory}")
            fallbacks = 0
            for info in reversed(versions):
                try:
                    model = self.restore(info, load_updater=load_updater,
                                         device=device)
                except CheckpointCorruptedException:
                    logger.warning("checkpoint step %d failed verification; "
                                   "falling back to the previous version",
                                   info.step)
                    fallbacks += 1
                    continue
                except Exception:
                    # a manifest that verifies but does not deserialize is
                    # corruption too (a valid zip, a mangled npz member)
                    logger.warning("checkpoint step %d failed to "
                                   "deserialize; falling back to the "
                                   "previous version", info.step,
                                   exc_info=True)
                    fallbacks += 1
                    continue
                span.set_attr("step", info.step)
                span.set_attr("fallbacks", fallbacks)
                return model, info
            span.set_attr("outcome", "all_corrupted")
            raise CheckpointCorruptedException(
                f"all {len(versions)} checkpoint versions under "
                f"{self.directory} failed verification")


def restore_into(model, source, load_updater: bool = True):
    """Restore a checkpoint into an existing model (the resume
    primitive): ``source`` is a ``CheckpointManager`` (its newest
    restorable version), a ``(manager, info)`` pair, or a checkpoint
    zip path. The parameters, layer state, updater state and the step
    and epoch counts are replaced, on the model's device; the
    configuration must match the model's. A model whose updater state
    lay in ZeRO-1's layout is canonical afterwards (its trainer
    re-shards it). Returns ``(model, step)``."""
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    info = None
    device = model.device
    if isinstance(source, CheckpointManager):
        restored, info = source.restore_latest(load_updater=load_updater,
                                               device=device)
    elif (isinstance(source, tuple) and len(source) == 2
            and isinstance(source[0], CheckpointManager)):
        manager, info = source
        restored = manager.restore(info, load_updater=load_updater,
                                   device=device)
    else:
        restored = restore_model(source, device=device,
                                 load_updater=load_updater)

    if json.dumps(model.conf.to_dict(), sort_keys=True) != json.dumps(
            restored.conf.to_dict(), sort_keys=True):
        raise ValueError(
            "checkpoint configuration does not match this model — "
            "restore into a fresh model via CheckpointManager.restore_"
            "latest()/restore_model() instead")
    if getattr(model, "_row_layout", None) or getattr(
            model, "_tp_layout", None):
        # the file's trees are whole: a row-sharded table's (or a
        # tensor-parallel shard's) moments are gathered too (every rank
        # restores), and the next trainer re-shards at whatever width
        # its world has
        from deeplearning4j_tpu_torch.nn import core

        core.canonicalize_updater_state(model)
    model.params = restored.params
    model.state = restored.state
    if load_updater and restored.updater_state is not None:
        model.updater_state = restored.updater_state
        if getattr(model, "_zero_layout", None):
            model._zero_layout = None
    model.iteration_count = restored.iteration_count
    model.epoch_count = restored.epoch_count
    if info is not None and info.guard:
        # the EWMA state and the skip ledger come back as saved, so a
        # resumed defended run makes the same trip decisions
        from deeplearning4j_tpu_torch.resilience.guard import (
            apply_guard_state_doc,
        )

        apply_guard_state_doc(model, info.guard)
    return model, restored.iteration_count


class CheckpointListener(IterationListener):
    """Checkpoint every N iterations through the ``IterationListener``
    SPI (reference ``CheckpointListener`` analog, atomic + verified).
    Attach to a model (``model.listeners``) or pass the manager to the
    trainer — both fit loops invoke ``iteration_done`` per step. With a
    ``mode="async"`` manager the save is write-behind: ``last_saved``
    holds the :class:`AsyncSaveHandle` until it resolves."""

    def __init__(self, manager: CheckpointManager, frequency: int = 100):
        self.manager = manager
        self.frequency = max(int(frequency), 1)
        self.last_saved = None

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency == 0:
            self.last_saved = self.manager.save(model)

"""The flight recorder: a bounded lock-free ring of structured records
dumped atomically as JSONL.

Counterpart of ``deeplearning4j_tpu/observability/flightrec.py``, kept
as its own copy. Entries are step records (``type="step"``) or event
records (``type="event"``: a guard trip, a quarantined batch, a
checkpoint save, commit, repair or quarantine, a preemption notice),
interleaved in arrival order so a dump reads as a timeline. Recording
is one dict build and one slot write (slot reservation is one
``itertools.count`` draw); the ring dumps (temp file + ``os.replace``)
when a divergence guard trips, when a fit loop dies on an exception, on
demand, and on a preemption notice, where the dump rides the emergency
checkpoint as its ``flightrec.jsonl`` artifact
(``resilience/preemption.py``). The process-global recorder is None by
default, so an unconfigured run pays one global read a touchpoint.
Knobs: ``DL4J_TPU_FLIGHTREC_RING`` (capacity, default 512),
``DL4J_TPU_FLIGHTREC_DIR`` (dump directory, default the working
directory).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import tempfile
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

_ENV_RING = "DL4J_TPU_FLIGHTREC_RING"
_ENV_DIR = "DL4J_TPU_FLIGHTREC_DIR"

_DEFAULT_CAPACITY = 512
# /debugz and other live views read at most this many trailing
# records — the endpoint stays bounded no matter the ring size
DEBUG_TAIL_LIMIT = 100


def _jsonable(v):
    """Records must survive json.dumps no matter what a caller stuffs
    in (device arrays, numpy scalars): coerce scalars, stringify the
    rest. NaN/Inf become None (legal JSON, and a diverged loss is
    exactly when the dump matters)."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if v == v and v not in (float("inf"),
                                         float("-inf")) else None
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:  # numpy scalars and 0-d tensors
        return _jsonable(float(v))
    except Exception:
        return str(v)


class FlightRecorder:
    """Bounded ring of per-step records with atomic JSONL dumps."""

    def __init__(self, capacity: Optional[int] = None,
                 dump_dir: Optional[str] = None,
                 registry=None, enabled: bool = True,
                 clock=time.time):
        if capacity is None:
            capacity = int(os.environ.get(_ENV_RING,
                                          _DEFAULT_CAPACITY))
        self.capacity = max(1, int(capacity))
        self.dump_dir = dump_dir or os.environ.get(_ENV_DIR) or "."
        self.enabled = enabled
        self._clock = clock
        self._ring: List[Optional[dict]] = [None] * self.capacity
        self._seq = itertools.count()  # atomic slot reservation
        self._records_total = None
        self._dumps_total = None
        self._last_dump_step = None
        if registry is not None:
            self._records_total = registry.counter(
                "flightrec_records_total",
                help="flight recorder: records appended to the ring",
            )._default()
            self._dumps_total = registry.counter(
                "flightrec_dumps_total",
                help="flight recorder: ring dumps written, by reason",
                labels=("reason",),
            )
            self._last_dump_step = registry.gauge(
                "flightrec_last_dump_step",
                help="flight recorder: step of the newest step record "
                     "in the last dump (-1 before any dump)",
            )._default()
            self._last_dump_step.set(-1)

    # -- writers (hot path) --------------------------------------------

    def record(self, **fields) -> None:
        """Append one step record. Lock-free; cheap enough for every
        training step."""
        if not self.enabled:
            return
        seq = next(self._seq)
        rec = {"type": "step", "seq": seq, "t": self._clock()}
        rec.update(fields)
        self._ring[seq % self.capacity] = rec
        if self._records_total is not None:
            self._records_total.inc()

    def event(self, kind: str, **attrs) -> None:
        """Append one event record (compile / guard trip / quarantine
        / loss-scale overflow / preemption notice / ...)."""
        if not self.enabled:
            return
        seq = next(self._seq)
        rec = {"type": "event", "event": kind, "seq": seq,
               "t": self._clock()}
        rec.update(attrs)
        self._ring[seq % self.capacity] = rec
        if self._records_total is not None:
            self._records_total.inc()

    # -- readers --------------------------------------------------------

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """Last ``n`` records (default: everything retained), oldest
        first. Snapshot read: concurrent writers may overwrite slots
        being read — entries are filtered to well-formed dicts and
        re-sorted by seq, so the result is always a consistent
        subsequence of what was recorded."""
        snap = [r for r in list(self._ring) if isinstance(r, dict)]
        snap.sort(key=lambda r: r.get("seq", 0))
        if n is not None:
            snap = snap[-int(n):]
        return snap

    def last_step(self) -> Optional[int]:
        """Step of the newest step record, or None when the ring holds
        none — the resume-step cross-check for preemption dumps."""
        for rec in reversed(self.tail()):
            if rec.get("type") == "step" and "step" in rec:
                return int(rec["step"])
        return None

    # -- dumps ----------------------------------------------------------

    def dump_bytes(self, reason: str = "on_demand") -> bytes:
        """The ring as JSONL bytes: a header line (reason, record
        count, last step, wall time) then every retained record,
        oldest first. This is what rides the emergency checkpoint
        manifest as a CRC-verified artifact."""
        records = self.tail()
        header = {
            "type": "header",
            "reason": reason,
            "records": len(records),
            "capacity": self.capacity,
            "last_step": self.last_step(),
            "t": self._clock(),
            "pid": os.getpid(),
        }
        lines = [json.dumps(_jsonable(header))]
        lines.extend(json.dumps(_jsonable(r)) for r in records)
        self._note_dump(reason)
        return ("\n".join(lines) + "\n").encode()

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand") -> str:
        """Write the ring to ``path`` (default: a reason+pid-stamped
        file in ``dump_dir``) atomically: temp file in the target
        directory, fsync, then ``os.replace`` — a crash mid-dump
        leaves either the complete file or nothing, never a torn
        JSONL."""
        if path is None:
            step = self.last_step()
            name = (f"flightrec-{reason}-step{step if step is not None else 'NA'}"
                    f"-pid{os.getpid()}.jsonl")
            path = os.path.join(self.dump_dir, name)
        data = self.dump_bytes(reason)
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".flightrec-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        logger.warning("flight recorder dumped %d records to %s "
                       "(reason=%s)", len(self.tail()), path, reason)
        return path

    def _note_dump(self, reason: str) -> None:
        if self._dumps_total is not None:
            self._dumps_total.labels(reason=reason).inc()
        if self._last_dump_step is not None:
            step = self.last_step()
            self._last_dump_step.set(
                float(step) if step is not None else -1.0)


# -- the process-global recorder ----------------------------------------
#
# Low-level seams (divergence guard, preemption handler, compile
# accounting, fit exception paths) reach the recorder through this
# global: None by default, so unconfigured runs pay one module-global
# read + None check per touchpoint.

_GLOBAL_RECORDER: Optional[FlightRecorder] = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _GLOBAL_RECORDER


def set_flight_recorder(
        rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install ``rec`` as the process-global flight recorder and
    return the previous one (restore it when done — tests do)."""
    global _GLOBAL_RECORDER
    prev = _GLOBAL_RECORDER
    _GLOBAL_RECORDER = rec
    return prev


def record_event(kind: str, **attrs) -> None:
    """Event append on the global recorder, None-safe — the one-liner
    the guard/preemption/compile seams call."""
    rec = _GLOBAL_RECORDER
    if rec is not None:
        rec.event(kind, **attrs)


def dump_on_crash(reason: str) -> Optional[str]:
    """Best-effort dump of the global recorder — called from except
    paths that are about to re-raise, so it must never mask the
    original exception."""
    rec = _GLOBAL_RECORDER
    if rec is None or not rec.enabled:
        return None
    try:
        return rec.dump(reason=reason)
    except Exception:  # pragma: no cover - diagnostics must not mask
        logger.exception("flight recorder dump failed (reason=%s)",
                         reason)
        return None

"""Structured tracing: spans with explicit context handoff.

Counterpart of ``deeplearning4j_tpu/observability/trace.py``, kept as
the port's own copy. Counters say how many requests were shed or steps
skipped; a trace says why this one was slow: queue wait, batch
assembly, a CUDA-graph capture, a checkpoint restore. The ``Tracer`` /
``Span`` API is a small subset of the OpenTelemetry shape, built for:

- **threads, not coroutines**: a serving request crosses the handler
  thread, the admission path and the drain thread. There is no ambient
  context, so the handoff is explicit: the admitted work item carries
  its ``Span`` (or ``SpanContext``), and the drain thread starts
  children from it. One trace id follows the request end to end.
- **determinism as a test primitive**: ids come from a seeded
  ``random.Random`` (``Tracer(seed=...)``), so a pinned seed replays
  the same trace and span ids as the JAX package's tracer does.

Finished spans land in a bounded in-memory ring (``finished_spans()``)
and, with a sink attached, as JSONL, one object per span or event
(``JsonlSink``, bounded by rotation: at most about twice ``max_bytes``
on disk). A module-global tracer (disabled by default: every operation
a no-op costing one branch) lets low-level primitives (checkpoint save
and restore, retry attempts, breaker transitions, the profiler) emit
without a tracer threaded through every constructor:
``set_global_tracer(Tracer(...))`` turns them on.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Union


class SpanContext:
    """The portable identity of a span: what you hand to another
    thread so its spans join your trace."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"SpanContext({self.trace_id}, {self.span_id})"


class Span:
    """One named, timed operation. End it exactly once (``end()`` or
    the context-manager form, which also marks error status on an
    exception). Attribute/event mutation is single-writer by
    convention (the thread that owns the span)."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "start_time", "end_time", "attrs", "events", "status",
                 "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 start_time: float, attrs: Optional[dict] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_time = start_time
        self.end_time: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}
        self.events: List[dict] = []
        self.status = "ok"
        self._ended = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def add_event(self, name: str, **attrs) -> "Span":
        self.events.append({
            "name": name, "time": self.tracer.clock(), "attrs": attrs,
        })
        return self

    def end(self, status: Optional[str] = None) -> None:
        if self._ended:  # idempotent: double-end keeps the first record
            return
        self._ended = True
        if status is not None:
            self.status = status
        self.end_time = self.tracer.clock()
        self.tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.status == "ok":
            self.status = "error"
            self.attrs.setdefault("error_type", exc_type.__name__)
        self.end()

    def to_dict(self) -> dict:
        return {
            "kind": "span",
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start_time,
            "end": self.end_time,
            "duration_ms": (
                (self.end_time - self.start_time) * 1000.0
                if self.end_time is not None else None
            ),
            "status": self.status,
            "attrs": self.attrs,
            "events": self.events,
        }


class _NoopSpan:
    """Shared do-nothing span for disabled tracers: the hot path pays
    one flag check + one attribute lookup, nothing else."""

    __slots__ = ()
    context = SpanContext("", "")
    trace_id = ""
    span_id = ""

    def set_attr(self, key, value):
        return self

    def add_event(self, name, **attrs):
        return self

    def end(self, status=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


NOOP_SPAN = _NoopSpan()


class JsonlSink:
    """Bounded JSONL span/event sink: one JSON object per line,
    flushed per write (a crash loses at most the in-flight line).
    When the live file exceeds ``max_bytes`` it rotates to
    ``<path>.1`` (replacing the previous rotation), so disk usage is
    bounded at ~2x ``max_bytes`` however long the process runs."""

    def __init__(self, path, max_bytes: int = 8 << 20):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.path = os.fspath(path)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = self._f.tell()
        self.written = 0
        self.rotations = 0

    def write(self, record: dict) -> None:
        line = json.dumps(record, default=str) + "\n"
        data = line.encode("utf-8")
        with self._lock:
            if self._size + len(data) > self.max_bytes and self._size:
                self._f.close()
                os.replace(self.path, self.path + ".1")
                self._f = open(self.path, "a", encoding="utf-8")
                self._size = 0
                self.rotations += 1
            self._f.write(line)
            self._f.flush()
            self._size += len(data)
            self.written += 1

    def close(self) -> None:
        with self._lock:
            self._f.close()


class Tracer:
    """Span factory + finished-span collector (see module docstring).

    ``seed`` pins the id sequence (deterministic traces under test);
    ``clock`` is injectable; ``sink`` receives every finished span as
    a dict (``JsonlSink`` or anything with ``write(dict)``);
    ``enabled=False`` makes every operation a no-op."""

    def __init__(self, seed: Optional[int] = None, sink=None,
                 clock: Callable[[], float] = time.monotonic,
                 max_finished: int = 2048, enabled: bool = True):
        self.enabled = enabled
        self.clock = clock
        self.sink = sink
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._finished: "deque[Span]" = deque(maxlen=max_finished)

    def _new_ids(self) -> "tuple[str, str]":
        with self._lock:
            return (f"{self._rng.getrandbits(128):032x}",
                    f"{self._rng.getrandbits(64):016x}")

    def _child_id(self) -> str:
        with self._lock:
            return f"{self._rng.getrandbits(64):016x}"

    def start_span(self, name: str,
                   parent: Union[Span, SpanContext, None] = None,
                   attrs: Optional[dict] = None) -> Union[Span, _NoopSpan]:
        if not self.enabled:
            return NOOP_SPAN
        if isinstance(parent, _NoopSpan):
            parent = None
        if parent is not None and parent.trace_id:
            trace_id = parent.trace_id
            parent_id: Optional[str] = parent.span_id
            span_id = self._child_id()
        else:
            trace_id, span_id = self._new_ids()
            parent_id = None
        return Span(self, name, trace_id, span_id, parent_id,
                    self.clock(), attrs)

    def event(self, name: str, attrs: Optional[dict] = None,
              parent: Union[Span, SpanContext, None] = None) -> None:
        """A zero-duration record (breaker tripped, compile observed,
        retry attempt N failed) — a span whose start == end."""
        if not self.enabled:
            return
        span = self.start_span(name, parent=parent, attrs=attrs)
        span.end()

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._finished.append(span)
        if self.sink is not None:
            try:
                self.sink.write(span.to_dict())
            except Exception:
                pass  # telemetry must never take down the work

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


# -- global tracer ------------------------------------------------------

_global_tracer = Tracer(enabled=False)
_global_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer low-level primitives (checkpoint,
    retry, breaker, profiler) emit through. Disabled by default —
    enable with ``set_global_tracer``."""
    return _global_tracer


def set_global_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` globally; returns the previous one so tests
    can restore it."""
    global _global_tracer
    with _global_lock:
        prev = _global_tracer
        _global_tracer = tracer
        return prev

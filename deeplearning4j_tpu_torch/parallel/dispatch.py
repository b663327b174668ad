"""Bounded asynchronous step dispatch for the training loop.

Counterpart of ``deeplearning4j_tpu/parallel/dispatch.py``. A step of
the port is enqueued on the card's stream and returns at once; what
used to serialize the loop again is a host readback every step: the
divergence guard's ``bool(ok)``, or a listener reading
``score_value``. :class:`AsyncDispatchWindow`, shared by
``DistributedTrainer.fit`` and both engines' fit loop
(``core.fit_batches``), bounds and defers those waits:

- **bounded in flight**: at most ``max_in_flight`` steps may be
  enqueued and not yet complete; past that the window waits for the
  oldest step's completion event (a ``torch.cuda.Event`` recorded on
  the stream after the step: ``Event.synchronize()``, a completion
  wait that reads no value back), so the host cannot queue unbounded
  work or pin unbounded batch memory. On the CPU a step is complete
  when it returns and nothing is held.
- **lagged guard collection**: the guard's ok flag of step *i* is read
  at step *i + guard_lag* (default ``max_in_flight``). The step's
  select already kept the bad update out on the device, so the
  trajectory is bitwise the same whether the host learns of the bad
  step now or later; what moves by up to the lag is host policy (the
  skip ledger, the ``max_consecutive`` abort). The ``rollback`` policy
  restores a checkpoint, state the next steps would read, so it forces
  lag 0: the synchronous consult.
- **step gap**: ``training_step_gap_ms`` records the host time between
  consecutive dispatches (with ``training_prefetch_wait_ms`` it tells
  a host-bound loop from a device-bound one). The window's blocks are
  noted into the active step profiler's step (``dispatch_ms``; the
  drain at an epoch's end as ``device_ms``).

``drain()`` collects every outstanding flag and completion (epoch
boundaries, the end of a fit, a preemption's quiesce); ``abandon()``
drops them without consulting the guard (an exception unwinding).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from deeplearning4j_tpu_torch.observability import profiler

GAP_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                  1000.0)


def step_done_event(device):
    """A completion handle for the step just enqueued on ``device``: a
    ``torch.cuda.Event`` recorded on the current stream on the card,
    None on the CPU (the step is complete when it returns)."""
    if getattr(device, "type", None) != "cuda":
        return None
    import torch

    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class AsyncDispatchWindow:
    """One fit loop's dispatch window. ``guard_fn`` returns the
    currently installed ``DivergenceGuard`` (or None), so a listener
    that changes the guard mid-fit is honoured."""

    def __init__(self, model=None, guard_fn: Optional[Callable] = None,
                 max_in_flight: int = 2, guard_lag: Optional[int] = None,
                 registry=None):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if guard_lag is not None and guard_lag < 0:
            raise ValueError("guard_lag must be >= 0")
        self.model = model
        self.guard_fn = guard_fn or (lambda: None)
        self.max_in_flight = int(max_in_flight)
        self.guard_lag = guard_lag
        self._flags: deque = deque()     # uncollected (step, ok flag)
        self._inflight: deque = deque()  # completion events not retired
        self._last_dispatch: Optional[float] = None
        if registry is None:
            from deeplearning4j_tpu_torch.observability.metrics import (
                default_registry,
            )

            registry = default_registry()
        self._gap_hist = registry.histogram(
            "training_step_gap_ms", buckets=GAP_MS_BUCKETS,
            help="host wall-clock between consecutive step "
                 "dispatches (ms)",
        )._default()

    def _effective_lag(self, guard) -> int:
        if guard is not None and getattr(guard, "policy",
                                         None) == "rollback":
            return 0
        if self.guard_lag is not None:
            return self.guard_lag
        return self.max_in_flight

    def push(self, done=None, ok=None) -> None:
        """Record one enqueued step: ``done`` its completion event (None
        on the CPU) and the guard's ``ok`` flag (a 0-d bool tensor on
        the device, or None when no guard rode the step)."""
        now = time.perf_counter()
        if self._last_dispatch is not None:
            self._gap_hist.observe((now - self._last_dispatch) * 1e3)
        self._last_dispatch = now
        guard = self.guard_fn()
        if ok is not None and guard is not None:
            # the step the flag belongs to: by the time it is read the
            # model's count has moved on by up to the lag
            step = (int(self.model.iteration_count) - 1
                    if self.model is not None else -1)
            self._flags.append((step, ok))
            lag = self._effective_lag(guard)
            while len(self._flags) > lag:
                self._consult(self._flags.popleft(), guard)
        if done is not None:
            self._inflight.append(done)
            if len(self._inflight) > self.max_in_flight:
                # blocked here: device back-pressure, the step
                # profiler's dispatch_ms
                t0 = time.perf_counter()
                while len(self._inflight) > self.max_in_flight:
                    self._inflight.popleft().synchronize()
                prof = profiler.get_active_profiler()
                if prof is not None:
                    prof.note_dispatch_ms((time.perf_counter() - t0) * 1e3)

    def _consult(self, flag, guard) -> None:
        step, ok = flag
        if bool(ok):  # the one readback, amortized by the lag
            guard.good_step()
        else:
            guard.bad_step(self.model, step_index=step)

    @property
    def pending(self) -> int:
        """Uncollected guard flags plus steps not yet retired."""
        return len(self._flags) + len(self._inflight)

    def drain(self) -> None:
        """Collect every outstanding guard flag and wait for every step
        in flight. May raise the guard's ``DL4JFaultException`` (its
        ``max_consecutive`` abort, surfaced here)."""
        guard = self.guard_fn()
        while self._flags:
            flag = self._flags.popleft()
            if guard is not None:
                self._consult(flag, guard)
        t0 = time.perf_counter()
        had = bool(self._inflight)
        while self._inflight:
            self._inflight.popleft().synchronize()
        if had:
            prof = profiler.get_active_profiler()
            if prof is not None:
                # the wait for the card at an epoch's end
                prof.note_device_ms((time.perf_counter() - t0) * 1e3)

    def abandon(self) -> None:
        """Drop the outstanding work without consulting the guard (the
        exception-unwind path)."""
        self._flags.clear()
        self._inflight.clear()

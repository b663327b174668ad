"""Circuit breaker: fail fast when a dependency keeps failing.

Counterpart of ``deeplearning4j_tpu/resilience/breaker.py``, kept as
its own copy. The three-state breaker:

    CLOSED --[failure_threshold consecutive failures]--> OPEN
    OPEN   --[reset_timeout elapsed]-->                  HALF_OPEN
    HALF_OPEN --[probe succeeds]--> CLOSED
    HALF_OPEN --[probe fails]-->    OPEN   (re-stamped, trips += 1)

In HALF_OPEN at most ``half_open_max_probes`` calls are admitted at a
time; a rejected call raises ``CircuitOpenException`` with the seconds
until the next probe. The clock is injectable and every transition is
taken under a lock. Transitions go to the global tracer as
``breaker.transition`` events (the JAX package's name and attributes;
a no-op unless a tracer is installed) and to the flight recorder.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from deeplearning4j_tpu_torch.exceptions import CircuitOpenException

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Reusable three-state breaker (see module docstring).

    Two usage shapes:

    - wrap a callable: ``breaker.call(fn, *args)`` — raises
      ``CircuitOpenException`` when rejected;
    - manual accounting for request pipelines:
      ``try_acquire()`` -> run -> ``record_success()`` /
      ``record_failure()`` (every successful acquire MUST be paired
      with exactly one record call).
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 30.0,
                 half_open_max_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "breaker"):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout < 0:
            raise ValueError("reset_timeout must be >= 0")
        if half_open_max_probes < 1:
            raise ValueError("half_open_max_probes must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.half_open_max_probes = half_open_max_probes
        self.clock = clock
        self.name = name
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probes = 0
        self.trips = 0  # total CLOSED/HALF_OPEN -> OPEN transitions

    # -- state ----------------------------------------------------------

    def _emit_transition(self, frm: str, to: str) -> None:
        """A state change: a ``breaker.transition`` event on the global
        tracer and a record on the flight recorder (each a no-op unless
        installed). Called under the breaker lock; neither calls back
        into the breaker."""
        from deeplearning4j_tpu_torch.observability import flightrec
        from deeplearning4j_tpu_torch.observability.trace import get_tracer

        get_tracer().event("breaker.transition", attrs={
            "name": self.name, "from": frm, "to": to,
            "consecutive_failures": self._consecutive_failures,
            "trips": self.trips,
        })
        flightrec.record_event(
            "breaker_transition", name=self.name, frm=frm, to=to,
            consecutive_failures=self._consecutive_failures,
            trips=self.trips)

    def _state_locked(self) -> str:
        """Current state, applying the lazy OPEN -> HALF_OPEN
        transition (no timer thread: the clock is consulted on use)."""
        if (self._state == OPEN
                and self.clock() - self._opened_at >= self.reset_timeout):
            self._state = HALF_OPEN
            self._probes = 0
            self._emit_transition(OPEN, HALF_OPEN)
        return self._state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive_failures

    def retry_after(self) -> float:
        """Seconds until the breaker will admit a half-open probe
        (0.0 unless OPEN)."""
        with self._lock:
            if self._state_locked() != OPEN:
                return 0.0
            return max(
                0.0,
                self.reset_timeout - (self.clock() - self._opened_at),
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state_locked(),
                "trips": self.trips,
                "consecutive_failures": self._consecutive_failures,
            }

    # -- accounting -----------------------------------------------------

    def try_acquire(self) -> bool:
        """Admit or reject one call. CLOSED always admits; OPEN always
        rejects; HALF_OPEN admits up to ``half_open_max_probes``
        concurrent probes. An admitted call must record exactly one
        success or failure."""
        with self._lock:
            s = self._state_locked()
            if s == CLOSED:
                return True
            if s == OPEN:
                return False
            if self._probes < self.half_open_max_probes:
                self._probes += 1
                return True
            return False

    def _trip_locked(self) -> None:
        frm = self._state
        self._state = OPEN
        self._opened_at = self.clock()
        self._probes = 0
        self.trips += 1
        self._emit_transition(frm, OPEN)

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probes = 0
                self._emit_transition(HALF_OPEN, CLOSED)
            self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            s = self._state_locked()
            if s == HALF_OPEN:
                self._trip_locked()  # probe failed: straight back open
            elif (s == CLOSED
                  and self._consecutive_failures >= self.failure_threshold):
                self._trip_locked()

    # -- callable wrapper -----------------------------------------------

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under the breaker, raising
        ``CircuitOpenException`` when rejected. Any exception from
        ``fn`` counts as a failure and propagates."""
        if not self.try_acquire():
            raise CircuitOpenException(
                f"circuit {self.name!r} is {self.state}: "
                f"{self._consecutive_failures} consecutive failures",
                retry_after=self.retry_after(),
            )
        try:
            result = fn(*args, **kwargs)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result

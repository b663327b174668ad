"""Per-request deadlines.

Copy of ``deeplearning4j_tpu/resilience/deadline.py``. A ``Deadline``
is a wall budget stamped at admission and threaded through every stage
of a request (queue wait, predict), so the total latency is bounded.
The clock is injectable for deterministic tests.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Deadline:
    """Monotonic-clock budget. ``Deadline.after(0.5)`` expires 500 ms
    from now; ``Deadline.after(None)`` never expires."""

    def __init__(self, budget: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        if budget is not None and budget <= 0:
            raise ValueError("deadline budget must be > 0 (or None)")
        self.budget = budget
        self.clock = clock
        self._start = clock()

    @classmethod
    def after(cls, budget: Optional[float],
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(budget, clock=clock)

    def elapsed(self) -> float:
        return self.clock() - self._start

    def remaining(self) -> Optional[float]:
        """Seconds left (negative once expired); None when unbounded."""
        if self.budget is None:
            return None
        return self.budget - self.elapsed()

    def expired(self) -> bool:
        return self.budget is not None and self.elapsed() >= self.budget

    def check(self, what: str = "operation") -> None:
        """Raise ``DeadlineExceededException`` if expired."""
        if self.expired():
            from deeplearning4j_tpu_torch.exceptions import (
                DeadlineExceededException,
            )

            raise DeadlineExceededException(
                f"{what} exceeded its deadline: "
                f"{self.elapsed():.3f}s elapsed of {self.budget:.3f}s",
                elapsed=self.elapsed(), budget=self.budget)

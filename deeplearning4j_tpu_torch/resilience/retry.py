"""Bounded retry with exponential backoff and jitter.

Counterpart of ``deeplearning4j_tpu/resilience/retry.py``, kept as its
own copy: ``RetryPolicy`` (attempt ``i`` sleeps ``min(base_delay *
multiplier**i, max_delay)`` scaled by a factor in ``[1 - jitter, 1]``
drawn from ``random.Random(seed)``, so the same seed gives the JAX
package's delays), ``retry_call`` (an allowlist of transient
exceptions, an optional ``Deadline`` and ``total_timeout``; an
exhausted budget raises ``RetryExhaustedException`` chained to the last
cause) and the ``retrying`` decorator. ``sleep`` and ``clock`` are
injectable, so tests pass no wall time. Each retried failure, a
deadline cut and the exhaustion are ``retry.attempt`` /
``retry.deadline`` / ``retry.exhausted`` events on the global tracer,
as in the JAX package.
"""

from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

from deeplearning4j_tpu_torch.exceptions import RetryExhaustedException

# Transient-by-default: network/storage hiccups. OSError covers
# ConnectionError/TimeoutError/IOError; ValueError/KeyError and friends
# are logic bugs and propagate immediately.
DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)


@dataclass
class RetryPolicy:
    """Exponential backoff: attempt ``i`` (0-based) sleeps
    ``min(base_delay * multiplier**i, max_delay)`` scaled by a random
    factor in ``[1 - jitter, 1]`` (full-jitter-style decorrelation so a
    fleet of preempted workers doesn't thundering-herd the store).

    ``total_timeout`` bounds the WALL time of the whole retry loop
    (attempts + backoff sleeps) as a per-call ``Deadline``; it
    composes with an explicit ``retry_call(deadline=)`` — whichever
    budget is tighter wins — so a retry storm can never overrun the
    request deadline it runs under. ``clock`` is injectable for
    deterministic deadline tests."""

    max_attempts: int = 5
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.5
    retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON
    sleep: Callable[[float], None] = time.sleep
    seed: Optional[int] = None
    total_timeout: Optional[float] = None
    clock: Callable[[], float] = time.monotonic
    _rng: random.Random = field(init=False, repr=False, compare=False,
                                default=None)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.total_timeout is not None and self.total_timeout <= 0:
            raise ValueError("total_timeout must be > 0 (or None)")
        self._rng = random.Random(self.seed)

    def delay_for(self, attempt: int) -> float:
        """Backoff delay after failed attempt ``attempt`` (0-based)."""
        d = min(self.base_delay * self.multiplier ** attempt,
                self.max_delay)
        if self.jitter > 0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               deadline=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying allowlisted exceptions
    under ``policy`` (default ``RetryPolicy()``). Non-allowlisted
    exceptions propagate on the first occurrence; an exhausted budget
    raises ``RetryExhaustedException`` chained to the last cause.

    ``deadline`` (a ``resilience.Deadline``, e.g. the serving tier's
    per-request budget) and ``policy.total_timeout`` bound the loop's
    wall time: an attempt never STARTS past the deadline, and a
    backoff sleep that would overrun it raises
    ``DeadlineExceededException`` immediately (chained to the last
    failure) instead of burning the remaining budget asleep.
    ``DeadlineExceededException`` is deliberately not a
    ``TimeoutError``, so it is never itself retried."""
    from deeplearning4j_tpu_torch.observability.trace import get_tracer
    from deeplearning4j_tpu_torch.resilience.deadline import Deadline

    policy = policy or RetryPolicy()
    deadlines = [] if deadline is None else [deadline]
    if policy.total_timeout is not None:
        deadlines.append(Deadline.after(policy.total_timeout,
                                        clock=policy.clock))
    tracer = get_tracer()
    name = str(getattr(fn, "__name__", fn))
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        for d in deadlines:
            d.check(name)
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:  # noqa: PERF203 — the point
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            delay = policy.delay_for(attempt)
            bounded = [d for d in deadlines
                       if d.remaining() is not None]
            if bounded:
                tightest = min(bounded, key=lambda d: d.remaining())
                if tightest.remaining() <= delay:
                    tracer.event("retry.deadline", attrs={
                        "fn": name, "attempt": attempt + 1,
                        "backoff_s": round(delay, 6),
                        "remaining_s": round(tightest.remaining(), 6),
                    })
                    from deeplearning4j_tpu_torch.exceptions import (
                        DeadlineExceededException,
                    )

                    raise DeadlineExceededException(
                        f"{name} backoff ({delay:.3f}s before "
                        f"attempt {attempt + 2}) would overrun the "
                        f"deadline ({max(tightest.remaining(), 0.0):.3f}s "
                        "left)",
                        elapsed=tightest.elapsed(),
                        budget=tightest.budget,
                    ) from e
            tracer.event("retry.attempt", attrs={
                "fn": name, "attempt": attempt + 1,
                "error": type(e).__name__,
                "backoff_s": round(delay, 6),
            })
            policy.sleep(delay)
    tracer.event("retry.exhausted", attrs={
        "fn": name, "attempts": policy.max_attempts,
        "error": type(last).__name__ if last else None,
    })
    raise RetryExhaustedException(
        f"{name} failed after "
        f"{policy.max_attempts} attempts: {last!r}",
        attempts=policy.max_attempts,
        last_cause=last,
    ) from last


def retrying(policy: Optional[RetryPolicy] = None):
    """Decorator form of ``retry_call``:

        @retrying(RetryPolicy(max_attempts=3))
        def fetch(key): ...
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, **kwargs)

        return wrapper

    return deco

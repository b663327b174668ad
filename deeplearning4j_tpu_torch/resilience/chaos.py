"""Deterministic fault injection.

Counterpart of ``deeplearning4j_tpu/resilience/chaos.py``. Every
recovery path of the runtime is exercised in the tests without real
preemptions: a ``ChaosPolicy`` is a *seeded schedule* of which calls
fail with what exception (the same ``random.Random(seed)`` draws as
the JAX package's, so a seed gives both packages the same storm), and
``FaultyObjectStore`` / ``FlakyIterator`` thread it through the
storage SPI and the dataset iterator SPI; ``PoisonIterator`` corrupts
scheduled batches, ``ControlChannelChaos`` drops, delays and
partitions the control plane's requests, and ``KillAtStep`` SIGKILLs
its own process at a step. The same seed replays the same failure
sequence.

Failures are injected BEFORE the wrapped call runs, so a retried
operation observes at-most-once side effects per successful call —
matching real transient faults (connection refused, 503) rather than
torn writes, which the checkpoint layer's CRC manifests cover
separately.
"""

from __future__ import annotations

import os
import random
import signal
from typing import (
    Callable, Dict, IO, Iterator, List, Optional, Sequence, Set,
    Tuple, Union,
)

from deeplearning4j_tpu_torch.cloud.storage import ObjectStore
from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator


class ChaosError(OSError):
    """The default injected fault: an OSError subclass so the default
    retry allowlist (``retry.DEFAULT_RETRY_ON``) catches it, and
    greppable in logs as chaos-injected rather than real."""


class ChaosPolicy:
    """Seeded schedule of call failures, keyed by operation name.

    Two scheduling modes, composable:

    - **explicit**: ``fail_calls={"read": {0, 1}}`` fails the first two
      ``read`` calls (0-based per-op call index) — the classic
      "2 failures then succeed" retry test;
    - **random**: ``failure_rate=0.2, seed=1337`` fails each call with
      probability 0.2 from a private ``random.Random(seed)`` — same
      seed, same schedule, regardless of wall clock.

    ``exception`` may be an exception class or a factory
    ``(op, index) -> Exception``. ``max_failures`` bounds total
    injections so a high rate cannot starve a bounded-retry caller
    forever.
    """

    def __init__(
        self,
        seed: int = 0,
        failure_rate: float = 0.0,
        fail_calls: Optional[Dict[str, Set[int]]] = None,
        exception: Union[type, Callable] = ChaosError,
        max_failures: Optional[int] = None,
    ):
        if not 0.0 <= failure_rate <= 1.0:
            raise ValueError("failure_rate must be in [0, 1]")
        self.seed = seed
        self.failure_rate = failure_rate
        self.fail_calls = {
            op: set(ix) for op, ix in (fail_calls or {}).items()
        }
        self.exception = exception
        self.max_failures = max_failures
        self._rng = random.Random(seed)
        self.calls: Dict[str, int] = {}       # per-op call counts
        self.injected: List[tuple] = []       # (op, index) of each fault

    @classmethod
    def fail_first(cls, n: int, ops: Iterator[str] = ("read",),
                   exception: Union[type, Callable] = ChaosError,
                   ) -> "ChaosPolicy":
        """Fail the first ``n`` calls of each named op, then succeed."""
        return cls(
            fail_calls={op: set(range(n)) for op in ops},
            exception=exception,
        )

    def _make_exception(self, op: str, index: int) -> BaseException:
        if isinstance(self.exception, type):
            return self.exception(f"chaos: injected fault in {op!r} "
                                  f"(call #{index})")
        return self.exception(op, index)

    def check(self, op: str) -> None:
        """Account one call of ``op``; raise its scheduled fault if
        any. Call this at the TOP of every instrumented operation."""
        index = self.calls.get(op, 0)
        self.calls[op] = index + 1
        if (self.max_failures is not None
                and len(self.injected) >= self.max_failures):
            return
        scheduled = index in self.fail_calls.get(op, ())
        if not scheduled and self.failure_rate > 0.0:
            scheduled = self._rng.random() < self.failure_rate
        if scheduled:
            self.injected.append((op, index))
            raise self._make_exception(op, index)


class FaultyObjectStore(ObjectStore):
    """ObjectStore decorator that consults a ChaosPolicy before every
    delegated operation. Stack under ``RetryingObjectStore`` to prove
    the retry budget end-to-end."""

    def __init__(self, inner: ObjectStore, policy: ChaosPolicy):
        self.inner = inner
        self.policy = policy

    def keys(self, prefix: str = "") -> List[str]:
        self.policy.check("keys")
        return self.inner.keys(prefix)

    def open(self, key: str) -> IO[bytes]:
        self.policy.check("open")
        return self.inner.open(key)

    def read(self, key: str) -> bytes:
        self.policy.check("read")
        return self.inner.read(key)

    def write(self, key: str, data: bytes) -> None:
        self.policy.check("write")
        self.inner.write(key, data)

    def download(self, key: str, to_path) -> None:
        self.policy.check("download")
        self.inner.download(key, to_path)

    def upload(self, from_path, key: str) -> None:
        self.policy.check("upload")
        self.inner.upload(from_path, key)


POISON_KINDS = ("wrong_shape", "wrong_dtype", "label_range",
                "huge_values")


class PoisonIterator(DataSetIterator):
    """DataSetIterator decorator that CORRUPTS scheduled batches
    instead of failing them — the bad-data analog of
    :class:`FlakyIterator`, feeding the validating pipeline's
    quarantine path (``datasets/validate.py``).

    Two scheduling modes, composable (mirroring ``ChaosPolicy``):

    - **explicit**: ``poison={3: "wrong_dtype", 7: "label_range"}``
      corrupts exactly those 0-based batch offsets with the named
      corruption kind;
    - **random**: ``poison_rate=0.2, seed=1337`` corrupts each batch
      with probability 0.2, kind drawn from ``POISON_KINDS`` — same
      seed, same storm.

    Corruption kinds (each trips a distinct validator reason code):

    - ``wrong_shape``   — features lose their last column;
    - ``wrong_dtype``   — features become strings (the corrupt-CSV
      symptom: a header row or sentinel text lands in the payload);
    - ``label_range``   — one label row becomes 7.0 (outside any
      normalized/one-hot range);
    - ``huge_values``   — one feature element becomes 1e12
      (finite but absurd: the magnitude check's prey).

    The inner batch is COPIED before corruption, so a quarantined
    offset replayed from the store differs from the pristine source
    batch — never the other way around. ``poisoned`` records
    ``(offset, kind)`` of every corruption for exact-count asserts.
    """

    def __init__(self, inner: DataSetIterator, seed: int = 0,
                 poison_rate: float = 0.0,
                 poison: Optional[Dict[int, str]] = None):
        if not 0.0 <= poison_rate <= 1.0:
            raise ValueError("poison_rate must be in [0, 1]")
        for kind in (poison or {}).values():
            if kind not in POISON_KINDS:
                raise ValueError(
                    f"unknown poison kind {kind!r}; pick from "
                    f"{POISON_KINDS}"
                )
        self.inner = inner
        self.poison = dict(poison or {})
        self.poison_rate = poison_rate
        self.seed = seed
        self._rng = random.Random(seed)
        self._offset = 0
        self.poisoned: List[tuple] = []       # (offset, kind)

    def _corrupt(self, ds: DataSet, kind: str) -> DataSet:
        import copy

        import numpy as np

        ds = copy.deepcopy(ds)
        feats = ds.features
        labels = ds.labels
        if kind == "wrong_shape":
            ds.features = np.asarray(feats)[..., :-1]
        elif kind == "wrong_dtype":
            ds.features = np.asarray(feats).astype("U8")
        elif kind == "label_range":
            labels = np.array(labels, copy=True)
            labels[0, ...] = 7.0
            ds.labels = labels
        elif kind == "huge_values":
            feats = np.array(feats, copy=True)
            flat = feats.reshape(-1)
            flat[0] = 1e12
            ds.features = flat.reshape(feats.shape)
        return ds

    def next(self) -> DataSet:
        ds = self.inner.next()
        at = self._offset
        self._offset += 1
        kind = self.poison.get(at)
        if kind is None and self.poison_rate > 0.0:
            if self._rng.random() < self.poison_rate:
                kind = POISON_KINDS[
                    self._rng.randrange(len(POISON_KINDS))
                ]
        if kind is None:
            return ds
        self.poisoned.append((at, kind))
        return self._corrupt(ds, kind)

    def has_next(self) -> bool:
        return self.inner.has_next()

    def reset(self) -> None:
        self.inner.reset()
        self._offset = 0
        self._rng = random.Random(self.seed)  # same seed, same storm

    def batch(self) -> int:
        return self.inner.batch()

    def total_examples(self) -> int:
        return self.inner.total_examples()


class ControlChannelChaos:
    """Control-plane transport decorator: host-granularity network
    faults for the cross-host control plane
    (``parallel/control_plane.py``). Wraps any transport exposing
    ``request(payload, timeout_s=)`` and injects, deterministically:

    - **drops** — a :class:`ChaosPolicy` consulted per request, keyed
      by the protocol op (``join`` / ``renew`` / ``barrier`` / ...):
      a scheduled call raises :class:`ChaosError` (an ``OSError``, so
      the agent's bounded retry treats it exactly like a dropped
      heartbeat frame);
    - **delays** — ``delay={op: seconds}`` sleeps before delegating
      (injectable ``sleep``), the slow-network half of the storm;
    - **partition** — ``partition=(start, end)`` fails EVERY request
      whose global index falls in ``[start, end)`` regardless of op:
      the coordinator is unreachable, retries exhaust, and the agent
      concludes :class:`CoordinatorLostException`.

    ``requests`` records ``(op, index)`` of every attempt for exact
    asserts; the same seed replays the same storm."""

    def __init__(self, inner, policy: Optional[ChaosPolicy] = None,
                 *, delay: Optional[Dict[str, float]] = None,
                 partition: Optional[Tuple[int, int]] = None,
                 sleep: Callable[[float], None] = None):
        import time

        self.inner = inner
        self.policy = policy
        self.delay = dict(delay or {})
        self.partition = partition
        self.sleep = sleep if sleep is not None else time.sleep
        self.total = 0
        self.requests: List[tuple] = []

    def request(self, payload: dict, timeout_s=None) -> dict:
        op = str(payload.get("op"))
        index = self.total
        self.total += 1
        self.requests.append((op, index))
        if self.partition is not None:
            lo, hi = self.partition
            if lo <= index < hi:
                raise ChaosError(
                    f"chaos: control channel partitioned "
                    f"(request #{index}, op {op!r})")
        if self.policy is not None:
            self.policy.check(op)
        d = self.delay.get(op)
        if d:
            self.sleep(d)
        return self.inner.request(payload, timeout_s=timeout_s)


class KillAtStep:
    """Host-granularity chaos: an iteration listener that SIGKILLs its
    OWN process the moment ``iteration_done`` reaches ``at_step`` —
    the kill-rank-N-at-step-K storm. SIGKILL, not an exception: the
    point is that nothing gets to clean up, exactly like a real host
    loss. Arm it on rank N only; every other rank trains normally
    until the control plane declares the death."""

    def __init__(self, at_step: int, sig: int = signal.SIGKILL):
        self.at_step = int(at_step)
        self.sig = sig

    def iteration_done(self, model, iteration: int) -> None:
        if int(iteration) >= self.at_step:
            os.kill(os.getpid(), self.sig)


class FlakyIterator(DataSetIterator):
    """DataSetIterator decorator whose ``next()`` consults a
    ChaosPolicy before delegating — the deterministic stand-in for a
    flaky shard fetch. Because the fault fires before the inner cursor
    advances, a retry re-fetches the SAME batch: recovery preserves
    the data order, which the kill/resume equivalence tests rely on."""

    def __init__(self, inner: DataSetIterator, policy: ChaosPolicy):
        self.inner = inner
        self.policy = policy

    def next(self) -> DataSet:
        self.policy.check("next")
        return self.inner.next()

    def has_next(self) -> bool:
        return self.inner.has_next()

    def reset(self) -> None:
        self.inner.reset()

    def batch(self) -> int:
        return self.inner.batch()

    def total_examples(self) -> int:
        return self.inner.total_examples()

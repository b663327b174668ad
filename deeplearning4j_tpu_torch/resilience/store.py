"""Retrying decorator over the ``ObjectStore`` SPI.

Counterpart of ``deeplearning4j_tpu/resilience/store.py``:
``RetryingObjectStore`` runs every read / write / list / transfer of a
backend under a ``RetryPolicy``, with an optional ``CircuitBreaker`` on
top that trips when even the retry budget keeps running out. The
checkpoint manager's ``replica_store`` is typically one of these.
Whole-object ``read()`` is the resilient primitive: ``open()`` retries
the open, not a stream that dies mid-read.
"""

from __future__ import annotations

from typing import IO, List, Optional

from deeplearning4j_tpu_torch.cloud.storage import ObjectStore
from deeplearning4j_tpu_torch.resilience.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call


class RetryingObjectStore(ObjectStore):
    """``deadline_fn`` (optional) supplies the CURRENT request's
    ``Deadline`` per operation — the serving tier threads its
    admission-stamped budget here so a storage retry storm can never
    overrun the 504 envelope: attempts stop (and backoff sleeps are
    refused) the moment they would exceed the request budget,
    surfacing ``DeadlineExceededException`` instead of a late
    success nobody is waiting for. ``policy.total_timeout`` composes
    on top as a per-call wall bound independent of any request."""

    def __init__(self, inner: ObjectStore,
                 policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 deadline_fn=None):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.breaker = breaker
        self.deadline_fn = deadline_fn

    def _call(self, fn, *args):
        deadline = (self.deadline_fn()
                    if self.deadline_fn is not None else None)
        if self.breaker is not None:
            return self.breaker.call(
                retry_call, fn, *args, policy=self.policy,
                deadline=deadline,
            )
        return retry_call(fn, *args, policy=self.policy,
                          deadline=deadline)

    def keys(self, prefix: str = "") -> List[str]:
        return self._call(self.inner.keys, prefix)

    def open(self, key: str) -> IO[bytes]:
        return self._call(self.inner.open, key)

    def read(self, key: str) -> bytes:
        return self._call(self.inner.read, key)

    def write(self, key: str, data: bytes) -> None:
        self._call(self.inner.write, key, data)

    def download(self, key: str, to_path) -> None:
        self._call(self.inner.download, key, to_path)

    def upload(self, from_path, key: str) -> None:
        self._call(self.inner.upload, from_path, key)

"""Serving counters, the admission gauge and latency quantiles.

A small counterpart of ``deeplearning4j_tpu/serving/metrics.py``: the
counters ``/metrics`` reports, the in-flight count the k+q admission
bound reads, a bounded reservoir of request latencies for p50/p99, and
the number of requests per dispatched batch (the micro-batcher's
occupancy). The server renders them in the Prometheus text format
(``ModelServer.prometheus_metrics``); per-tenant views and the
drain-rate Retry-After wait for a later slice.
"""

from __future__ import annotations

import threading
from collections import Counter, deque
from typing import Optional

import numpy as np


class ServingMetrics:
    def __init__(self, reservoir_size: int = 1024):
        self._lock = threading.Lock()
        self._counters: Counter = Counter()
        self._inflight = 0
        self._latencies: deque = deque(maxlen=reservoir_size)
        self._batch_items: Counter = Counter()  # requests per batch

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    @property
    def inflight(self) -> int:
        return self._inflight

    def try_enter(self, bound: int) -> bool:
        """Admit one request if fewer than ``bound`` are in the system."""
        with self._lock:
            if self._inflight >= bound:
                return False
            self._inflight += 1
            return True

    def exit(self) -> None:
        with self._lock:
            self._inflight -= 1

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(seconds)

    def record_batch(self, n_items: int) -> None:
        with self._lock:
            self._batch_items[n_items] += 1

    def latencies(self) -> list:
        """The reservoir's request latencies (seconds), oldest first."""
        with self._lock:
            return list(self._latencies)

    def latency_quantile(self, q: float) -> Optional[float]:
        with self._lock:
            lat = list(self._latencies)
        return float(np.quantile(lat, q)) if lat else None

    def snapshot(self) -> dict:
        p50, p99 = self.latency_quantile(0.5), self.latency_quantile(0.99)
        with self._lock:
            return {
                "counters": dict(self._counters),
                "inflight": self._inflight,
                "latency_ms": {
                    "count": len(self._latencies),
                    "p50": None if p50 is None else p50 * 1e3,
                    "p99": None if p99 is None else p99 * 1e3,
                },
                "batch_items": {str(k): v for k, v in
                                sorted(self._batch_items.items())},
            }

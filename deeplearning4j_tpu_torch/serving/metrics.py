"""Serving counters, the admission gauge, latency quantiles, batch
occupancy, the per-tenant mirrors and the drain rate.

Counterpart of ``deeplearning4j_tpu/serving/metrics.py``: every
instrument lives in a per-server ``observability.MetricsRegistry``, so
one exporter renders the whole set (``ModelServer.prometheus_metrics``).
The counters keep the JAX package's names and help strings
(``COUNTER_HELP``); in the registry each is ``serving_<name>``. Beside
them:

- ``request_latency_seconds``: the request latency reservoir (JSON:
  ``latency_ms``) and ``queue_delay_ms`` (admission to drain pickup);
- ``batch_occupancy_rows``: valid rows per batched dispatch, bucketed
  on the shape ladder, and ``batch_items`` (requests per dispatch);
- the per-tenant mirrors labelled ``model`` (``MODEL_COUNTER_HELP``,
  ``model_latency_ms``, ``model_batch_occupancy_rows``);
- the completion-timestamp window whose rate is the drain rate the
  adaptive ``Retry-After`` divides the queue by.

The in-flight count is the admission bound, not telemetry: it stays
exact whatever the registry.
"""

from __future__ import annotations

import threading
from collections import Counter, deque
from typing import Optional, Sequence

from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry

COUNTER_HELP = {
    "requests_total": "every HTTP request seen",
    "predictions_total": "successful predicts",
    "shed_total": "503: queue full / draining",
    "breaker_rejected_total": "503: circuit open",
    "deadline_timeout_total": "504: deadline exceeded",
    "client_error_total": "4xx responses",
    "server_error_total": "5xx from model/transform faults",
    "abandoned_total": "worker finished after caller's 504",
    "reload_total": "successful hot swaps",
    "reload_failure_total": "failed reload attempts (old kept)",
    "reload_skipped_total": "no-op reloads (step already serving)",
    "batches_total": "batched dispatches executed",
    "batched_predictions_total": "requests answered via a batch",
    "solo_fallback_total": "requests too wide for the ladder",
    "batch_expired_total": "dropped (504) before stacking",
    "xla_compiles_total": "first forwards of a model version at a "
                          "(shape, dtype) it had not run, warm-up's "
                          "included (no XLA here: the port builds no "
                          "program per shape)",
    "post_warmup_compiles_total": "first forwards at a shape that "
                                  "warm-up did not run (ladder escapes)",
    "warmup_predicts_total": "eager bucket warmup forwards",
    "quota_rejected_total": "503: a tenant exceeded its own quota",
}

MODEL_COUNTER_HELP = {
    "model_requests_total": "per-model: requests routed to the tenant",
    "model_predictions_total": "per-model: successful predicts",
    "model_shed_total": "per-model: 503s (quota / queue / draining)",
    "model_deadline_timeout_total": "per-model: 504 deadline exceeded",
}


class ServingMetrics:
    """Thread-safe counters and reservoirs of one server, in the
    registry ``registry`` (a fresh one by default)."""

    COUNTERS = tuple(COUNTER_HELP)

    def __init__(self, reservoir_size: int = 1024,
                 occupancy_buckets: Optional[Sequence[int]] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        reg = self.registry
        self._lock = threading.Lock()
        self._counters = {
            name: reg.counter(f"serving_{name}",
                              help=COUNTER_HELP[name])._default()
            for name in self.COUNTERS}
        self._latency = reg.summary(
            "request_latency_seconds", reservoir_size=reservoir_size,
            help="request latency, handler to response")._default()
        self._queue_delay = reg.summary(
            "queue_delay_ms", reservoir_size=reservoir_size,
            help="admission to batch-drain pickup (ms), recent "
                 "window")._default()
        self._occupancy = (reg.histogram(
            "batch_occupancy_rows", occupancy_buckets,
            help="valid rows per batched dispatch (buckets = the shape "
                 "ladder)")._default() if occupancy_buckets else None)
        self._inflight_gauge = reg.gauge(
            "inflight_requests",
            help="requests admitted and not yet answered")._default()
        self._model_counters = {
            name: reg.counter(name, help=MODEL_COUNTER_HELP[name],
                              labels=("model",))
            for name in MODEL_COUNTER_HELP}
        self._model_latency = reg.summary(
            "model_latency_ms", reservoir_size=reservoir_size,
            help="per-model end-to-end latency (ms), recent window",
            labels=("model",))
        self._model_occupancy = (reg.histogram(
            "model_batch_occupancy_rows", occupancy_buckets,
            help="per-model valid rows per batched dispatch",
            labels=("model",)) if occupancy_buckets else None)
        self._batch_items: Counter = Counter()  # requests per dispatch
        self.inflight = 0  # admitted, response not yet written
        # completion timestamps: their rate is the drain rate
        self._completions: "deque[float]" = deque(maxlen=128)

    # -- counters ---------------------------------------------------------

    def incr(self, name: str, n: int = 1) -> None:
        self._counters[name].inc(n)

    def get(self, name: str) -> int:
        return self._counters[name].value

    def incr_model(self, name: str, model: str, n: int = 1) -> None:
        self._model_counters[name].labels(model).inc(n)

    # -- reservoirs -------------------------------------------------------

    def record_latency(self, seconds: float) -> None:
        self._latency.observe(seconds)

    def record_queue_delay(self, seconds: float) -> None:
        self._queue_delay.observe(seconds * 1000.0)

    def record_model_latency(self, model: str, seconds: float) -> None:
        self._model_latency.labels(model).observe(seconds * 1000.0)

    def record_batch(self, n_items: int, n_valid: Optional[int] = None,
                     model: Optional[str] = None) -> None:
        """One dispatch of ``n_items`` requests; a batched one also
        records its ``n_valid`` real rows (the ladder histogram)."""
        with self._lock:
            self._batch_items[n_items] += 1
        if n_valid is None:
            return
        self.incr("batches_total")
        if self._occupancy is not None:
            self._occupancy.observe(n_valid)
            if model is not None:
                self._model_occupancy.labels(model).observe(n_valid)

    # -- drain rate (the adaptive Retry-After's input) ---------------------

    def note_completion(self, now: float) -> None:
        """One admitted request left the system (answered)."""
        with self._lock:
            self._completions.append(now)

    def drain_rate(self) -> Optional[float]:
        """Completions per second over the recent window; None until
        two completions span a positive time."""
        with self._lock:
            if len(self._completions) < 2:
                return None
            span = self._completions[-1] - self._completions[0]
            if span <= 0:
                return None
            return (len(self._completions) - 1) / span

    # -- admission bound --------------------------------------------------

    def try_enter(self, bound: int) -> bool:
        """Admit one request if fewer than ``bound`` are in the system."""
        with self._lock:
            if self.inflight >= bound:
                return False
            self.inflight += 1
            self._inflight_gauge.set(self.inflight)
            return True

    def exit(self) -> None:
        with self._lock:
            self.inflight -= 1
            self._inflight_gauge.set(self.inflight)

    # -- snapshots --------------------------------------------------------

    def snapshot(self) -> dict:
        lat = self._latency.snapshot()
        with self._lock:
            out = {
                "counters": {n: c.value for n, c in self._counters.items()},
                "inflight": self.inflight,
                "batch_items": {str(k): v for k, v in
                                sorted(self._batch_items.items())},
            }
        out["latency_ms"] = {
            "count": lat["count"],
            **{k: None if lat[k] is None else lat[k] * 1e3
               for k in ("p50", "p90", "p99", "max")}}
        out["queue_delay_ms"] = self._queue_delay.snapshot()
        if self._occupancy is not None:
            out["batch_occupancy_rows"] = self._occupancy.snapshot()
        models = self.model_snapshot()
        if models:
            out["models"] = models
        return out

    def model_snapshot(self) -> dict:
        """{model: {counter values, latency quantiles}}: every tenant's
        p50 / p99 from one read."""
        out: dict = {}
        for name, fam in self._model_counters.items():
            for inst in fam.children():
                out.setdefault(inst.label_values[0], {})[name] = inst.value
        for inst in self._model_latency.children():
            out.setdefault(inst.label_values[0], {})[
                "latency_ms"] = inst.snapshot()
        return out

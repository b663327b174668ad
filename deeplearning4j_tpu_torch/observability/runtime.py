"""Runtime telemetry: device memory and train-step signals.

Counterpart of ``deeplearning4j_tpu/observability/runtime.py``:

- ``device_memory_stats()`` / ``publish_device_memory()``: each card's
  allocator statistics (``torch.cuda.memory_stats``), published as
  gauges; the CPU reports nothing and the gauges stay absent. The gauge
  names are the JAX package's (``jax_device_memory_bytes_in_use``,
  ``jax_device_memory_peak_bytes``), so one dashboard reads both.
- ``TelemetryListener``: an ``IterationListener`` that publishes step
  time, loss, the gradient's global norm and examples/s into a
  ``MetricsRegistry`` from both engines' fit loops and the distributed
  trainer's. The norm is one more output of the step, computed on the
  device (the engines' ``enable_step_telemetry``), so it rides a
  captured CUDA-graph chunk too; it is never a second pass on the host.

Reading the loss or the norm waits for the card, so those reads are
gated by ``frequency`` and, with ``defer_reads`` (the default), taken
one sample late, when the step has long finished; the step time and
the throughput are host clock reads and run every iteration.
"""

from __future__ import annotations

import time
from typing import Optional

from deeplearning4j_tpu_torch.observability.metrics import (
    MetricsRegistry,
    default_registry,
)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


def device_memory_stats() -> dict:
    """``{device index: stats}`` for every visible card, from its caching
    allocator (``torch.cuda.memory_stats``): ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved`` and ``bytes_limit`` (the
    card's total memory), the keys the JAX package reads. Empty on a
    machine without a card."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if not ms:
            continue
        _, total = torch.cuda.mem_get_info(i)
        out[str(i)] = {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total),
        }
    return out


def publish_device_memory(registry: Optional[MetricsRegistry] = None
                          ) -> dict:
    """Publish each card's memory gauges into ``registry`` (default: the
    process-wide one); returns the raw stats. Without a card nothing is
    published."""
    reg = registry if registry is not None else default_registry()
    stats = device_memory_stats()
    if not stats:
        return stats
    in_use = reg.gauge(
        "jax_device_memory_bytes_in_use",
        help="per-device HBM bytes currently allocated",
        labels=("device",),
    )
    peak = reg.gauge(
        "jax_device_memory_peak_bytes",
        help="per-device peak HBM bytes since process start",
        labels=("device",),
    )
    for dev, ms in stats.items():
        in_use.labels(device=dev).set(float(ms["bytes_in_use"]))
        peak.labels(device=dev).set(float(ms["peak_bytes_in_use"]))
    return stats


class TelemetryListener(IterationListener):
    """Publish train-step telemetry into a ``MetricsRegistry`` (JAX
    ``TelemetryListener``, the same metric names):

    - ``training_steps_total`` / ``training_examples_total`` (every
      iteration; host only);
    - ``training_step_ms`` summary and ``training_examples_per_sec``
      gauge (host clock between callbacks);
    - ``training_loss`` (gated by ``frequency``);
    - ``training_grad_global_norm``: the step's own norm output; the
      listener turns the model's ``enable_step_telemetry()`` on at its
      first callback;
    - the device-memory gauges (``publish_device_memory``) with
      ``publish_memory``;
    - the transform gauges ``remat_enabled``, ``loss_scale_value`` and
      ``loss_scale_overflows_total``.

    With ``defer_reads`` a sampled loss and norm are published at the
    next sampled callback (or ``flush()`` / ``on_epoch_end``), so the
    read never stalls the pipeline. ``supports_batched_iterations`` is
    False: the listener forces the per-step path over the scan (its
    per-step times would be fiction there); under megastep it takes one
    ``chunk_done`` a chunk from the chunk's one readback."""

    supports_batched_iterations = False

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 frequency: int = 1, grad_norm: bool = True,
                 publish_memory: bool = True, defer_reads: bool = True):
        self.registry = (registry if registry is not None
                         else default_registry())
        self.frequency = max(int(frequency), 1)
        self.grad_norm = grad_norm
        self.publish_memory = publish_memory
        reg = self.registry
        self._steps = reg.counter(
            "training_steps_total", help="optimizer steps completed"
        )._default()
        self._examples = reg.counter(
            "training_examples_total",
            help="training examples consumed",
        )._default()
        self._loss = reg.gauge(
            "training_loss", help="latest minibatch loss (sampled)"
        )._default()
        self._grad_norm = reg.gauge(
            "training_grad_global_norm",
            help="gradient global L2 norm of the sampled step",
        )._default()
        self._eps = reg.gauge(
            "training_examples_per_sec",
            help="host-clocked examples/sec over the last step",
        )._default()
        self._step_ms = reg.summary(
            "training_step_ms",
            help="host wall-clock per optimizer step (ms)",
        )._default()
        self._remat_enabled = reg.gauge(
            "remat_enabled",
            help="1 when activation rematerialization is active",
        )._default()
        self._loss_scale = reg.gauge(
            "loss_scale_value",
            help="current dynamic loss scale (float16 training)",
        )._default()
        self._ls_overflows = reg.counter(
            "loss_scale_overflows_total",
            help="loss-scale overflow steps (update skipped in-jit, "
                 "scale halved)",
        )._default()
        self._ls_overflows_seen = 0
        self._last_time: Optional[float] = None
        self._enabled_on = None
        self.defer_reads = defer_reads
        self._pending = None  # (loss, grad norm) device scalars

    def _enable(self, model) -> None:
        if (self.grad_norm and self.registry.enabled
                and self._enabled_on is not model):
            enable = getattr(model, "enable_step_telemetry", None)
            if enable is not None:
                enable(True)
            self._enabled_on = model

    def _publish_sample(self, loss_ref, gn_ref) -> None:
        for gauge, ref in ((self._loss, loss_ref), (self._grad_norm, gn_ref)):
            if ref is not None:
                try:
                    gauge.set(float(ref))
                except (TypeError, ValueError, RuntimeError):
                    pass

    def flush(self) -> None:
        """Publish the pending deferred sample."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self._publish_sample(*pending)

    def on_epoch_end(self, model) -> None:
        self.flush()

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        self._enable(model)
        if not self.registry.enabled:
            self._last_time = now
            return
        rows = getattr(model, "_last_batch_rows", None)
        self._steps.inc()
        if rows:
            self._examples.inc(int(rows))
        if self._last_time is not None:
            dt = now - self._last_time
            self._step_ms.observe(dt * 1000.0)
            if rows and dt > 0:
                self._eps.set(int(rows) / dt)
        self._last_time = now
        if iteration % self.frequency != 0:
            return
        loss_ref = getattr(model, "_last_score", None)
        gn_ref = getattr(model, "_last_grad_norm", None)
        if self.defer_reads:
            pending, self._pending = self._pending, (loss_ref, gn_ref)
            if pending is not None:
                self._publish_sample(*pending)
        else:
            self._publish_sample(loss_ref, gn_ref)
        self._publish_transforms(model)
        if self.publish_memory:
            publish_device_memory(self.registry)

    def chunk_done(self, model, it0: int, k: int, metrics) -> None:
        """One callback a megastep chunk, fed its read-back metrics: the
        counters advance by the chunk, the gauges take its last step."""
        now = time.perf_counter()
        self._enable(model)
        if not self.registry.enabled:
            self._last_time = now
            return
        rows = int(metrics.get("examples", 0) or 0)
        self._steps.inc(int(k))
        if rows:
            self._examples.inc(rows)
        if self._last_time is not None:
            dt = now - self._last_time
            if k > 0:
                self._step_ms.observe(dt * 1000.0 / k)
            if rows and dt > 0:
                self._eps.set(rows / dt)
        self._last_time = now
        if (it0 + k) // self.frequency == it0 // self.frequency:
            return
        scores = metrics.get("scores")
        if scores is not None and len(scores):
            self._loss.set(float(scores[-1]))
        gns = metrics.get("grad_norms")
        if gns is not None and len(gns):
            self._grad_norm.set(float(gns[-1]))
        self._publish_transforms(model)
        if self.publish_memory:
            publish_device_memory(self.registry)

    def _publish_transforms(self, model) -> None:
        """The transform gauges, sampled with the loss (the loss-scale
        state is on the device: reading it rides the same gated wait)."""
        from deeplearning4j_tpu_torch.observability import flightrec

        self._remat_enabled.set(
            1.0 if getattr(model, "remat", "none") != "none" else 0.0)
        ls = getattr(model, "_loss_scale_state", None)
        if ls is None:
            return
        self._loss_scale.set(float(ls["scale"]))
        seen = int(ls["overflows"])
        if seen > self._ls_overflows_seen:
            self._ls_overflows.inc(seen - self._ls_overflows_seen)
            flightrec.record_event(
                "loss_scale_overflow", overflows=seen,
                new=seen - self._ls_overflows_seen,
                scale=float(ls["scale"]))
        self._ls_overflows_seen = seen

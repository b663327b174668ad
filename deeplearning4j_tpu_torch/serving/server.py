"""The serving tier: admission control, deadlines, micro-batching, a
multi-tenant registry with weight paging, hot reload, the circuit
breaker and the AOT bundle.

Counterpart of ``deeplearning4j_tpu/serving/server.py``:

- **admission control**: at most ``workers + queue_depth`` requests are
  in the system, and a tenant with a ``quota`` at most that many; the
  excess is shed at once with ``503`` and an adaptive ``Retry-After``
  (``retry_after_value``: queue depth over the observed drain rate,
  clamped to [``RETRY_AFTER_MIN``, min(``RETRY_AFTER_MAX``,
  ``retry_after``)]);
- **deadlines**: one ``Deadline`` per request spans queue wait and
  predict; expiry answers ``504`` with elapsed / budget;
- **circuit breaking**: a ``CircuitBreaker`` guards the predict path;
  after N consecutive failures requests fail fast with ``503
  circuit_open`` until a half-open probe succeeds;
- **micro-batching**: the drain thread coalesces queued requests of one
  tenant (up to the tenant's ladder or ``max_batch_size`` rows, or
  ``batch_timeout_ms``) into one forward on a zero-padded bucket shape
  through the engine's ``output_padded`` and slices each request's rows
  back out; a request wider than the largest bucket runs alone. Every
  tenant's buckets run at ``start()`` / ``reload()`` (warm-up, raising
  if a model cannot run them), and a shape that escapes the ladder is
  counted and logged (``compile_cache.py``);
- **multi-tenancy**: ``models={name: model | path | spec}`` serves
  named models, ``MultiLayerNetwork`` or ``ComputationGraph``, with
  ``POST /predict {"model": name}``, a ``404`` listing the names, and
  ``GET /models``; ``max_device_models`` / ``max_device_bytes`` page
  cold tenants' weights to pinned host memory (``registry.py``);
- **hot reload**: ``POST /admin/reload`` (or ``reload()``, by path,
  object-store key, ``CheckpointManager`` or ``{"step": N}``;
  ``watch()`` polls the manager) restores the new version off the
  drain thread, checks it with a canary through the padded path, warms
  it, then swaps it; in-flight requests finish on the old version, a
  failed reload keeps serving the old one, and the step already
  serving is a counted no-op unless ``{"force": true}``;
- **readiness vs liveness**: ``/healthz`` is up while serving,
  ``/readyz`` flips while reloading, on an open breaker, at the queue
  high-water mark and while draining;
- **graceful drain**: ``stop(drain_timeout=)``, also on a preemption
  notice (``install_preemption_drain``);
- **AOT**: ``compile_cache`` points the kernel build at the persistent
  cache directory (``compile/persistent.py``), and ``aot`` installs the
  checkpoint's serving bundle (the built kernel library and the
  buckets' shapes, ``compile/aot.py``) at ``start()`` / ``reload()``
  before the canary and the warm-up, so a server restarted from such a
  checkpoint into an empty cache directory builds nothing;
- **shadow scoring**: ``set_shadow(scorer)`` mirrors the default
  tenant's forwards to ``scorer.observe`` strictly after the clients'
  responses, and a scorer's fault never reaches them.

Error responses use the shared envelope (``envelope.py``): ``400``
malformed payload, ``404`` unknown model, ``411`` / ``413`` body
framing, ``422`` shape-invalid features, ``500`` model fault with an
opaque ``error_id``, ``503`` shed / quota / circuit open / draining,
``504`` deadline.

The models run on the server's ``device`` (default ``"cuda"``; raises
without a card unless ``device="cpu"``): the drain thread launches the
kernels on PyTorch's current stream of that thread.

Tracing (``tracer=``, a ``observability.trace.Tracer``; disabled by
default): one ``serving.request`` root span a request with the JAX
server's children, ``serving.admission``, ``serving.queue``,
``serving.batch_assembly`` and ``serving.predict``; first forwards at a
new shape are ``xla.compile`` events. ``GET /metrics?format=prometheus``
renders the server's registry in the Prometheus text format; JSON stays
the default.

Input width: the JAX server validates against the first layer's
``n_in``, which for a ``convolutional_flat`` model such as LeNet is the
channel count (1), so it refuses LeNet's 784-wide rows. The port
validates against the flat size of the model's (first) input type
(``feature_dim``): requests are rows of that width, and a ``transform``
reshapes them for a convolutional input.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.observability import flightrec, profiler
from deeplearning4j_tpu_torch.observability.export import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE,
)
from deeplearning4j_tpu_torch.observability.export import (
    parse_format_query,
    prometheus_text,
)
from deeplearning4j_tpu_torch.observability.trace import Tracer
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device
from deeplearning4j_tpu_torch.resilience.breaker import OPEN, CircuitBreaker
from deeplearning4j_tpu_torch.resilience.deadline import Deadline
from deeplearning4j_tpu_torch.serving.batcher import (
    BucketLadder,
    MicroBatcher,
    fill_chunks,
    pad_rows,
)
from deeplearning4j_tpu_torch.serving.compile_cache import CompileCache
from deeplearning4j_tpu_torch.serving.envelope import (
    HttpBodyError,
    deadline_envelope,
    error_envelope,
    error_id_for,
    read_request_body,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.registry import (
    ModelEntry,
    ModelRegistry,
    ModelVersion,
)

logger = logging.getLogger(__name__)

MAX_BODY = 64 * 1024 * 1024

# the adaptive Retry-After's clamp: never "come back at once", never
# longer than any queue this tier may build
RETRY_AFTER_MIN = 0.05
RETRY_AFTER_MAX = 5.0


def feature_dim(model) -> Optional[int]:
    """Width of one request row: the flat size of the model's (first)
    input type when it has one, else the first layer's ``n_in``."""
    conf = getattr(model, "conf", None)
    if conf is None:
        return None
    it = getattr(conf, "input_type", None)
    if it is None and getattr(conf, "input_types", None):
        it = conf.input_types[0]
    if it is not None and it.kind in ("feedforward", "convolutionalFlat",
                                      "convolutional"):
        return int(it.flat_size())
    layers = getattr(conf, "layers", None)
    n_in = getattr(layers[0], "n_in", None) if layers else None
    if isinstance(n_in, int) and n_in > 0:
        return n_in
    return None


def _host(out) -> np.ndarray:
    if isinstance(out, (list, tuple)):
        out = out[0]
    if torch.is_tensor(out):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


class _NoReloadSource(ValueError):
    pass


class _ServingHTTPServer(ThreadingHTTPServer):
    """A burst of concurrent connects must reach admission control (and
    be shed there with a 503), not be reset by a 5-deep listen backlog."""

    request_queue_size = 128
    daemon_threads = True


class _WorkItem:
    """One admitted predict: features + deadline in, response out. The
    handler thread owns the socket; the drain thread only fills
    ``response`` and sets ``done``. ``lock`` arbitrates the
    queue-expiry race (handler gives up vs drain thread starts)."""

    __slots__ = ("features", "deadline", "done", "response", "lock",
                 "started", "cancelled", "timed_out", "rows", "squeeze",
                 "enqueued_at", "span", "queue_span", "assembly_span",
                 "entry")

    def __init__(self, features, deadline: Deadline,
                 entry: Optional[ModelEntry] = None):
        self.entry = entry  # the tenant this predict belongs to
        self.features = features
        self.deadline = deadline
        self.done = threading.Event()
        self.response = None  # (code, body_dict, headers_dict)
        self.lock = threading.Lock()
        self.started = False
        self.cancelled = False   # handler gave up before the drain started it
        self.timed_out = False   # handler wrote a 504 already
        shape = np.shape(features)
        self.rows = int(shape[0]) if len(shape) >= 2 else 1
        self.squeeze = len(shape) == 1  # 1-d request: 1-d response
        self.enqueued_at = time.monotonic()
        # the trace handoff: the handler thread sets the request's root
        # span and its queue span; the drain thread ends the queue span
        # and parents its assembly and predict spans on the root
        self.span = None
        self.queue_span = None
        self.assembly_span = None

    def finish(self, code: int, body: dict, headers=None) -> bool:
        """Record the result; False when the handler already answered
        504 (result abandoned)."""
        with self.lock:
            abandoned = self.timed_out
            self.response = (code, body, headers or {})
        self.done.set()
        return not abandoned


class ModelServer:
    """Serve one model, or several named ones, over HTTP.

    Endpoints::

        GET  /healthz       liveness: process up
        GET  /readyz        readiness: routable (flips under stress)
        GET  /metrics       counters, quantiles, paging (JSON or
                            ?format=prometheus)
        GET  /models        per-tenant registry and paging states
        GET  /debugz        versions, config, models, cost models
        POST /predict       {"features": [[...]] or [...], "model"?}
        POST /admin/reload  {} | {"path"|"key"|"step": ..., "model"?,
                            "force"?}

    ``model_or_path`` is a ``MultiLayerNetwork`` or ``ComputationGraph``
    on ``device``, a checkpoint zip path (restored onto ``device``), or
    None with ``checkpoint_manager=`` (its latest version) or with
    ``models=`` only. ``models={name: instance | path | {"model" |
    "path": ..., "quota": k, "deadline": s, "pinned": bool,
    "max_batch_size": n | "ladder": [...]}}`` adds named tenants.
    ``deadline`` (seconds) bounds queue wait + predict per request;
    ``store`` (an ``ObjectStore``) enables reload by key; ``canary``
    is the features of the reload check (default a zero row of the
    input width). ``micro_batch=False`` runs one forward per request on
    ``workers`` threads. ``transform`` maps each request's features
    before the forward. ``compile_cache``: True (the directory from
    ``DL4J_TPU_COMPILE_CACHE_DIR`` / ``build/``), a directory, or False;
    ``aot``: install a manager-sourced checkpoint's serving bundle.
    """

    def __init__(self, model_or_path=None, host: str = "127.0.0.1",
                 port: int = 0, transform=None,
                 output_classes: bool = False, *,
                 workers: int = 4, queue_depth: int = 32,
                 deadline: Optional[float] = None,
                 retry_after: float = 1.0,
                 breaker: Optional[CircuitBreaker] = None,
                 checkpoint_manager=None, store=None, canary=None,
                 queue_high_water: Optional[int] = None,
                 reservoir_size: int = 1024,
                 micro_batch: bool = True,
                 max_batch_size: int = 32,
                 batch_timeout_ms: float = 2.0,
                 bucket_ladder=None,
                 batch_workers: int = 1,
                 tracer: Optional[Tracer] = None,
                 compile_cache=True,
                 aot: bool = True,
                 models: Optional[dict] = None,
                 max_device_models: Optional[int] = None,
                 max_device_bytes: Optional[int] = None,
                 device=None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        self.device = resolve_device(device)
        self.transform = transform
        self.output_classes = output_classes
        self.workers = workers
        self.queue_depth = queue_depth
        self.deadline = deadline
        self.retry_after = retry_after
        self.breaker = breaker or CircuitBreaker(name="predict")
        self.checkpoint_manager = checkpoint_manager
        self.store = store
        self.canary = canary
        self.queue_high_water = (queue_high_water
                                 if queue_high_water is not None
                                 else max(queue_depth, 1))
        if micro_batch:
            if batch_workers < 1:
                raise ValueError("batch_workers must be >= 1")
            ladder = (bucket_ladder if isinstance(bucket_ladder, BucketLadder)
                      else BucketLadder(bucket_ladder, max_batch_size))
            self.batcher: Optional[MicroBatcher] = MicroBatcher(
                ladder, batch_timeout_ms)
            # one drain thread by default: it coalesces, so more would
            # split batches
            self.batch_workers = batch_workers
            occupancy = ladder.buckets
        else:
            self.batcher = None
            self.batch_workers = workers
            occupancy = None
        self.metrics = ServingMetrics(reservoir_size, occupancy)
        reg = self.metrics.registry
        # per-bucket cost models, built at warm-up off the request path
        self._bucket_costs: dict = {}
        self._peak_flops = profiler.peak_flops(self.device)[0]
        self._peak_bw = profiler.peak_bytes_per_sec(self.device)[0]
        self._g_bucket_mfu = reg.gauge(
            "step_mfu", labels=("bucket",),
            help="per-bucket MFU of the last batched forward")
        self._g_bucket_fps = reg.gauge(
            "step_flops_per_sec", labels=("bucket",),
            help="per-bucket achieved FLOP/s (cost model / forward wall)")
        self._g_bucket_bps = reg.gauge(
            "step_bytes_per_sec", labels=("bucket",),
            help="per-bucket achieved memory bytes/s")
        self._g_bucket_roofline = reg.gauge(
            "step_roofline_class", labels=("bucket",),
            help="per-bucket roofline class (0 unknown / 1 compute / 2 "
                 "memory bound)")
        # disabled by default: every span operation a no-op
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=False)
        self.compile_cache = CompileCache(self.metrics, self.tracer)
        self.compile_cache_dir: Optional[str] = None
        if compile_cache is not False:
            from deeplearning4j_tpu_torch.compile.persistent import (
                enable_persistent_cache,
            )

            self.compile_cache_dir = enable_persistent_cache(
                compile_cache if isinstance(compile_cache, str) else None,
                registry=reg)
        self.aot = aot
        self._aot_buckets = 0
        self._source_path: Optional[str] = None
        self._watched_step: Optional[int] = None
        self._last_restore_info = None  # CheckpointInfo when manager-sourced
        # the shadow scorer: offered the default tenant's forwards after
        # the clients' responses (set_shadow)
        self.shadow = None
        self.model_registry = ModelRegistry(
            max_device_models=max_device_models,
            max_device_bytes=max_device_bytes, metrics_registry=reg)
        if (model_or_path is not None or checkpoint_manager is not None
                or not models):
            model, source = self._initial_model(model_or_path)
            self.model_registry.add(
                "default", ModelVersion(model, 1, source,
                                        self.compile_cache.register()),
                source_path=self._source_path, default=True)
        for name, spec in (models or {}).items():
            self._add_model(name, spec)
        self._model_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._reloading = False
        self._draining = False
        self._stop_workers = False
        self._queue: "queue.Queue[_WorkItem]" = queue.Queue(
            maxsize=queue_depth + workers)
        self._worker_threads: List[threading.Thread] = []
        self._watch_thread: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        self._httpd = _ServingHTTPServer((host, port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # the default tenant's current version
    @property
    def _active(self) -> ModelVersion:
        return self.model_registry.entry().current

    @property
    def model(self):
        return self._active.model

    @property
    def model_version(self) -> int:
        return self._active.version

    def _restore(self, path_or_bytes):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model,
            restore_model_from_bytes,
        )

        if isinstance(path_or_bytes, (bytes, bytearray)):
            return restore_model_from_bytes(path_or_bytes, device=self.device,
                                            load_updater=False)
        return restore_model(path_or_bytes, device=self.device,
                             load_updater=False)

    def _check_model(self, model):
        if not hasattr(model, "output_padded"):
            raise TypeError(f"ModelServer serves a MultiLayerNetwork or a "
                            f"ComputationGraph, not {type(model).__name__}")
        if getattr(model, "device", self.device) != self.device:
            raise ValueError(f"the model lives on {model.device}; this "
                             f"server runs on {self.device}")
        return model

    def _add_model(self, name: str, spec) -> ModelEntry:
        """Register one named tenant from an instance, a checkpoint path
        or a spec dict (quota / deadline default to the server-wide
        knobs, the ladder to the shared one)."""
        opts = {}
        source_path = None
        if isinstance(spec, dict):
            opts = spec
            spec = opts.get("model", opts.get("path"))
            if spec is None:
                raise ValueError(f"model {name!r}: spec dict needs a "
                                 "'model' instance or a 'path'")
        if isinstance(spec, str):
            source_path = spec
            model = self._restore(spec)
        else:
            model = spec
        self._check_model(model)
        ladder = None
        if opts.get("ladder") is not None:
            ladder = BucketLadder(opts["ladder"])
        elif opts.get("max_batch_size") is not None:
            ladder = BucketLadder(None, opts["max_batch_size"])
        return self.model_registry.add(
            name, ModelVersion(model, 1, source_path or type(model).__name__,
                               self.compile_cache.register()),
            quota=opts.get("quota"), deadline=opts.get("deadline"),
            pinned=bool(opts.get("pinned", False)), ladder=ladder,
            source_path=source_path)

    def set_shadow(self, scorer) -> None:
        """(Un)install a shadow scorer (any object with
        ``observe(features, live_output, live_ms)``)."""
        self.shadow = scorer

    def _offer_shadow(self, entry: ModelEntry, feats, out,
                      live_ms: float) -> None:
        """Mirror one successful forward of the default tenant to the
        shadow scorer, after the clients' responses completed; its
        faults are logged and swallowed."""
        sh = self.shadow
        if sh is None or entry.name != self.model_registry.default_name:
            return
        try:
            sh.observe(feats, out, live_ms)
        except Exception:
            logger.exception("shadow observe failed (ignored)")

    def _ladder_for(self, entry: ModelEntry) -> Optional[BucketLadder]:
        if self.batcher is None:
            return None
        return entry.ladder or self.batcher.ladder

    def _initial_model(self, model_or_path):
        if isinstance(model_or_path, str):
            self._source_path = model_or_path
            return self._restore(model_or_path), model_or_path
        if model_or_path is not None:
            return (self._check_model(model_or_path),
                    type(model_or_path).__name__)
        if self.checkpoint_manager is not None:
            model, info = self.checkpoint_manager.restore_latest(
                load_updater=False, device=self.device)
            self._watched_step = info.step
            self._last_restore_info = info
            return model, f"checkpoint-step-{info.step}"
        raise ValueError(
            "provide a model, a checkpoint path, or checkpoint_manager=")

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ModelServer":
        """Install the AOT bundle, warm every tenant's buckets (raising
        if a model cannot run them), page out the over-budget tail, then
        start the drain pool and the listener."""
        try:
            self._aot_buckets = self._install_aot(
                self._active.model, self._active.shapes,
                self._last_restore_info)
            for name in self.model_registry.names():
                entry = self.model_registry.entry(name)
                self._warm_model(entry.current.model, entry.current.shapes,
                                 self._ladder_for(entry), name=entry.name)
        except BaseException:
            self._httpd.server_close()
            raise
        # warm-up ran every tenant on the device on purpose; now page
        # the over-budget tail out
        self.model_registry.enforce_budget()
        for i in range(self.batch_workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"dl4j-serve-worker-{i}")
            t.start()
            self._worker_threads.append(t)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="dl4j-serve")
        self._thread.start()
        return self

    def stop(self, drain_timeout: float = 5.0) -> bool:
        """Graceful drain: stop admitting (new work gets ``503
        draining``), wait up to ``drain_timeout`` seconds for in-flight
        requests, then close the listener and the pool. True when the
        drain emptied."""
        self._draining = True
        end = time.monotonic() + max(drain_timeout, 0.0)
        while time.monotonic() < end:
            if self.metrics.inflight == 0 and self._queue.empty():
                break
            time.sleep(0.01)
        drained = self.metrics.inflight == 0 and self._queue.empty()
        self.stop_watch()
        self._stop_workers = True
        for t in self._worker_threads:
            t.join(timeout=5)
        if self._thread is not None:  # shutdown() hangs if never served
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()
        return drained

    def install_preemption_drain(self, handler=None,
                                 drain_timeout: float = 5.0
                                 ) -> "ModelServer":
        """Turn a preemption notice (SIGTERM / SIGINT or a simulated
        one) into the graceful drain: new work sheds with ``503
        draining``, in-flight requests finish, then the listener closes.
        Uses the active ``resilience.preemption.PreemptionHandler``,
        installing a default one if none exists."""
        from deeplearning4j_tpu_torch.resilience import preemption

        h = handler if handler is not None else preemption.active_handler()
        if h is None:
            h = preemption.PreemptionHandler().install()
        h.on_preemption(lambda reason: self.stop(drain_timeout=drain_timeout))
        return self

    # -- drain pool -----------------------------------------------------

    def _worker_loop(self) -> None:
        carry: Optional[_WorkItem] = None
        while not self._stop_workers:
            if carry is not None:
                item, carry = carry, None
            else:
                try:
                    item = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
            try:
                if self.batcher is None:
                    self._process(item)
                else:
                    items, carry = self.batcher.collect(
                        self._queue, item, lambda: self.metrics.inflight)
                    self._process_batch(items)
            except Exception:  # never kill a pool thread
                logger.exception("serve worker crashed on a request")
                item.finish(500, error_envelope(
                    "internal", 500, "internal server error"))

    def _expired(self, item: _WorkItem, entry: ModelEntry,
                 batched: bool) -> bool:
        """Answer 504 when the item's deadline ran out in the queue."""
        if not item.deadline.expired():
            return False
        self.metrics.incr("deadline_timeout_total")
        self.metrics.incr_model("model_deadline_timeout_total", entry.name)
        if batched:
            self.metrics.incr("batch_expired_total")
            item.assembly_span.end("timeout")
        item.finish(504, deadline_envelope(
            item.deadline, "deadline expired while coalescing" if batched
            else "deadline expired while queued"))
        return True

    def _circuit_open(self, n: int = 1):
        self.metrics.incr("breaker_rejected_total", n)
        return error_envelope(
            "circuit_open", 503, "model circuit is open; failing fast",
            retry_after=round(self.breaker.retry_after(), 3),
        ), {"Retry-After": self._retry_after_header()}

    def _model_error(self, e: Exception, n: int = 1) -> dict:
        self.breaker.record_failure()
        eid = error_id_for(e)
        logger.error("predict failed (error_id=%s)", eid, exc_info=True)
        self.metrics.incr("server_error_total", n)
        return error_envelope("model_error", 500,
                              "prediction failed; see server log",
                              error_id=eid)

    def _body(self, entry: ModelEntry, mv: ModelVersion,
              out: np.ndarray) -> dict:
        body = {"output": out.tolist(), "model_version": mv.version}
        if len(self.model_registry) > 1:
            body["model"] = entry.name
        if self.output_classes and out.ndim == 2:
            body["classes"] = out.argmax(axis=1).tolist()
        return body

    def _process(self, item: _WorkItem) -> None:
        """One request alone: micro-batching off, or wider than the
        largest bucket."""
        entry = item.entry or self.model_registry.entry()
        if not item.started:
            with item.lock:
                if item.cancelled:
                    return
                item.started = True
            if item.queue_span is not None:
                item.queue_span.end()
            if self._expired(item, entry, batched=False):
                return
        if not self.breaker.try_acquire():
            item.finish(503, *self._circuit_open())
            return
        # the forward bracket: bump the tenant's LRU time, fault its
        # weights in when paged out, and hold it against the evictor
        pagein_ms = self.model_registry.touch(entry)
        mv = entry.current  # the version this request runs on
        pspan = self.tracer.start_span(
            "serving.predict", parent=item.span,
            attrs={"mode": "solo", "model": entry.name,
                   "model_version": mv.version})
        if pagein_ms is not None:
            pspan.set_attr("weight_pagein_ms", round(pagein_ms, 3))
        try:
            feats = item.features
            if self.transform is not None:
                feats = self.transform(feats)
            feats = np.asarray(feats)
            if feats.ndim == 1:
                feats = feats[None, :]
            self.compile_cache.note(mv.shapes, feats.shape, model=entry.name)
            t0 = time.perf_counter()
            out = _host(mv.model.output(feats))
            fwd_ms = (time.perf_counter() - t0) * 1000.0
        except Exception as e:
            body = self._model_error(e)
            pspan.set_attr("error_id", body["error"]["error_id"]).end("error")
            item.finish(500, body)
            return
        finally:
            self.model_registry.release(entry)
        pspan.end()
        self.breaker.record_success()
        self.metrics.incr("predictions_total")
        self.metrics.incr_model("model_predictions_total", entry.name)
        self.metrics.record_batch(1)
        if not item.finish(200, self._body(
                entry, mv, out[0] if item.squeeze else out)):
            self.metrics.incr("abandoned_total")
        self._offer_shadow(entry, feats, out, fwd_ms)

    def _process_batch(self, items: List[_WorkItem]) -> None:
        """One coalesced batch: drop the dead, send the oversized alone,
        transform per request, then one padded forward per tenant and
        width chunk."""
        now = time.monotonic()
        ready = []
        for item in items:
            entry = item.entry or self.model_registry.entry()
            with item.lock:
                if item.cancelled:
                    continue
                item.started = True
            if item.queue_span is not None:
                item.queue_span.end()
            item.assembly_span = self.tracer.start_span(
                "serving.batch_assembly", parent=item.span,
                attrs={"batch_items": len(items)})
            self.metrics.record_queue_delay(now - item.enqueued_at)
            if self._expired(item, entry, batched=True):
                continue
            if item.rows > self._ladder_for(entry).max:
                self.metrics.incr("solo_fallback_total")
                item.assembly_span.set_attr("outcome", "solo_fallback").end()
                self._process(item)
                continue
            try:
                feats = item.features
                if self.transform is not None:
                    feats = self.transform(feats)
                feats = np.asarray(feats)
                if feats.ndim == 1:
                    feats = feats[None, :]
            except Exception as e:
                # a bad transform poisons only its own request
                body = self._model_error(e)
                item.assembly_span.set_attr(
                    "error_id", body["error"]["error_id"]).end("error")
                item.finish(500, body)
                continue
            ready.append((item, feats))
        # only one tenant's same-width, same-dtype rows share a forward
        groups: dict = {}
        for item, feats in ready:
            entry = item.entry or self.model_registry.entry()
            key = (entry.name, feats.shape[1:], feats.dtype.str)
            groups.setdefault(key, (entry, []))[1].append((item, feats))
        for entry, pairs in groups.values():
            ladder = self._ladder_for(entry)
            for chunk in fill_chunks(pairs, ladder.max):
                self._predict_chunk(entry, ladder, chunk)

    def _predict_chunk(self, entry: ModelEntry, ladder: BucketLadder,
                       chunk) -> None:
        """ONE padded forward for a chunk of one tenant's (item,
        features) pairs, sliced back out and completed per request."""
        for item, _ in chunk:
            if item.assembly_span is not None:
                item.assembly_span.end()
        if not self.breaker.try_acquire():
            body, headers = self._circuit_open(len(chunk))
            for item, _ in chunk:
                item.finish(503, body, headers)
            return
        n_valid = sum(int(f.shape[0]) for _, f in chunk)
        bucket = ladder.bucket_for(n_valid)
        pagein_ms = self.model_registry.touch(entry)
        mv = entry.current  # the version this chunk runs on
        pspans = [self.tracer.start_span(
            "serving.predict", parent=item.span,
            attrs={"mode": "batched", "bucket": bucket, "n_valid": n_valid,
                   "chunk_size": len(chunk), "model": entry.name,
                   "model_version": mv.version})
            for item, _ in chunk]
        if pagein_ms is not None:
            pspans[0].set_attr("weight_pagein_ms", round(pagein_ms, 3))
        try:
            stacked = (chunk[0][1] if len(chunk) == 1 else
                       np.concatenate([f for _, f in chunk], axis=0))
            padded = pad_rows(stacked, bucket)
            self.compile_cache.note(mv.shapes, padded.shape,
                                    model=entry.name)
            t0 = time.perf_counter()
            out = self._padded_forward(mv.model, padded, n_valid)
            fwd_ms = (time.perf_counter() - t0) * 1000.0
        except Exception as e:
            body = self._model_error(e, len(chunk))
            for sp in pspans:
                sp.end("error")
            for item, _ in chunk:
                item.finish(500, body)
            return
        finally:
            self.model_registry.release(entry)
        for sp in pspans:
            sp.end()
        self.breaker.record_success()
        self._publish_bucket_cost(entry.name, bucket, fwd_ms)
        self.metrics.record_batch(len(chunk), n_valid, entry.name)
        self.metrics.incr("batched_predictions_total", len(chunk))
        self.metrics.incr("predictions_total", len(chunk))
        self.metrics.incr_model("model_predictions_total", entry.name,
                                len(chunk))
        off = 0
        abandoned = 0
        for item, feats in chunk:
            rows = int(feats.shape[0])
            o = out[off:off + rows]
            off += rows
            if not item.finish(200, self._body(
                    entry, mv, o[0] if item.squeeze else o)):
                abandoned += 1
        if abandoned:
            self.metrics.incr("abandoned_total", abandoned)
        self._offer_shadow(entry, stacked, out[:n_valid], fwd_ms)

    def _publish_bucket_cost(self, name: str, bucket: int,
                             fwd_ms: float) -> None:
        """Bucket-labelled FLOP/s, bytes/s, MFU and roofline class from
        the warm-up's cost model: a lookup and a division."""
        cm = self._bucket_costs.get((name, bucket))
        if cm is None:
            return
        got = cm.achieved(fwd_ms / 1e3, self._peak_flops)
        label = str(bucket)
        self._g_bucket_fps.labels(label).set(got["flops_per_sec"])
        self._g_bucket_bps.labels(label).set(got["bytes_per_sec"])
        if got["mfu"] is not None:
            self._g_bucket_mfu.labels(label).set(got["mfu"])
        self._g_bucket_roofline.labels(label).set(
            cm.roofline_class(self._peak_flops, self._peak_bw))

    def _padded_forward(self, model, padded, n_valid: int) -> np.ndarray:
        """The engine's ``output_padded`` on a bucket-padded batch: the
        first ``n_valid`` rows of the first output, on the host."""
        return _host(model.output_padded(padded, n_valid=n_valid))

    def _warm_model(self, model, shapes, ladder=None, name=None) -> int:
        """Run every ladder bucket through the padded forward before the
        model takes traffic; returns the forwards run (0 when batching
        is off or the input width is unknown)."""
        if self.batcher is None:
            return 0
        if ladder is None:
            ladder = self.batcher.ladder
        feats = self._canary_features(model)
        if feats is None:
            logger.info("bucket warm-up skipped: the model declares no "
                        "input width and no canary= was given")
            return 0
        if self.transform is not None:
            feats = self.transform(feats)
        feats = np.asarray(feats)
        if feats.ndim == 1:
            feats = feats[None, :]
        for b in ladder.buckets:
            padded = pad_rows(feats[:b], b)
            self.compile_cache.note(shapes, padded.shape, model=name)
            out = self._padded_forward(model, padded, padded.shape[0])
            if not np.all(np.isfinite(out)):
                raise ValueError(f"warm-up of bucket {b} produced "
                                 "non-finite output")
            self.metrics.incr("warmup_predicts_total")
            try:  # accounting only: a model without a cost model is fine
                self._bucket_costs[(name, b)] = profiler.output_cost_model(
                    model, padded.shape, str(padded.dtype))
            except Exception:
                logger.debug("no cost model for bucket %d", b, exc_info=True)
                self._bucket_costs[(name, b)] = None
        shapes.mark_warmed()
        return len(ladder.buckets)

    def _install_aot(self, model, shapes, info) -> int:
        """Install the serving bundle of a manager-sourced checkpoint
        (the kernel library into the cache directory, the buckets'
        shapes into ``shapes``). Returns the buckets installed; 0 when
        AOT is off or there is no bundle. A stale or corrupt artifact is
        counted (``aot_fallback_total``) and skipped."""
        if (not self.aot or info is None or self.checkpoint_manager is None
                or getattr(model, "aot_install_output", None) is None):
            return 0
        from deeplearning4j_tpu_torch.compile.aot import (
            install_serving_bundle,
        )

        blobs = self.checkpoint_manager.load_artifacts(info)
        if not blobs:
            return 0
        installed = install_serving_bundle(model, blobs,
                                           registry=self.metrics.registry)
        if installed and shapes is not None:
            # the shape record tracks the single feature array's shape:
            # unwrap the graph engine's nested 1-tuple keys
            shapes.preload([k[0] if k and isinstance(k[0], tuple) else k
                            for k in installed])
            logger.info("installed %d AOT bucket(s) from checkpoint step "
                        "%s", len(installed), info.step)
        return len(installed)

    def _canary_features(self, model):
        if self.canary is not None:
            return np.asarray(self.canary, np.float32)
        n_in = feature_dim(model)
        if n_in is None:
            return None
        return np.zeros((1, n_in), np.float32)

    def retry_after_value(self) -> float:
        """How long a shed client should wait: queue depth over the
        observed drain rate, clamped to [``RETRY_AFTER_MIN``,
        min(``RETRY_AFTER_MAX``, ``retry_after``)]; before two
        completions exist, that upper bound."""
        cap = max(min(RETRY_AFTER_MAX, self.retry_after), RETRY_AFTER_MIN)
        rate = self.metrics.drain_rate()
        if rate is None or rate <= 0:
            return cap
        return min(cap, max(RETRY_AFTER_MIN, self._queue.qsize() / rate))

    def _retry_after_header(self) -> str:
        # HTTP Retry-After is whole seconds: round up, so the header
        # never understates the body's ``retry_after``
        return str(max(1, int(math.ceil(self.retry_after_value()))))

    # -- admission (handler threads) ------------------------------------

    def _shed(self, status: str, message: str, **extra):
        return 503, error_envelope(
            status, 503, message,
            retry_after=round(self.retry_after_value(), 3), **extra,
        ), {"Retry-After": self._retry_after_header()}

    def submit(self, features, model: Optional[str] = None):
        """Admit one predict for tenant ``model`` (None: the default)
        and wait for it under the request deadline. Returns ``(status,
        body, headers)``. One ``serving.request`` root span brackets it;
        the admission decision, the queue wait, the batch assembly and
        the predict are its children."""
        try:
            entry = self.model_registry.entry(model)
        except KeyError:
            self.metrics.incr("client_error_total")
            return 404, error_envelope(
                "model_not_found", 404, f"no model named {model!r}",
                models=self.model_registry.names()), {}
        started = time.monotonic()
        shape = np.shape(features)
        root = self.tracer.start_span("serving.request", attrs={
            "rows": int(shape[0]) if len(shape) >= 2 else 1,
            "model": entry.name})
        adm = self.tracer.start_span("serving.admission", parent=root)
        self.metrics.incr_model("model_requests_total", entry.name)
        if self._draining:
            self.metrics.incr("shed_total")
            self.metrics.incr_model("model_shed_total", entry.name)
            adm.set_attr("outcome", "draining").end("shed")
            root.set_attr("status_code", 503).end("shed")
            return self._shed("draining", "server is draining; not admitting")
        if self.breaker.state == OPEN:
            # fail fast at admission: no queue slot for a doomed call
            adm.set_attr("outcome", "circuit_open").end("shed")
            root.set_attr("status_code", 503).end("shed")
            return (503, *self._circuit_open())
        # the tenant's quota first: a tenant over its quota sheds
        # against its own bound, never its neighbours' global slots
        if not entry.admit():
            self.metrics.incr("shed_total")
            self.metrics.incr("quota_rejected_total")
            self.metrics.incr_model("model_shed_total", entry.name)
            adm.set_attr("outcome", "tenant_quota").end("shed")
            root.set_attr("status_code", 503).end("shed")
            return self._shed("tenant_quota", "model admission quota "
                              "exceeded", model=entry.name,
                              quota=entry.quota)
        if not self.metrics.try_enter(self.workers + self.queue_depth):
            entry.exit_admission()
            self.metrics.incr("shed_total")
            self.metrics.incr_model("model_shed_total", entry.name)
            adm.set_attr("outcome", "shed").end("shed")
            root.set_attr("status_code", 503).end("shed")
            return self._shed("shed", "worker pool and queue are full")
        adm.set_attr("outcome", "admitted").end()
        deadline = (entry.deadline if entry.deadline is not None
                    else self.deadline)
        item = _WorkItem(features, Deadline.after(deadline), entry)
        item.span = root
        item.queue_span = self.tracer.start_span("serving.queue",
                                                 parent=root)
        try:
            try:
                self._queue.put_nowait(item)
            except queue.Full:  # unreachable: sized to the bound
                self.metrics.incr("shed_total")
                self.metrics.incr_model("model_shed_total", entry.name)
                item.queue_span.end("shed")
                root.set_attr("status_code", 503).end("shed")
                return self._shed("shed", "worker pool and queue are full")
            remaining = item.deadline.remaining()
            if not item.done.wait(None if remaining is None
                                  else max(remaining, 0.0)):
                with item.lock:
                    item.timed_out = True
                    if not item.started:
                        item.cancelled = True
                        item.queue_span.end("timeout")
                self.metrics.incr("deadline_timeout_total")
                self.metrics.incr_model("model_deadline_timeout_total",
                                        entry.name)
                root.set_attr("status_code", 504).end("timeout")
                return 504, deadline_envelope(item.deadline), {}
            code = item.response[0]
            root.set_attr("status_code", code).end(
                "ok" if code < 400 else "error")
            return item.response
        finally:
            entry.exit_admission()
            self.metrics.exit()
            now = time.monotonic()
            self.metrics.note_completion(now)
            self.metrics.record_model_latency(entry.name, now - started)

    # -- hot reload -----------------------------------------------------

    def reload(self, spec: Optional[dict] = None):
        """Restore a new version (off the drain pool), canary-check it
        through the padded path, warm it, and swap it in. ``spec`` may
        name a tenant (``{"model": name}``) and a source (``{"path":
        ...}``, ``{"key": ...}``, ``{"step": N}``; default: the
        manager's latest step, or the tenant's registration path). The
        step already serving is a counted no-op
        (``reload_skipped_total``) unless ``{"force": true}``. A failure
        keeps the tenant's current version serving and touches no other
        tenant. Returns ``(status, body)``."""
        spec = dict(spec or {})
        name = spec.pop("model", None)
        force = bool(spec.pop("force", False))
        try:
            entry = self.model_registry.entry(name)
        except KeyError:
            return 404, error_envelope(
                "model_not_found", 404, f"no model named {name!r}",
                models=self.model_registry.names())
        if not self._reload_lock.acquire(blocking=False):
            return 409, error_envelope("reload_in_progress", 409,
                                       "another reload is already running")
        try:
            if not force:
                target = self._reload_target_step(spec, entry)
                if target is not None and target == self._watched_step:
                    self.metrics.incr("reload_skipped_total")
                    body = {"status": "skipped", "step": int(target),
                            "version": entry.current.version,
                            "reason": "already serving this checkpoint "
                                      "step"}
                    if name is not None:
                        body["name"] = entry.name
                    return 200, body
            self._reloading = True  # /readyz flips for the duration
            t0 = time.perf_counter()
            try:
                model, source, info = self._load_for_reload(spec, entry)
                self._check_model(model)
                shapes = self.compile_cache.register()
                n_aot = self._install_aot(model, shapes, info)
                self._canary_check(model, self._ladder_for(entry))
                self._warm_model(model, shapes, self._ladder_for(entry),
                                 name=entry.name)
            except _NoReloadSource as e:
                return 400, error_envelope("no_reload_source", 400, str(e))
            except Exception as e:
                eid = error_id_for(e)
                logger.error("reload failed (error_id=%s)", eid,
                             exc_info=True)
                self.metrics.incr("reload_failure_total")
                return 503, error_envelope(
                    "reload_failed", 503, "model reload failed; previous "
                    "version still serving", error_id=eid)
            with self._model_lock:
                version = entry.current.version + 1
                self.model_registry.swap(
                    entry, ModelVersion(model, version, source, shapes))
            self._aot_buckets = n_aot
            if info is not None:  # manager-sourced: this step serves now
                self._watched_step = info.step
                self._last_restore_info = info
            self.metrics.incr("reload_total")
            body = {"status": "reloaded", "version": version,
                    "model": type(model).__name__, "source": source,
                    "reload_ms": (time.perf_counter() - t0) * 1000.0}
            if name is not None:
                body["name"] = entry.name
            if n_aot:
                body["aot_buckets"] = n_aot
            return 200, body
        finally:
            self._reloading = False
            self._reload_lock.release()

    def _reload_target_step(self, spec: dict,
                            entry: ModelEntry) -> Optional[int]:
        """The checkpoint step ``spec`` would load, resolved without
        restoring; None when the source is not a manager step."""
        if "path" in spec or "key" in spec:
            return None
        if (entry.name != self.model_registry.default_name
                or self.checkpoint_manager is None):
            return None
        if "step" in spec:
            try:
                return int(spec["step"])
            except (TypeError, ValueError):
                return None
        return self.checkpoint_manager.latest_step()

    def _load_for_reload(self, spec: dict, entry: ModelEntry):
        """(model, source, checkpoint info or None). The manager and the
        constructor's path back the default tenant only; a named tenant
        reloads from an explicit spec or its registration path."""
        if "step" in spec:
            if self.checkpoint_manager is None:
                raise _NoReloadSource("reload by step requires the "
                                      "server's checkpoint_manager=")
            step = int(spec["step"])
            info = next((i for i in self.checkpoint_manager.available()
                         if i.step == step), None)
            if info is None:
                raise _NoReloadSource(f"no checkpoint at step {step} in "
                                      "the store")
            model = self.checkpoint_manager.restore(
                info, load_updater=False, device=self.device)
            return model, f"checkpoint-step-{step}", info
        if "path" in spec:
            return self._restore(spec["path"]), str(spec["path"]), None
        if "key" in spec:
            if self.store is None:
                raise _NoReloadSource("reload by key requires the "
                                      "server's store=")
            return (self._restore(self.store.read(spec["key"])),
                    str(spec["key"]), None)
        is_default = entry.name == self.model_registry.default_name
        if is_default and self.checkpoint_manager is not None:
            model, info = self.checkpoint_manager.restore_latest(
                load_updater=False, device=self.device)
            return model, f"checkpoint-step-{info.step}", info
        source_path = entry.source_path or (self._source_path if is_default
                                            else None)
        if source_path is not None:
            return self._restore(source_path), source_path, None
        raise _NoReloadSource(
            'no reload source: pass {"path": ...} / {"key": ...} or '
            "construct the server with checkpoint_manager=")

    def _canary_check(self, model, ladder=None) -> None:
        """One predict on the candidate before it takes traffic, through
        the padded path traffic uses (the smallest bucket of the
        tenant's ladder that fits)."""
        feats = self._canary_features(model)
        if feats is None:
            return  # shape unknown and no canary given
        if self.transform is not None:
            feats = self.transform(feats)
        feats = np.asarray(feats)
        if feats.ndim == 1:
            feats = feats[None, :]
        rows = int(feats.shape[0])
        if self.batcher is not None:
            bucket = (ladder or self.batcher.ladder).bucket_for(rows)
            out = self._padded_forward(
                model, pad_rows(feats, bucket) if bucket else feats, rows)
        else:
            out = _host(model.output(feats))
        if not np.all(np.isfinite(out)):
            raise ValueError("canary predict produced non-finite output")

    # -- checkpoint watching --------------------------------------------

    def check_for_update(self) -> bool:
        """One poll of the checkpoint manager: reload iff a step newer
        than the one serving exists. True on a swap."""
        if self.checkpoint_manager is None:
            return False
        step = self.checkpoint_manager.last_step()
        if step is None or step == self._watched_step:
            return False
        code, _ = self.reload({})
        if code == 200:
            self._watched_step = step
            return True
        return False

    def watch(self, interval: float = 1.0) -> "ModelServer":
        """Poll the checkpoint manager every ``interval`` seconds on a
        daemon thread and hot-swap when a new version lands."""
        if self.checkpoint_manager is None:
            raise ValueError("watch() requires checkpoint_manager=")
        if self._watch_thread is not None:
            return self
        self._watch_stop.clear()

        def _loop():
            while not self._watch_stop.wait(interval):
                try:
                    self.check_for_update()
                except Exception:
                    logger.exception("checkpoint watch poll failed")

        self._watch_thread = threading.Thread(
            target=_loop, daemon=True, name="dl4j-serve-watch")
        self._watch_thread.start()
        return self

    def stop_watch(self) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5)
            self._watch_thread = None

    # -- health / metrics -----------------------------------------------

    def health(self) -> dict:
        out = {"status": "ok", "model": type(self._active.model).__name__,
               "version": self._active.version, "device": str(self.device)}
        if len(self.model_registry) > 1:
            out["models"] = self.model_registry.names()
        return out

    def models_snapshot(self) -> dict:
        """``GET /models``: per-tenant registry and paging states, with
        each tenant's counters and latency merged in."""
        stats = self.model_registry.stats()
        per_model = self.metrics.model_snapshot()
        for name, block in stats["models"].items():
            if name in per_model:
                block["metrics"] = per_model[name]
        stats["default"] = self.model_registry.default_name
        return stats

    def readiness(self):
        reasons = []
        if self._draining:
            reasons.append("draining")
        if self._reloading:
            reasons.append("reloading")
        if self.breaker.state == OPEN:
            reasons.append("breaker_open")
        if self._queue.qsize() >= self.queue_high_water:
            reasons.append("queue_high_water")
        if reasons:
            return 503, {"status": "unready", "reasons": reasons}
        return 200, {"status": "ready", "version": self._active.version}

    def metrics_snapshot(self) -> dict:
        from deeplearning4j_tpu_torch.compile.persistent import cache_stats

        out = self.metrics.snapshot()
        out["queue_depth"] = self._queue.qsize()
        out["queue_capacity"] = self.queue_depth
        out["workers"] = self.workers
        out["breaker"] = self.breaker.snapshot()
        out["model_version"] = self._active.version
        out["draining"] = self._draining
        out["device"] = str(self.device)
        out["retry_after"] = round(self.retry_after_value(), 3)
        out["paging"] = self.model_registry.stats()
        out["batching"] = ({
            "enabled": True,
            "max_batch_size": self.batcher.ladder.max,
            "batch_timeout_ms": self.batcher.batch_timeout_ms,
            "buckets": list(self.batcher.ladder.buckets),
            "batch_workers": self.batch_workers,
            "warmed": bool(self._active.shapes.warmed),
        } if self.batcher is not None else {"enabled": False})
        out["compile"] = {"persistent_cache_dir": self.compile_cache_dir,
                          "aot_enabled": self.aot,
                          "aot_buckets_installed": self._aot_buckets,
                          **cache_stats()}
        return out

    def prometheus_metrics(self) -> str:
        """The server's registry in the Prometheus text format (``GET
        /metrics?format=prometheus``), with the queue depth, the model
        version and the breaker state set at scrape time."""
        reg = self.metrics.registry
        reg.gauge("queue_depth",
                  help="requests waiting in the bounded queue").set(
            self._queue.qsize())
        reg.gauge("model_version",
                  help="active model version (bumps on reload)").set(
            self._active.version)
        reg.gauge("breaker_state",
                  help="predict breaker: 0 closed, 1 open, 2 half-open").set(
            {"closed": 0, "open": 1, "half_open": 2}[self.breaker.state])
        return prometheus_text(reg)

    def debug_snapshot(self) -> dict:
        """``GET /debugz``: one bounded JSON page: versions, config,
        per-model state, the buckets' cost models and the flight
        recorder's tail."""
        from deeplearning4j_tpu_torch import __version__ as pkg_version

        out: dict = {
            "versions": {"deeplearning4j_tpu_torch": pkg_version,
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda},
            "backend": str(self.device),
            "config": {
                "host": self._httpd.server_address[0],
                "port": self.port, "workers": self.workers,
                "queue_depth": self.queue_depth, "aot_enabled": self.aot,
                "compile_cache_dir": self.compile_cache_dir,
                "batching": self.batcher is not None,
            },
            "models": self.models_snapshot(),
            "metrics": self.metrics_snapshot(),
            "roofline": {
                "peak_flops": self._peak_flops,
                "peak_bytes_per_sec": self._peak_bw,
                "bucket_cost_models": {
                    f"{name}:{bucket}": {
                        "key": cm.key, "flops": cm.flops,
                        "bytes_accessed": cm.bytes_accessed,
                        "arithmetic_intensity": round(
                            cm.arithmetic_intensity, 3)}
                    for (name, bucket), cm in sorted(
                        self._bucket_costs.items(), key=lambda kv: (
                            str(kv[0][0]), kv[0][1]))
                    if cm is not None},
            },
        }
        prof = profiler.get_active_profiler()
        if prof is not None:
            out["profiler"] = prof.snapshot()
        rec = flightrec.get_flight_recorder()
        if rec is not None:
            out["flight_recorder"] = {
                "capacity": rec.capacity,
                "tail": flightrec._jsonable(
                    rec.tail(flightrec.DEBUG_TAIL_LIMIT))}
        return out

    # -- request validation ---------------------------------------------

    def parse_predict(self, data: bytes):
        """Body bytes -> ``(model name or None, float32 features)``, or
        ``HttpBodyError``: 400 for a malformed payload, 404 for an
        unknown ``"model"``, 422 for well-formed but shape-invalid
        features (width checked against the target tenant)."""
        try:
            payload = json.loads(data)
        except (ValueError, UnicodeDecodeError) as e:
            raise HttpBodyError(400, error_envelope(
                "malformed_json", 400, f"body is not valid JSON: {e}",
            )) from None
        if not isinstance(payload, dict) or "features" not in payload:
            raise HttpBodyError(400, error_envelope(
                "bad_request", 400,
                'body must be a JSON object with a "features" key'))
        name = payload.get("model")
        if name is not None and not isinstance(name, str):
            raise HttpBodyError(400, error_envelope(
                "bad_request", 400, '"model" must be a string when present'))
        try:
            entry = self.model_registry.entry(name)
        except KeyError:
            raise HttpBodyError(404, error_envelope(
                "model_not_found", 404, f"no model named {name!r}",
                models=self.model_registry.names())) from None
        try:
            feats = np.asarray(payload["features"], np.float32)
        except (ValueError, TypeError):
            raise HttpBodyError(422, error_envelope(
                "invalid_features", 422, "features are not a numeric array",
                expected="numeric array [n, d]",
                got=type(payload["features"]).__name__)) from None
        if feats.ndim not in (1, 2) or feats.size == 0:
            raise HttpBodyError(422, error_envelope(
                "invalid_features", 422,
                "features must be a non-empty 1-d or 2-d array",
                expected="[n, d]", got=list(feats.shape)))
        n_in = feature_dim(entry.current.model)
        if n_in is not None and feats.shape[-1] != n_in:
            raise HttpBodyError(422, error_envelope(
                "invalid_features", 422,
                "feature width does not match the model input",
                expected=[int(feats.shape[0]) if feats.ndim == 2 else 1,
                          n_in],
                got=list(feats.shape)))
        return name, feats


def _make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        # one buffered write per response (flushed after the handler
        # returns) and TCP_NODELAY: headers and body written separately
        # under Nagle's algorithm wait on the client's delayed ACK
        wbufsize = -1
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def _json(self, obj, code: int = 200, headers=None):
            body = json.dumps(obj).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                pass  # client went away; nothing to tell it

        def _text(self, text: str, content_type: str):
            data = text.encode("utf-8")
            try:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except OSError:
                pass

        def do_GET(self):
            server.metrics.incr("requests_total")
            route, fmt = parse_format_query(self.path)
            if route == "/healthz":
                self._json(server.health())
            elif route == "/readyz":
                code, body = server.readiness()
                self._json(body, code)
            elif route == "/metrics":
                if fmt == "prometheus":
                    self._text(server.prometheus_metrics(),
                               PROMETHEUS_CONTENT_TYPE)
                else:  # JSON stays the default
                    self._json(server.metrics_snapshot())
            elif route == "/models":
                self._json(server.models_snapshot())
            elif route == "/debugz":
                try:
                    self._json(server.debug_snapshot())
                except Exception as e:
                    eid = error_id_for(e)
                    logger.error("debugz failed (error_id=%s)", eid,
                                 exc_info=True)
                    self._json(error_envelope(
                        "debug_error", 500, "debug snapshot failed; see "
                        "server log", error_id=eid), 500)
            else:
                self._json(error_envelope("not_found", 404, "not found"),
                           404)

        def do_POST(self):
            server.metrics.incr("requests_total")
            if self.path == "/predict":
                started = time.monotonic()
                try:
                    name, feats = server.parse_predict(
                        read_request_body(self, MAX_BODY))
                except HttpBodyError as e:
                    server.metrics.incr("client_error_total")
                    self._json(e.envelope, e.code)
                    return
                code, body, headers = server.submit(feats, model=name)
                server.metrics.record_latency(time.monotonic() - started)
                self._json(body, code, headers)
            elif self.path == "/admin/reload":
                try:
                    data = read_request_body(self, MAX_BODY)
                except HttpBodyError as e:
                    server.metrics.incr("client_error_total")
                    self._json(e.envelope, e.code)
                    return
                try:
                    spec = json.loads(data) if data.strip() else {}
                    if not isinstance(spec, dict):
                        raise ValueError("spec must be a JSON object")
                except ValueError as e:
                    server.metrics.incr("client_error_total")
                    self._json(error_envelope(
                        "malformed_json", 400,
                        f"reload spec is not valid JSON: {e}"), 400)
                    return
                code, body = server.reload(spec)
                self._json(body, code)
            else:
                self._json(error_envelope("not_found", 404, "not found"),
                           404)

    return Handler

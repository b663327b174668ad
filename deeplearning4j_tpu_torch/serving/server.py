"""Model serving over HTTP: admission control, deadlines and
micro-batching onto padded row buckets.

Counterpart of ``deeplearning4j_tpu/serving/server.py`` for the
single-model serving path:

- **admission control**: at most ``workers + queue_depth`` requests are
  in the system; the excess is shed at once with ``503`` and a
  ``Retry-After`` header;
- **deadlines**: one ``Deadline`` per request spans queue wait and
  predict; expiry answers ``504`` with elapsed / budget;
- **micro-batching**: the drain thread coalesces queued requests (up to
  ``max_batch_size`` rows or ``batch_timeout_ms``) into one forward on a
  zero-padded bucket shape through ``output_padded``, and slices each
  request's rows back out; a request wider than the largest bucket runs
  alone. Every bucket runs once at ``start()`` (eager warm-up), so the
  kernels are built and the device is warm before the first request;
- **readiness vs liveness**: ``/healthz`` is up while serving,
  ``/readyz`` flips while draining or above the queue high-water mark;
- **graceful drain**: ``stop(drain_timeout=)`` stops admitting, lets
  in-flight work finish, then closes.

Error responses use the shared envelope (``envelope.py``): ``400``
malformed payload, ``411`` / ``413`` body framing, ``422``
shape-invalid features, ``500`` model fault with an opaque
``error_id``, ``503`` shed or draining, ``504`` deadline.

The model runs on the server's ``device`` (default ``"cuda"``; raises
without a card unless ``device="cpu"``): the drain thread launches the
kernels on PyTorch's current stream of that thread. Hot reload,
multi-tenancy, the circuit breaker, AOT bundles, shadow scoring and
preemption handling come in later slices.

Input width: the JAX server validates against the first layer's
``n_in``, which for a ``convolutional_flat`` model such as LeNet is the
channel count (1), so it refuses LeNet's 784-wide rows. The port
validates against the configuration's flat input size when its input
type is flat rows (``feedforward`` / ``convolutionalFlat``).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.dispatch import resolve_device
from deeplearning4j_tpu_torch.resilience.deadline import Deadline
from deeplearning4j_tpu_torch.serving.batcher import (
    BucketLadder,
    MicroBatcher,
    fill_chunks,
    pad_rows,
)
from deeplearning4j_tpu_torch.serving.envelope import (
    HttpBodyError,
    deadline_envelope,
    error_envelope,
    error_id_for,
    read_request_body,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics

logger = logging.getLogger(__name__)

MAX_BODY = 64 * 1024 * 1024
# seconds a shed client is told to wait (503 ``Retry-After``)
RETRY_AFTER_S = 1


def _feature_dim(model) -> Optional[int]:
    """Width of one request row: the configuration's flat input size
    when the model takes flat rows, else the first layer's ``n_in``."""
    conf = getattr(model, "conf", None)
    if conf is None:
        return None
    it = getattr(conf, "input_type", None)
    if it is not None and it.kind in ("feedforward", "convolutionalFlat"):
        return int(it.flat_size())
    n_in = getattr(conf.layers[0], "n_in", None) if conf.layers else None
    if isinstance(n_in, int) and n_in > 0:
        return n_in
    return None


def _host(out) -> np.ndarray:
    if torch.is_tensor(out):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


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
                 "started", "cancelled", "timed_out", "rows", "squeeze")

    def __init__(self, features: np.ndarray, deadline: Deadline):
        self.features = features
        self.deadline = deadline
        self.done = threading.Event()
        self.response = None  # (code, body_dict, headers_dict)
        self.lock = threading.Lock()
        self.started = False
        self.cancelled = False   # handler gave up before the drain started it
        self.timed_out = False   # handler wrote a 504 already
        self.rows = int(features.shape[0]) if features.ndim >= 2 else 1
        self.squeeze = features.ndim == 1  # 1-d request: 1-d response

    def finish(self, code: int, body: dict, headers=None) -> bool:
        """Record the result; False when the handler already answered
        504 (result abandoned)."""
        with self.lock:
            abandoned = self.timed_out
            self.response = (code, body, headers or {})
        self.done.set()
        return not abandoned


class ModelServer:
    """Serve one model over HTTP.

    Endpoints::

        GET  /healthz   liveness: process up
        GET  /readyz    readiness: routable (flips while draining)
        GET  /metrics   counters, latency quantiles, batch occupancy
        POST /predict   {"features": [[...]] or [...]}

    ``model_or_path`` is a ``MultiLayerNetwork`` on ``device`` or a
    checkpoint zip path (restored onto ``device``). ``deadline``
    (seconds) bounds queue wait + predict per request; None disables.
    ``micro_batch=False`` runs one forward per request on ``workers``
    threads instead of the coalescing drain thread. ``transform`` maps
    each request's features before the forward.
    """

    def __init__(self, model_or_path, host: str = "127.0.0.1",
                 port: int = 0, transform=None, *,
                 workers: int = 4, queue_depth: int = 32,
                 deadline: Optional[float] = None,
                 micro_batch: bool = True,
                 max_batch_size: int = 32,
                 batch_timeout_ms: float = 2.0,
                 bucket_ladder=None,
                 device=None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        self.device = resolve_device(device)
        if isinstance(model_or_path, str):
            from deeplearning4j_tpu_torch.util.model_serializer import (
                restore_multi_layer_network,
            )

            model = restore_multi_layer_network(model_or_path,
                                                device=self.device)
        else:
            model = model_or_path
        if not hasattr(model, "output_padded"):
            raise NotImplementedError(
                f"ModelServer over a {type(model).__name__} is not ported "
                "yet: it serves a MultiLayerNetwork")
        if getattr(model, "device", self.device) != self.device:
            raise ValueError(f"the model lives on {model.device}; this "
                             f"server runs on {self.device}")
        self.model = model
        self.model_version = 1
        self.transform = transform
        self.workers = workers
        self.queue_depth = queue_depth
        self.deadline = deadline
        if micro_batch:
            ladder = (bucket_ladder if isinstance(bucket_ladder, BucketLadder)
                      else BucketLadder(bucket_ladder, max_batch_size))
            self.batcher: Optional[MicroBatcher] = MicroBatcher(
                ladder, batch_timeout_ms)
            # one drain thread: it coalesces, so more would split batches
            self.batch_workers = 1
        else:
            self.batcher = None
            self.batch_workers = workers
        self.metrics = ServingMetrics()
        self._draining = False
        self._stop_workers = False
        self._queue: "queue.Queue[_WorkItem]" = queue.Queue(
            maxsize=queue_depth + workers)
        self._worker_threads: List[threading.Thread] = []
        self._httpd = _ServingHTTPServer((host, port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ModelServer":
        """Warm every bucket (raising if the model cannot run them),
        then start the drain pool and the listener."""
        try:
            self._warm()
        except BaseException:
            self._httpd.server_close()
            raise
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
        self._stop_workers = True
        for t in self._worker_threads:
            t.join(timeout=5)
        if self._thread is not None:  # shutdown() hangs if never served
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()
        return drained

    def _warm(self) -> int:
        """Run every ladder bucket through the padded forward before
        the server takes traffic. Returns the number of forwards."""
        if self.batcher is None:
            return 0
        n_in = _feature_dim(self.model)
        if n_in is None:
            logger.info("bucket warm-up skipped: the model declares no "
                        "input width")
            return 0
        feats = np.zeros((1, n_in), np.float32)
        if self.transform is not None:
            feats = np.asarray(self.transform(feats), np.float32)
        for b in self.batcher.ladder.buckets:
            out = self._padded_forward(pad_rows(feats[:b], b), 1)
            if not np.all(np.isfinite(out)):
                raise ValueError(f"warm-up of bucket {b} produced "
                                 "non-finite output")
            self.metrics.incr("warmup_predicts_total")
        return len(self.batcher.ladder.buckets)

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

    def _claim(self, item: _WorkItem) -> bool:
        """Mark ``item`` started unless its handler gave up; answer 504
        when its deadline ran out in the queue. True when it should run."""
        with item.lock:
            if item.cancelled:
                return False
            item.started = True
        if item.deadline.expired():
            self.metrics.incr("deadline_timeout_total")
            item.finish(504, deadline_envelope(
                item.deadline, "deadline expired while queued"))
            return False
        return True

    def _model_error(self, e: Exception, n: int = 1) -> dict:
        eid = error_id_for(e)
        logger.error("predict failed (error_id=%s)", eid, exc_info=True)
        self.metrics.incr("server_error_total", n)
        return error_envelope("model_error", 500,
                              "prediction failed; see server log",
                              error_id=eid)

    def _body(self, out: np.ndarray) -> dict:
        return {"output": out.tolist(), "model_version": self.model_version}

    def _process(self, item: _WorkItem) -> None:
        """One request alone: micro-batching off, or wider than the
        largest bucket."""
        if not self._claim(item):
            return
        try:
            feats = item.features
            if self.transform is not None:
                feats = self.transform(feats)
            feats = np.asarray(feats, np.float32)
            out = _host(self.model.output(
                feats[None, :] if feats.ndim == 1 else feats))
        except Exception as e:
            item.finish(500, self._model_error(e))
            return
        self.metrics.incr("predictions_total")
        self.metrics.record_batch(1)
        if not item.finish(200, self._body(out[0] if item.squeeze else out)):
            self.metrics.incr("abandoned_total")

    def _process_batch(self, items: List[_WorkItem]) -> None:
        """One coalesced batch: drop the dead, send the oversized alone,
        transform per request, then one padded forward per chunk."""
        ladder = self.batcher.ladder
        ready = []
        for item in items:
            if item.rows > ladder.max:
                self.metrics.incr("solo_fallback_total")
                self._process(item)
                continue
            if not self._claim(item):
                continue
            try:
                feats = item.features
                if self.transform is not None:
                    feats = self.transform(feats)
                feats = np.asarray(feats, np.float32)
                if feats.ndim == 1:
                    feats = feats[None, :]
            except Exception as e:
                # a bad transform poisons only its own request
                item.finish(500, self._model_error(e))
                continue
            ready.append((item, feats))
        groups: dict = {}
        for item, feats in ready:  # only same-width rows share a forward
            groups.setdefault(feats.shape[1:], []).append((item, feats))
        for pairs in groups.values():
            for chunk in fill_chunks(pairs, ladder.max):
                self._predict_chunk(chunk)

    def _predict_chunk(self, chunk) -> None:
        """ONE padded forward for a chunk of (item, features) pairs,
        sliced back out and completed per request."""
        n_valid = sum(int(f.shape[0]) for _, f in chunk)
        bucket = self.batcher.ladder.bucket_for(n_valid)
        try:
            stacked = np.concatenate([f for _, f in chunk], axis=0)
            out = self._padded_forward(pad_rows(stacked, bucket), n_valid)
        except Exception as e:
            body = self._model_error(e, len(chunk))
            for item, _ in chunk:
                item.finish(500, body)
            return
        self.metrics.record_batch(len(chunk))
        self.metrics.incr("predictions_total", len(chunk))
        off = 0
        for item, feats in chunk:
            rows = int(feats.shape[0])
            o = out[off:off + rows]
            off += rows
            if not item.finish(200, self._body(o[0] if item.squeeze else o)):
                self.metrics.incr("abandoned_total")

    def _padded_forward(self, padded: np.ndarray, n_valid: int) -> np.ndarray:
        return _host(self.model.output_padded(padded, n_valid=n_valid))

    # -- admission (handler threads) ------------------------------------

    def _shed(self, status: str, message: str):
        self.metrics.incr("shed_total")
        return 503, error_envelope(status, 503, message,
                                   retry_after=RETRY_AFTER_S), {
            "Retry-After": str(RETRY_AFTER_S)}

    def submit(self, features: np.ndarray):
        """Admit one predict and wait for it under the request deadline.
        Returns ``(status, body, headers)``."""
        if self._draining:
            return self._shed("draining", "server is draining; not admitting")
        if not self.metrics.try_enter(self.workers + self.queue_depth):
            return self._shed("shed", "worker pool and queue are full")
        try:
            item = _WorkItem(features, Deadline.after(self.deadline))
            try:
                self._queue.put_nowait(item)
            except queue.Full:  # unreachable: sized to the bound
                return self._shed("shed", "worker pool and queue are full")
            remaining = item.deadline.remaining()
            if not item.done.wait(None if remaining is None
                                  else max(remaining, 0.0)):
                with item.lock:
                    item.timed_out = True
                    if not item.started:
                        item.cancelled = True
                self.metrics.incr("deadline_timeout_total")
                return 504, deadline_envelope(item.deadline), {}
            return item.response
        finally:
            self.metrics.exit()

    # -- health ---------------------------------------------------------

    def health(self) -> dict:
        return {"status": "ok", "model": type(self.model).__name__,
                "version": self.model_version, "device": str(self.device)}

    def readiness(self):
        reasons = []
        if self._draining:
            reasons.append("draining")
        if self._queue.qsize() >= max(self.queue_depth, 1):
            reasons.append("queue_high_water")
        if reasons:
            return 503, {"status": "unready", "reasons": reasons}
        return 200, {"status": "ready", "version": self.model_version}

    def metrics_snapshot(self) -> dict:
        out = self.metrics.snapshot()
        out["queue_depth"] = self._queue.qsize()
        out["queue_capacity"] = self.queue_depth
        out["workers"] = self.workers
        out["draining"] = self._draining
        out["device"] = str(self.device)
        out["batching"] = ({
            "enabled": True,
            "max_batch_size": self.batcher.ladder.max,
            "batch_timeout_ms": self.batcher.batch_timeout_ms,
            "buckets": list(self.batcher.ladder.buckets),
            "batch_workers": self.batch_workers,
        } if self.batcher is not None else {"enabled": False})
        return out

    # -- request validation ---------------------------------------------

    def parse_predict(self, data: bytes) -> np.ndarray:
        """Body bytes -> float32 features, or ``HttpBodyError``: 400 for
        a malformed payload, 404 for a named model other than the one
        served, 422 for well-formed but shape-invalid features."""
        try:
            payload = json.loads(data)
        except (ValueError, UnicodeDecodeError) as e:
            raise HttpBodyError(400, error_envelope(
                "malformed_json", 400, f"body is not valid JSON: {e}",
            )) from None
        if not isinstance(payload, dict) or "features" not in payload:
            raise HttpBodyError(400, error_envelope(
                "bad_request", 400,
                'body must be a JSON object with a "features" key',
            ))
        name = payload.get("model")
        if name is not None and not isinstance(name, str):
            raise HttpBodyError(400, error_envelope(
                "bad_request", 400, '"model" must be a string when present',
            ))
        if name not in (None, "default"):
            raise HttpBodyError(404, error_envelope(
                "model_not_found", 404, f"no model named {name!r}",
                models=["default"],
            ))
        try:
            feats = np.asarray(payload["features"], np.float32)
        except (ValueError, TypeError):
            raise HttpBodyError(422, error_envelope(
                "invalid_features", 422, "features are not a numeric array",
                expected="numeric array [n, d]",
                got=type(payload["features"]).__name__,
            )) from None
        if feats.ndim not in (1, 2) or feats.size == 0:
            raise HttpBodyError(422, error_envelope(
                "invalid_features", 422,
                "features must be a non-empty 1-d or 2-d array",
                expected="[n, d]", got=list(feats.shape),
            ))
        n_in = _feature_dim(self.model)
        if n_in is not None and feats.shape[-1] != n_in:
            raise HttpBodyError(422, error_envelope(
                "invalid_features", 422,
                "feature width does not match the model input",
                expected=[int(feats.shape[0]) if feats.ndim == 2 else 1,
                          n_in],
                got=list(feats.shape),
            ))
        return feats


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

        def do_GET(self):
            server.metrics.incr("requests_total")
            route = self.path.split("?", 1)[0]
            if route == "/healthz":
                self._json(server.health())
            elif route == "/readyz":
                code, body = server.readiness()
                self._json(body, code)
            elif route == "/metrics":
                self._json(server.metrics_snapshot())
            else:
                self._json(error_envelope("not_found", 404, "not found"),
                           404)

        def do_POST(self):
            server.metrics.incr("requests_total")
            if self.path != "/predict":
                self._json(error_envelope("not_found", 404, "not found"),
                           404)
                return
            started = time.monotonic()
            try:
                feats = server.parse_predict(
                    read_request_body(self, MAX_BODY))
            except HttpBodyError as e:
                server.metrics.incr("client_error_total")
                self._json(e.envelope, e.code)
                return
            code, body, headers = server.submit(feats)
            server.metrics.record_latency(time.monotonic() - started)
            self._json(body, code, headers)

    return Handler

"""Thin HTTP router in front of a fleet of ``ModelServer`` processes.

Copy of ``deeplearning4j_tpu/serving/router.py``: no model code, just
placement and retries, so the same model names and backends pick the
same owners in both packages (the same ``hashlib.sha1`` key).

Routing policy, in order:

- **consistent hash on model id** (rendezvous / highest-random-
  weight hashing): each model name deterministically prefers one
  backend, so a tenant's traffic concentrates where its weights are
  already device-resident and its executables warm — adding or
  removing a backend only remaps the tenants that hashed to it,
  never the whole fleet;
- **health-aware**: a background thread polls every backend's
  ``/readyz``; unready backends drop out of candidate order until
  they recover (a backend that refuses connections is marked
  unhealthy immediately, without waiting for the next poll);
- **least-loaded fallback**: when the hash owner is carrying
  materially more router-side in-flight requests than the least
  loaded healthy backend (> ``spread_after`` extra), the request
  goes to the least loaded one instead — one hot tenant cannot
  starve a backend's other tenants while idle capacity sits nearby;
- **retry-next-on-shed**: a 503 (shed / quota / draining) or a
  connection failure moves to the next candidate; only when every
  healthy backend declined does the client see a 503 — so killing a
  backend mid-load costs zero requests, they finish on the survivors
  (``tests/test_torch_fleet.py`` asserts exactly that).

Predicts are idempotent, which is what makes blind connection-error
retries safe.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch.observability.export import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE,
)
from deeplearning4j_tpu_torch.observability.export import (
    parse_format_query,
    prometheus_text,
)
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.serving.envelope import error_envelope

logger = logging.getLogger(__name__)

MAX_BODY = 64 * 1024 * 1024

# connection-level failures that mean "this backend never processed
# the request" — always safe to retry on the next backend
_RETRIABLE_ERRORS = (ConnectionError, http.client.HTTPException,
                     TimeoutError, OSError)


class _Backend:
    """Router-side view of one serving process."""

    __slots__ = ("host", "port", "healthy", "outstanding", "_lock")

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self.healthy = True  # optimistic until the first poll
        self.outstanding = 0
        self._lock = threading.Lock()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def enter(self) -> None:
        with self._lock:
            self.outstanding += 1

    def exit(self) -> None:
        with self._lock:
            self.outstanding -= 1


def _parse_backend(spec) -> Tuple[str, int]:
    if isinstance(spec, (tuple, list)):
        return str(spec[0]), int(spec[1])
    host, _, port = str(spec).rpartition(":")
    return host or "127.0.0.1", int(port)


class ServingRouter:
    """Spread requests across N backend ``ModelServer`` processes.

    ``backends`` is a list of ``"host:port"`` strings (or
    ``(host, port)`` pairs). The router serves::

        POST /predict   forwarded per the routing policy (module
                        docstring); the backend's response relays
                        verbatim, Retry-After included
        GET  /healthz   router process liveness
        GET  /readyz    200 iff at least one backend is ready
        GET  /metrics   routing counters + per-backend states (JSON
                        default, ?format=prometheus supported)

    ``retries`` bounds how many candidates one request may try
    (default: every backend once). ``spread_after`` is the
    outstanding-requests gap that triggers the least-loaded
    fallback.
    """

    def __init__(self, backends, host: str = "127.0.0.1",
                 port: int = 0, *,
                 health_interval: float = 0.25,
                 health_jitter: float = 0.2,
                 probe_timeout: float = 2.0,
                 request_timeout: float = 30.0,
                 retries: Optional[int] = None,
                 spread_after: int = 8,
                 seed: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        if not backends:
            raise ValueError("router needs at least one backend")
        if not 0.0 <= health_jitter < 1.0:
            raise ValueError("health_jitter must be in [0, 1)")
        self.backends = [_Backend(*_parse_backend(b)) for b in backends]
        self.health_interval = health_interval
        self.health_jitter = health_jitter
        self.probe_timeout = probe_timeout
        # seeded jitter: N routers polling the same backends must not
        # synchronize their /readyz probes into one thundering herd —
        # each waits interval * (1 ± jitter), deterministic per seed
        self._jitter_rng = random.Random(seed)
        self.request_timeout = request_timeout
        self.retries = (retries if retries is not None
                        else len(self.backends))
        self.spread_after = spread_after
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        reg = self.registry
        self._requests_total = reg.counter(
            "router_requests_total",
            help="router: requests accepted for forwarding",
        )._default()
        self._retries_total = reg.counter(
            "router_retries_total",
            help="router: forward attempts after the first "
                 "(shed or backend failure)",
        )._default()
        self._unroutable_total = reg.counter(
            "router_unroutable_total",
            help="router: 503s — every healthy backend declined",
        )._default()
        self._forwarded = reg.counter(
            "router_forwarded_total",
            help="router: responses relayed, by backend",
            labels=("backend",),
        )
        self._healthy_gauge = reg.gauge(
            "router_backend_healthy",
            help="router: backend readiness (1 ready / 0 not)",
            labels=("backend",),
        )
        self._outstanding_gauge = reg.gauge(
            "router_backend_outstanding",
            help="router: in-flight requests per backend",
            labels=("backend",),
        )
        self._httpd = _RouterHTTPServer((host, port),
                                        _make_handler(self))
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ServingRouter":
        self.check_health()  # honest /readyz from the first request
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="dl4j-router-health",
        )
        self._health_thread.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dl4j-router",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2)
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()

    def install_preemption_drain(self, handler=None) -> "ServingRouter":
        """Translate a preemption notice (SIGTERM/SIGINT or a
        simulated one) into this router's shutdown: in-flight
        forwards complete (``_httpd.shutdown`` waits out active
        handlers), then the listener closes. Uses the active
        ``resilience.preemption.PreemptionHandler``, installing a
        default one if none exists."""
        from deeplearning4j_tpu_torch.resilience import preemption

        h = handler if handler is not None else preemption.active_handler()
        if h is None:
            h = preemption.PreemptionHandler().install()
        h.on_preemption(lambda reason: self.stop())
        return self

    # -- health ---------------------------------------------------------

    def _next_interval(self) -> float:
        """Jittered poll interval: ``health_interval * (1 ± jitter)``
        from the seeded RNG, so a fleet of routers decorrelates its
        probe times deterministically."""
        if self.health_jitter <= 0.0:
            return self.health_interval
        spread = self.health_jitter * (2.0 * self._jitter_rng.random()
                                       - 1.0)
        return self.health_interval * (1.0 + spread)

    def _health_loop(self) -> None:
        while not self._stop.wait(self._next_interval()):
            try:
                self.check_health()
            except Exception:
                logger.exception("router health poll failed")

    def check_health(self) -> int:
        """One poll of every backend's ``/readyz``; returns the
        healthy count. A probe timeout — the backend accepted the
        connection but never answered within ``probe_timeout`` — is
        treated exactly like a connection failure: immediately
        unhealthy, no benefit of the doubt until a probe succeeds."""
        n = 0
        for b in self.backends:
            ok = False
            try:
                conn = http.client.HTTPConnection(
                    b.host, b.port, timeout=self.probe_timeout
                )
                try:
                    conn.request("GET", "/readyz")
                    ok = conn.getresponse().status == 200
                finally:
                    conn.close()
            except (OSError, http.client.HTTPException):
                # covers refused connections, socket timeouts
                # (TimeoutError is an OSError), and torn/invalid
                # responses from a wedged backend alike
                ok = False
            b.healthy = ok
            self._healthy_gauge.labels(b.address).set(1 if ok else 0)
            self._outstanding_gauge.labels(b.address).set(
                b.outstanding
            )
            n += ok
        return n

    # -- placement ------------------------------------------------------

    def candidates(self, model: str) -> List[_Backend]:
        """Healthy backends in try-order for ``model``: rendezvous-
        hash order, with the least-loaded backend promoted to the
        front when the hash owner is materially busier."""

        def weight(b: _Backend) -> int:
            h = hashlib.sha1(
                f"{model}|{b.address}".encode()
            ).digest()
            return int.from_bytes(h[:8], "big")

        healthy = [b for b in self.backends if b.healthy]
        if not healthy:
            return []
        order = sorted(healthy, key=weight, reverse=True)
        least = min(healthy, key=lambda b: b.outstanding)
        if (order[0] is not least
                and order[0].outstanding
                - least.outstanding > self.spread_after):
            order.remove(least)
            order.insert(0, least)
        return order

    # -- forwarding -----------------------------------------------------

    def forward(self, body: bytes
                ) -> "tuple[int, bytes, dict]":
        """Route one ``/predict`` body: pick candidates by the
        payload's model id, try each in order, relay the first
        non-shed response. Returns ``(status, body_bytes,
        headers)``."""
        model = ""
        try:
            payload = json.loads(body)
            if isinstance(payload, dict):
                model = str(payload.get("model") or "")
        except ValueError:
            pass  # backends own payload validation (400 envelope)
        self._requests_total.inc()
        order = self.candidates(model)
        attempts = 0
        last_shed = None
        for b in order:
            if attempts >= self.retries:
                break
            if attempts:
                self._retries_total.inc()
            attempts += 1
            b.enter()
            try:
                result = self._try_backend(b, body)
            finally:
                b.exit()
            if result is None:  # connection-level failure
                b.healthy = False  # next poll may restore it
                continue
            status, data, headers = result
            if status == 503 and len(order) > 1:
                last_shed = result  # shed here may succeed elsewhere
                continue
            self._forwarded.labels(b.address).inc()
            return result
        if last_shed is not None:
            return last_shed
        self._unroutable_total.inc()
        return 503, json.dumps(error_envelope(
            "no_backend", 503,
            "no healthy backend accepted the request",
            retry_after=1.0,
        )).encode(), {"Content-Type": "application/json",
                      "Retry-After": "1"}

    def _try_backend(self, b: _Backend, body: bytes):
        """One forward attempt; None means the backend never
        processed the request (safe to retry elsewhere)."""
        try:
            conn = http.client.HTTPConnection(
                b.host, b.port, timeout=self.request_timeout
            )
            try:
                conn.request("POST", "/predict", body=body, headers={
                    "Content-Type": "application/json",
                    "Content-Length": str(len(body)),
                })
                resp = conn.getresponse()
                data = resp.read()
                headers = {
                    k: v for k, v in resp.getheaders()
                    if k.lower() in ("content-type", "retry-after")
                }
                return resp.status, data, headers
            finally:
                conn.close()
        except _RETRIABLE_ERRORS:
            logger.warning("backend %s failed mid-request; retrying "
                           "on the next candidate", b.address)
            return None

    # -- introspection --------------------------------------------------

    def ready(self) -> bool:
        return any(b.healthy for b in self.backends)

    def metrics_snapshot(self) -> dict:
        return {
            "router_requests_total": self._requests_total.value,
            "router_retries_total": self._retries_total.value,
            "router_unroutable_total": self._unroutable_total.value,
            "backends": [
                {
                    "address": b.address,
                    "healthy": b.healthy,
                    "outstanding": b.outstanding,
                    "forwarded": self._forwarded.labels(
                        b.address
                    ).value,
                }
                for b in self.backends
            ],
        }

    def prometheus_metrics(self) -> str:
        return prometheus_text(self.registry)


class _RouterHTTPServer(ThreadingHTTPServer):
    # same rationale as the serving tier: bursts beyond the stdlib
    # backlog of 5 must reach the router's policy, not TCP resets
    request_queue_size = 128
    daemon_threads = True


def _make_handler(router: ServingRouter):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code: int, data: bytes, headers=None):
            try:
                self.send_response(code)
                hdrs = {"Content-Type": "application/json"}
                hdrs.update(headers or {})
                hdrs["Content-Length"] = str(len(data))
                for k, v in hdrs.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)
            except OSError:
                pass  # client went away

        def _json(self, obj, code: int = 200):
            self._reply(code, json.dumps(obj).encode())

        def do_GET(self):
            route, fmt = parse_format_query(self.path)
            if route == "/healthz":
                self._json({"status": "ok",
                            "backends": len(router.backends)})
                return
            if route == "/readyz":
                if router.ready():
                    self._json({"status": "ready"})
                else:
                    self._json({"status": "unready",
                                "reasons": ["no_healthy_backend"]},
                               503)
                return
            if route == "/metrics":
                if fmt == "prometheus":
                    data = router.prometheus_metrics().encode()
                    self._reply(200, data, {
                        "Content-Type": PROMETHEUS_CONTENT_TYPE,
                    })
                else:
                    self._json(router.metrics_snapshot())
                return
            self._json(error_envelope("not_found", 404, "not found"),
                       404)

        def do_POST(self):
            if self.path != "/predict":
                self._json(error_envelope("not_found", 404,
                                          "not found"), 404)
                return
            raw = self.headers.get("Content-Length")
            try:
                length = int(raw) if raw is not None else -1
            except ValueError:
                length = -1
            if length < 0:
                self._json(error_envelope(
                    "length_required", 411,
                    "POST requires a Content-Length header",
                ), 411)
                return
            if length > MAX_BODY:
                self._json(error_envelope(
                    "payload_too_large", 413,
                    "request body exceeds the router cap",
                ), 413)
                return
            body = self.rfile.read(length)
            code, data, headers = router.forward(body)
            self._reply(code, data, headers)

    return Handler

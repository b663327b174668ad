"""Shadow scoring: mirror sampled live traffic to a candidate model.

Counterpart of ``deeplearning4j_tpu/loop/shadow.py``.

The serving tier calls ``observe(features, live_output, live_ms)``
after every successful live forward (``ModelServer.set_shadow``). The
scorer — on a seeded Bernoulli sample of those calls — runs the SAME
rows through the candidate model over the SAME padded bucketed path
the live model used, and accumulates:

- **agreement**: fraction of rows whose candidate output matches the
  live output (argmax for 2-d classification outputs, allclose
  otherwise) — the primary promotion gate;
- **latency**: candidate forward ms vs the live forward ms it
  shadowed, so a candidate that is quality-equal but 3x slower is
  gated on the p99 delta;
- **health**: candidate exceptions and non-finite candidate outputs
  (either fails a zero-tolerance gate), plus non-finite LIVE outputs
  (the probation-mode regression signal, see below);
- **samples**: a bounded ring of recently shadowed feature rows — the
  promoter's probation probes replay these against a suspect version.

Candidate outputs are never returned to clients: ``observe`` runs
*after* the live responses complete, never raises, and a candidate
fault only increments ``shadow_error_total``.

The same class runs promotion **probation** in reverse: after a swap,
the *previous* version becomes the shadow of the new live traffic —
continued agreement and finite live outputs are the evidence the
promotion holds; their collapse (e.g. a distribution shift the
candidate cannot handle) triggers auto-rollback.

Latency on the card: a forward returns once its kernels are enqueued,
so both sides time up to their outputs' copy to the host, which waits
for the forward's kernels on the calling thread's stream. The server's
``live_ms`` brackets ``output_padded`` and that copy
(``ModelServer._padded_forward``) and the scorer's candidate ms the
same two (``_forward``): neither is a launch time. The two windows are
not alike, though: the candidate's forward runs just after the
responses are released, while the handler threads parse the next
requests, so its host clock also carries their contention for the
interpreter lock.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.batcher import pad_rows
# the first output as a host array, the same copy the server's live
# side times (on the card it waits for the forward that produced it)
from deeplearning4j_tpu_torch.serving.server import _host

logger = logging.getLogger(__name__)


def _finite(a: np.ndarray) -> bool:
    return bool(np.all(np.isfinite(a)))


def agreement_rows(live: np.ndarray, cand: np.ndarray,
                   tol: float = 1e-4) -> "tuple[int, int]":
    """(agreeing rows, total rows) between two output arrays of equal
    leading dimension: argmax equality for 2-d outputs with >1
    column (classification), elementwise closeness otherwise."""
    live = _host(live) if torch.is_tensor(live) else np.asarray(live)
    cand = _host(cand) if torch.is_tensor(cand) else np.asarray(cand)
    if live.ndim == 1:
        live = live[None, :]
    if cand.ndim == 1:
        cand = cand[None, :]
    rows = int(min(live.shape[0], cand.shape[0]))
    if rows == 0:
        return 0, 0
    live, cand = live[:rows], cand[:rows]
    if live.ndim == 2 and live.shape[1] > 1:
        agree = int(np.sum(
            np.argmax(live, axis=1) == np.argmax(cand, axis=1)
        ))
    else:
        flat_axis = tuple(range(1, live.ndim))
        agree = int(np.sum(np.all(
            np.isclose(live, cand, rtol=tol, atol=tol), axis=flat_axis,
        )))
    return agree, rows


class ShadowScorer:
    """Mirror a sampled fraction of live traffic to ``candidate``.

    ``fraction`` is the Bernoulli mirror probability from a private
    ``random.Random(seed)`` — the same seed mirrors the same requests,
    so chaos runs replay bit-for-bit. ``ladder`` (a serving
    ``BucketLadder``) routes candidate forwards through the same
    padded buckets live traffic uses; without one the candidate runs
    the raw shape.
    """

    def __init__(self, candidate, *, fraction: float = 1.0,
                 seed: int = 0, ladder=None, registry=None,
                 sample_ring: int = 64, tol: float = 1e-4,
                 name: str = "candidate"):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        self.candidate = candidate
        self.fraction = fraction
        self.ladder = ladder
        self.tol = tol
        self.name = name
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # counters kept as plain ints under the lock (exact even with
        # a disabled registry — gates read these, not the exporter)
        self.requests = 0        # observe() calls offered
        self.shadowed = 0        # mirrored to the candidate
        self.rows = 0
        self.agree_rows = 0
        self.errors = 0          # candidate raised or went non-finite
        self.live_nonfinite = 0  # LIVE output non-finite (probation)
        self._cand_ms: list = []
        self._live_ms: list = []
        self._samples: list = []
        self._sample_ring = max(int(sample_ring), 1)
        reg = registry
        if reg is not None:
            self._m_predicts = reg.counter(
                "shadow_predicts_total",
                help="loop: live requests mirrored to the shadow model",
            )._default()
            self._m_errors = reg.counter(
                "shadow_error_total",
                help="loop: shadow forwards that raised or produced "
                     "non-finite output",
            )._default()
            self._m_live_nonfinite = reg.counter(
                "shadow_live_nonfinite_total",
                help="loop: LIVE outputs observed non-finite while "
                     "shadowing (probation regression signal)",
            )._default()
            self._m_agreement = reg.gauge(
                "shadow_agreement",
                help="loop: row agreement between live and shadow "
                     "outputs (argmax / allclose), running fraction",
            )._default()
            self._m_latency = reg.summary(
                "shadow_latency_ms",
                help="loop: shadow-model forward latency",
            )._default()
        else:
            self._m_predicts = self._m_errors = None
            self._m_live_nonfinite = self._m_agreement = None
            self._m_latency = None

    # -- the mirror (called from serving worker threads) ----------------

    def observe(self, features, live_output, live_ms:
                Optional[float] = None) -> None:
        """One successful live forward: maybe mirror it. NEVER raises
        and never touches the live response — a shadow fault is a
        counter, not an error."""
        try:
            self._observe(features, live_output, live_ms)
        except Exception:  # belt and braces: the live path is sacred
            logger.exception("shadow observe failed (ignored)")
            with self._lock:
                self.errors += 1
            if self._m_errors is not None:
                self._m_errors.inc()

    def _observe(self, features, live_output, live_ms) -> None:
        with self._lock:
            self.requests += 1
            mirror = self._rng.random() < self.fraction
        live_out = _host(live_output)
        if not _finite(live_out):
            with self._lock:
                self.live_nonfinite += 1
            if self._m_live_nonfinite is not None:
                self._m_live_nonfinite.inc()
        if not mirror:
            return
        feats = _host(features).astype(np.float32, copy=False)
        if feats.ndim == 1:
            feats = feats[None, :]
        t0 = time.perf_counter()
        try:
            out = self._forward(feats)
        except Exception:
            logger.warning("shadow model %r raised on mirrored "
                           "traffic", self.name, exc_info=True)
            with self._lock:
                self.shadowed += 1
                self.errors += 1
            if self._m_predicts is not None:
                self._m_predicts.inc()
                self._m_errors.inc()
            return
        ms = (time.perf_counter() - t0) * 1000.0
        bad = not _finite(out)
        agree, rows = (0, int(feats.shape[0])) if bad else \
            agreement_rows(live_out, out, self.tol)
        with self._lock:
            self.shadowed += 1
            self.rows += rows
            self.agree_rows += agree
            if bad:
                self.errors += 1
            self._cand_ms.append(ms)
            if live_ms is not None:
                self._live_ms.append(float(live_ms))
            if len(self._cand_ms) > 4096:
                del self._cand_ms[:2048]
                del self._live_ms[:2048]
            for row in feats[:4]:  # bounded ring of live samples
                self._samples.append(np.array(row, np.float32))
            if len(self._samples) > self._sample_ring:
                del self._samples[:len(self._samples)
                                  - self._sample_ring]
            agreement = (self.agree_rows / self.rows
                         if self.rows else None)
        if self._m_predicts is not None:
            self._m_predicts.inc()
            if bad:
                self._m_errors.inc()
            self._m_latency.observe(ms)
            if agreement is not None:
                self._m_agreement.set(agreement)

    def _forward(self, feats: np.ndarray) -> np.ndarray:
        """Candidate forward over the same padded bucketed path live
        traffic uses (``output_padded`` on the bucket that fits), raw
        shape otherwise; the output's copy to the host ends the timed
        region (module docstring)."""
        model = self.candidate
        rows = int(feats.shape[0])
        fn = getattr(model, "output_padded", None)
        bucket = self.ladder.bucket_for(rows) if self.ladder else None
        if fn is not None and bucket is not None:
            out = fn(pad_rows(feats, bucket), n_valid=rows)
        elif fn is not None:
            out = fn(feats, n_valid=rows)
        else:
            out = model.output(feats)
        return _host(out)[:rows]

    def warmup(self, features) -> bool:
        """Compile the candidate's bucket for ``features`` OFF the
        serving worker threads (the promoter calls this at shadow
        install). Returns False when the forward fails — the caller
        treats that like a failed canary."""
        try:
            feats = _host(features).astype(np.float32, copy=False)
            if feats.ndim == 1:
                feats = feats[None, :]
            out = self._forward(feats)
            return _finite(out)
        except Exception:
            logger.warning("shadow warmup failed for %r", self.name,
                           exc_info=True)
            return False

    # -- gate inputs ----------------------------------------------------

    @staticmethod
    def _quantile(values: list, q: float) -> Optional[float]:
        if not values:
            return None
        s = sorted(values)
        return float(s[min(len(s) - 1, int(q * len(s)))])

    def snapshot(self) -> dict:
        """The gate-evaluation view: counts, agreement, p99s."""
        with self._lock:
            cand_p99 = self._quantile(self._cand_ms, 0.99)
            live_p99 = self._quantile(self._live_ms, 0.99)
            return {
                "name": self.name,
                "requests": self.requests,
                "shadowed": self.shadowed,
                "rows": self.rows,
                "agree_rows": self.agree_rows,
                "agreement": (self.agree_rows / self.rows
                              if self.rows else None),
                "errors": self.errors,
                "live_nonfinite": self.live_nonfinite,
                "candidate_p99_ms": cand_p99,
                "live_p99_ms": live_p99,
                "candidate_p50_ms": self._quantile(self._cand_ms, 0.5),
                "live_p50_ms": self._quantile(self._live_ms, 0.5),
                "p99_delta_ms": (
                    cand_p99 - live_p99
                    if cand_p99 is not None and live_p99 is not None
                    else None
                ),
            }

    def samples(self) -> np.ndarray:
        """Recently shadowed live feature rows (the probation probe
        replay set); empty array when nothing was mirrored yet."""
        with self._lock:
            if not self._samples:
                return np.zeros((0, 0), np.float32)
            return np.stack(self._samples)

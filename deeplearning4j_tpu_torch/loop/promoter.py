"""The promoter: candidate → shadowing → canarying → promoted |
rolled_back, crash-safe at every arrow.

Counterpart of ``deeplearning4j_tpu/loop/promoter.py``: the same state
machine, journal writes, gates and reasons, so a scenario journals the
same history in either package.

The promoter polls the checkpoint store for versions newer than what
is serving, and walks each candidate through an explicit state
machine journaled to disk (``journal.py``) *before* every side
effect:

1. **candidate**: a new step appeared. Its checkpoint is CRC-verified
   first — a corrupt candidate is *quarantined* (journaled, skipped
   forever, counted) while the live version keeps serving.
2. **shadowing**: the candidate model is restored onto the server's
   device (its AOT bundle installed: the kernel library and the
   buckets' shape records) and
   installed as the server's shadow: a seeded fraction of live
   traffic mirrors through the same padded bucketed path, results
   never returned to clients (``shadow.py``).
3. gates (``PromotionGates``): once ``min_shadow_requests`` have
   mirrored, the candidate must clear row agreement, shadow error
   count, the p99 latency delta, and the divergence-guard trip budget.
   Failure journals ``rolled_back`` (reason recorded), counts
   ``loop_rejected_total``, and the live version never changed.
4. **canarying**: gates passed; the journal records the intent, THEN
   the existing canary-validated hot reload swaps the candidate in
   (``reload({"step": N})`` — idempotent, so a crash between journal
   and swap rolls *forward* on recovery by just re-issuing it).
5. **promoted (probation)**: the previous ``ModelVersion`` snapshot is
   retained and becomes the shadow of the new live traffic (the same
   scorer, reversed). For ``probation_requests`` observations the new
   version must keep agreeing with its predecessor and producing
   finite outputs, and the server's error rate must stay under the
   gate — a regression triggers **rollback**: the previous snapshot
   (model object, weights on the device, warmed shapes record and all)
   is swapped back atomically. Zero new shapes
   (``xla_compiles_total`` / ``post_warmup_compiles_total`` stay
   flat), zero dropped
   in-flight requests (in-flight work finishes on the version it
   started with — the same invariant hot reload always had).
6. **promoted (final)**: probation passed; the previous snapshot is
   released and the journal seals the promotion.

``recover()`` makes the machine SIGKILL-proof: whatever state the
journal shows, recovery either rolls the half-applied transition
forward (gates had passed → finish the swap) or back (re-enter
shadowing / restore the promoted version), and re-establishes the
serving invariant "the server serves the journal's promoted step (or
newer under evaluation)". ``fail_after_journal`` is the chaos hook:
set it to a state name and the promoter raises ``SimulatedKill``
right after that journal write — the worst instant — which the chaos
storms use to prove convergence.

Weight paging (``serving/registry.py``): the registry's LRU pages out
only a tenant's *current* version, so the snapshot retained for
probation is out of its reach. It can have been paged out before the
promotion (the tenant was cold when the candidate's reload landed);
the promotion then faults it back in (``snapshot_pagein_ms``), so the
probation shadow and a rollback run on device weights, and the
rollback's swap never pays a page-in.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from deeplearning4j_tpu_torch.loop.journal import (
    CANARYING,
    CANDIDATE,
    IDLE,
    PROMOTED,
    PromotionJournal,
    QUARANTINED,
    ROLLED_BACK,
    SHADOWING,
    SimulatedKill,
    state_code,
)
from deeplearning4j_tpu_torch.loop.shadow import ShadowScorer
from deeplearning4j_tpu_torch.serving.registry import fault_in

logger = logging.getLogger(__name__)


@dataclass
class PromotionGates:
    """The configurable promotion/rollback thresholds.

    - ``min_shadow_requests``: mirrored forwards required before the
      shadow gates are judged (and before probation is judged).
    - ``min_agreement``: required live/shadow row agreement.
    - ``max_shadow_errors``: shadow forwards that raised or went
      non-finite; the default 0 means one bad forward kills the
      candidate.
    - ``max_p99_delta_ms``: candidate forward p99 minus live forward
      p99 (None disables the latency gate).
    - ``max_divergence_trips``: divergence-guard trips (skips +
      rollbacks) the training run may have accumulated for the
      candidate to stay eligible (None disables; needs a
      ``trip_source``).
    - ``max_error_rate``: server 5xx per prediction during probation;
      above it the promotion rolls back.
    - ``probation_requests``: shadowed observations the new version
      must survive before the promotion seals.
    - ``probation_min_agreement``: required agreement between the new
      live version and its predecessor during probation (None = same
      as ``min_agreement``). A candidate legitimately *improves* on
      its predecessor, so this is usually looser than the shadow
      gate; its collapse — e.g. under a traffic shift the candidate
      cannot handle — is the regression signal.
    """

    min_shadow_requests: int = 8
    min_agreement: float = 0.98
    max_shadow_errors: int = 0
    max_p99_delta_ms: Optional[float] = None
    max_divergence_trips: Optional[int] = None
    max_error_rate: float = 0.0
    probation_requests: int = 8
    probation_min_agreement: Optional[float] = None
    # a promotion may not seal before BOTH the observation count and
    # this dwell have elapsed — regressions (traffic shifts, slow
    # poisoning) take wall-clock time to manifest, and a fast traffic
    # burst must not close the watch window in milliseconds
    probation_min_seconds: float = 0.0


class Promoter:
    """Drive the promotion state machine for one ``ModelServer``
    (default tenant) against one ``CheckpointManager``.

    ``trip_source`` is an optional callable returning the training
    side's cumulative divergence-guard trip count (gates on the
    delta since the last candidate). ``poll()`` advances the machine
    one turn and returns the journal state; ``run(interval)`` polls
    on a daemon thread with ``stop()`` to cancel.
    """

    def __init__(self, server, manager, journal: PromotionJournal, *,
                 gates: Optional[PromotionGates] = None,
                 shadow_fraction: float = 1.0, seed: int = 0,
                 trip_source: Optional[Callable[[], int]] = None,
                 registry=None):
        self.server = server
        self.manager = manager
        self.journal = journal
        self.gates = gates or PromotionGates()
        self.shadow_fraction = shadow_fraction
        self.seed = seed
        self.trip_source = trip_source
        # retention contract on the promoter's manager instance too
        # (the trainer process guards its own via ContinualTrainer)
        manager.protect = journal.referenced_steps
        self._scorer: Optional[ShadowScorer] = None
        self._prev_snapshot = None     # ModelVersion before the swap
        self._trips_at_candidate = 0
        self._errors_at_promote = 0
        self._predictions_at_promote = 0
        self._promoted_at = 0.0
        # ms the last promotion spent faulting the retained snapshot's
        # weights back onto the device (None: they were resident)
        self.snapshot_pagein_ms: Optional[float] = None
        # ms the last rollback took from uninstalling the shadow to the
        # swapped registry entry
        self.rollback_swap_ms: Optional[float] = None
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # chaos hook: journal state name -> raise SimulatedKill right
        # after that journal write lands on disk
        self.fail_after_journal: Optional[str] = None

        reg = registry if registry is not None \
            else server.metrics.registry
        self.registry = reg
        self._m_promotions = reg.counter(
            "loop_promotions_total",
            help="loop: candidates promoted to serving",
        )._default()
        self._m_rollbacks = reg.counter(
            "loop_rollbacks_total",
            help="loop: promotions rolled back to the previous "
                 "version's snapshot",
        )._default()
        self._m_rejected = reg.counter(
            "loop_rejected_total",
            help="loop: candidates rejected before taking traffic "
                 "(shadow gates or canary)",
        )._default()
        self._m_quarantined = reg.counter(
            "loop_quarantined_total",
            help="loop: candidate checkpoints quarantined (failed "
                 "CRC/zip verification)",
        )._default()
        self._m_recoveries = reg.counter(
            "loop_journal_recoveries_total",
            help="loop: promoter restarts that resumed from the "
                 "journal",
        )._default()
        self._m_state = reg.gauge(
            "loop_state",
            help="loop: promoter state (0 idle, 1 candidate, "
                 "2 shadowing, 3 canarying, 4 promoted, "
                 "5 rolled_back, 6 quarantined)",
        )._default()
        self._m_candidate_step = reg.gauge(
            "loop_candidate_step",
            help="loop: checkpoint step under evaluation",
        )._default()
        self._m_promoted_step = reg.gauge(
            "loop_promoted_step",
            help="loop: last fully promoted checkpoint step",
        )._default()
        self._publish_state(self.journal.read())

    # -- journal plumbing -----------------------------------------------

    def _write(self, state: str, **fields) -> dict:
        doc = self.journal.write(state, **fields)
        self._publish_state(doc)
        if self.fail_after_journal == state:
            raise SimulatedKill(
                f"chaos: killed right after journaling {state!r}"
            )
        return doc

    def _publish_state(self, doc: dict) -> None:
        self._m_state.set(state_code(doc.get("state")))
        if doc.get("candidate_step") is not None:
            self._m_candidate_step.set(doc["candidate_step"])
        if doc.get("promoted_step") is not None:
            self._m_promoted_step.set(doc["promoted_step"])

    @property
    def state(self) -> str:
        return self.journal.state

    # -- one machine turn -----------------------------------------------

    def poll(self) -> str:
        """Advance the state machine one turn. Safe to call from a
        timer thread; every turn is idempotent w.r.t. the journal."""
        with self._lock:
            doc = self.journal.read()
            st = doc.get("state", IDLE)
            if st == SHADOWING:
                self._evaluate_shadow(doc)
            elif st == CANARYING:
                self._do_promote(doc)
            elif st == PROMOTED and doc.get("probation"):
                self._evaluate_probation(doc)
            else:
                self._check_for_candidate(doc)
            return self.journal.state

    # -- candidate discovery --------------------------------------------

    def _live_step(self) -> Optional[int]:
        return self.server._watched_step

    def _check_for_candidate(self, doc: dict) -> None:
        latest = self.manager.latest_step()
        if latest is None:
            return
        live = self._live_step()
        skip = set(self.journal.skip_steps())
        if doc.get("promoted_step") is not None:
            skip.add(doc["promoted_step"])
        if live is not None:
            skip.add(live)
        candidates = [s for s in self.manager.list_steps()
                      if s not in skip
                      and (live is None or s > live)]
        if not candidates:
            return
        step = candidates[-1]  # newest eligible version
        info = next((i for i in self.manager.available()
                     if i.step == step), None)
        if info is None:
            return
        if not self.manager.verify(info):
            # corrupt candidate: quarantine it, keep serving
            logger.warning(
                "candidate step %d failed verification; quarantined "
                "(live version keeps serving)", step,
            )
            self._m_quarantined.inc()
            self._write(QUARANTINED, quarantined_steps=[step],
                        reason=f"step {step} failed CRC/zip "
                               "verification")
            return
        if self.trip_source is not None:
            self._trips_at_candidate = int(self.trip_source())
        try:
            candidate = self.manager.restore(info, load_updater=False,
                                             device=self.server.device)
        except Exception:
            logger.warning("candidate step %d failed to restore; "
                           "quarantined", step, exc_info=True)
            self._m_quarantined.inc()
            self._write(QUARANTINED, quarantined_steps=[step],
                        reason=f"step {step} failed to restore")
            return
        self._install_candidate_aot(candidate, info)
        scorer = ShadowScorer(
            candidate, fraction=self.shadow_fraction,
            seed=self.seed ^ step, ladder=self._ladder(),
            registry=self.registry, name=f"candidate-{step}",
        )
        # run the canary bucket off the worker threads; a candidate
        # that cannot even forward is rejected here
        feats = self._canary(candidate)
        if feats is not None and not scorer.warmup(feats):
            self._m_rejected.inc()
            self._write(ROLLED_BACK, candidate_step=step,
                        rejected_steps=[step],
                        reason="candidate failed shadow warmup")
            return
        self._scorer = scorer
        self.server.set_shadow(scorer)
        self._write(SHADOWING, candidate_step=step,
                    previous_step=live, gates_passed=False,
                    probation=False, reason=None)
        logger.info("shadowing candidate step %d against live step "
                    "%s", step, live)

    def _canary(self, model):
        """The server's canary features for ``model``, through its
        request ``transform`` (a convolutional graph takes images)."""
        feats = self.server._canary_features(model)
        if feats is not None and self.server.transform is not None:
            feats = self.server.transform(feats)
        return feats

    def _install_candidate_aot(self, candidate, info) -> None:
        """Best-effort: install the candidate's bundle (the kernel
        library, the buckets' shape records) so the shadow's forwards
        build nothing; an unusable artifact is counted
        (``aot_fallback_total``) and the shadow runs all the same."""
        if (not getattr(self.server, "aot", False)
                or getattr(candidate, "aot_install_output", None)
                is None):
            return
        try:
            blobs = self.manager.load_artifacts(info)
            if blobs:
                from deeplearning4j_tpu_torch.compile.aot import (
                    install_serving_bundle,
                )

                install_serving_bundle(candidate, blobs,
                                       registry=self.registry)
        except Exception:
            logger.warning("candidate AOT install failed; the shadow "
                           "runs without it", exc_info=True)

    def _ladder(self):
        batcher = getattr(self.server, "batcher", None)
        return batcher.ladder if batcher is not None else None

    # -- shadow gates ---------------------------------------------------

    def _gate_failures(self, snap: dict) -> "list[str]":
        g = self.gates
        fails = []
        agreement = snap.get("agreement")
        if agreement is None or agreement < g.min_agreement:
            fails.append(
                f"agreement {agreement if agreement is None else round(agreement, 4)}"
                f" < {g.min_agreement}"
            )
        if snap.get("errors", 0) > g.max_shadow_errors:
            fails.append(f"shadow errors {snap['errors']} > "
                         f"{g.max_shadow_errors}")
        if g.max_p99_delta_ms is not None:
            delta = snap.get("p99_delta_ms")
            if delta is not None and delta > g.max_p99_delta_ms:
                fails.append(f"p99 delta {delta:.2f}ms > "
                             f"{g.max_p99_delta_ms}ms")
        if (g.max_divergence_trips is not None
                and self.trip_source is not None):
            trips = int(self.trip_source()) - self._trips_at_candidate
            if trips > g.max_divergence_trips:
                fails.append(f"divergence trips {trips} > "
                             f"{g.max_divergence_trips}")
        return fails

    def _evaluate_shadow(self, doc: dict) -> None:
        scorer = self._scorer
        if scorer is None:
            # promoter restarted mid-shadow (recover() re-enters);
            # defensive: restart the candidate flow
            self._write(IDLE, reason="shadow lost; re-entering")
            return
        snap = scorer.snapshot()
        step = doc.get("candidate_step")
        if snap["shadowed"] < self.gates.min_shadow_requests:
            return  # keep mirroring
        fails = self._gate_failures(snap)
        if fails:
            self.server.set_shadow(None)
            self._scorer = None
            self._m_rejected.inc()
            logger.info("candidate step %s rejected: %s", step,
                        "; ".join(fails))
            self._write(ROLLED_BACK, rejected_steps=[step],
                        gates_passed=False,
                        reason="; ".join(fails))
            return
        logger.info("candidate step %s cleared shadow gates "
                    "(agreement %.4f over %d rows)", step,
                    snap["agreement"], snap["rows"])
        self._write(CANARYING, gates_passed=True)
        self._do_promote(self.journal.read())

    # -- the swap -------------------------------------------------------

    def _do_promote(self, doc: dict) -> None:
        step = doc.get("candidate_step")
        if step is None:
            self._write(IDLE, reason="canarying without a candidate")
            return
        entry = self.server.model_registry.entry()
        prev = entry.current
        code, body = self.server.reload({"step": step})
        self.server.set_shadow(None)
        if code != 200:
            # canary (or restore) failed: live version untouched
            self._scorer = None
            self._m_rejected.inc()
            logger.warning("candidate step %d failed promotion "
                           "reload (%s); live version keeps serving",
                           step, body.get("error", {}).get("status"))
            self._write(ROLLED_BACK, rejected_steps=[step],
                        reason=f"canary/reload failed "
                               f"({body.get('error', {}).get('status')})")
            return
        # keep the PREVIOUS snapshot (model object, warmed shapes) —
        # rollback re-installs it with zero new shapes and zero dropped
        # requests; weights the LRU paged out come back now (module
        # docstring)
        self._prev_snapshot = prev
        self.snapshot_pagein_ms = fault_in(prev.model)
        self._errors_at_promote = self.server.metrics.get(
            "server_error_total")
        self._predictions_at_promote = self.server.metrics.get(
            "predictions_total")
        self._promoted_at = time.monotonic()
        self._m_promotions.inc()
        probation = self.gates.probation_requests > 0
        if probation:
            prev_model = prev.model
            scorer = ShadowScorer(
                prev_model, fraction=self.shadow_fraction,
                seed=self.seed ^ step ^ 0xA5A5,
                ladder=self._ladder(), registry=self.registry,
                name=f"probation-prev-{doc.get('previous_step')}",
            )
            self._scorer = scorer
            self.server.set_shadow(scorer)
        else:
            self._scorer = None
        self._write(PROMOTED, promoted_step=step,
                    probation=probation, reason=None)
        logger.info("promoted candidate step %d (%s)", step,
                    "probation" if probation else "final")
        if not probation:
            self._prev_snapshot = None

    # -- probation ------------------------------------------------------

    def _error_rate_since_promote(self) -> float:
        errs = self.server.metrics.get("server_error_total") \
            - self._errors_at_promote
        preds = self.server.metrics.get("predictions_total") \
            - self._predictions_at_promote
        return errs / max(preds + errs, 1)

    def _probation_failures(self, snap: dict) -> "list[str]":
        g = self.gates
        fails = []
        # the reversed shadow: the previous version scores the NEW
        # live outputs — collapse in agreement or finiteness is the
        # regression signal
        floor = (g.probation_min_agreement
                 if g.probation_min_agreement is not None
                 else g.min_agreement)
        agreement = snap.get("agreement")
        if agreement is not None and agreement < floor:
            fails.append(f"probation agreement {agreement:.4f} < "
                         f"{floor}")
        if snap.get("live_nonfinite", 0) > 0:
            fails.append(f"live outputs non-finite x"
                         f"{snap['live_nonfinite']}")
        rate = self._error_rate_since_promote()
        if rate > g.max_error_rate:
            fails.append(f"error rate {rate:.4f} > {g.max_error_rate}")
        from deeplearning4j_tpu_torch.resilience.breaker import OPEN

        if self.server.breaker.state == OPEN:
            fails.append("predict breaker open")
        return fails

    def _evaluate_probation(self, doc: dict) -> None:
        scorer = self._scorer
        if scorer is None or self._prev_snapshot is None:
            # recovered process: recover() re-arms probation; if it
            # could not, seal the promotion (nothing to roll back TO)
            self._write(PROMOTED, probation=False,
                        reason="probation unarmed after recovery")
            return
        snap = scorer.snapshot()
        fails = self._probation_failures(snap)
        if fails:
            self._rollback(doc, "; ".join(fails))
            return
        if snap["shadowed"] < self.gates.probation_requests:
            return  # keep watching
        if (time.monotonic() - self._promoted_at
                < self.gates.probation_min_seconds):
            return  # count met, dwell not: keep watching
        self.server.set_shadow(None)
        self._scorer = None
        self._prev_snapshot = None
        self._write(PROMOTED, probation=False, reason=None)
        logger.info("promotion of step %s sealed (probation passed)",
                    doc.get("promoted_step"))

    def _rollback(self, doc: dict, reason: str) -> None:
        """Re-install the previous version's snapshot atomically: the
        retained ``ModelVersion`` still carries its device weights and
        warmed shape record, so the swap runs no new shape, and
        in-flight requests finish on the version they started with
        (workers snapshot the reference at predict start — the
        hot-reload invariant)."""
        step = doc.get("promoted_step")
        prev = self._prev_snapshot
        t0 = time.perf_counter()
        self.server.set_shadow(None)
        self._scorer = None
        with self.server._model_lock:
            entry = self.server.model_registry.entry()
            self.server.model_registry.swap(entry, prev)
        self.rollback_swap_ms = (time.perf_counter() - t0) * 1000.0
        # the bad candidate's step stays "handled": the reload
        # idempotence skip and check_for_update must not re-promote it
        self.server._watched_step = doc.get("previous_step")
        self._prev_snapshot = None
        self._m_rollbacks.inc()
        logger.warning("rolled back promotion of step %s: %s", step,
                       reason)
        self._write(ROLLED_BACK, rejected_steps=[step],
                    promoted_step=doc.get("previous_step"),
                    probation=False, reason=reason)

    # -- crash recovery -------------------------------------------------

    def recover(self) -> str:
        """Resume from whatever the journal shows — called once when a
        promoter (re)starts. Every half-applied transition is rolled
        forward or back; on return the server serves a version
        consistent with the journal."""
        with self._lock:
            doc = self.journal.read()
            st = doc.get("state", IDLE)
            if st in (CANDIDATE, SHADOWING):
                # the in-memory shadow died with the process: re-enter
                # the candidate flow from scratch (same candidate will
                # be re-discovered and re-shadowed)
                self._m_recoveries.inc()
                self._write(IDLE,
                            reason="recovered mid-shadow; re-entering")
            elif st == CANARYING:
                # gates passed, swap may or may not have landed: roll
                # FORWARD — reload({"step": N}) is an idempotent no-op
                # when the swap already happened
                self._m_recoveries.inc()
                logger.info("recovering a promotion of step %s from "
                            "the journal", doc.get("candidate_step"))
                self._do_promote(doc)
            elif st == PROMOTED and doc.get("probation"):
                # probation was live: re-arm it with the previous
                # version restored from its (retention-protected)
                # checkpoint; when that is impossible, seal
                self._m_recoveries.inc()
                self._recover_probation(doc)
            else:
                self._ensure_serving_consistency(doc)
            return self.journal.state

    def _recover_probation(self, doc: dict) -> None:
        prev_step = doc.get("previous_step")
        info = next((i for i in self.manager.available()
                     if i.step == prev_step), None)
        if info is None or not self.manager.verify(info):
            logger.warning(
                "cannot re-arm probation: previous step %s not "
                "restorable; sealing the promotion", prev_step,
            )
            self._write(PROMOTED, probation=False,
                        reason="probation unarmed after recovery")
            return
        try:
            prev_model = self.manager.restore(info, load_updater=False,
                                              device=self.server.device)
        except Exception:
            self._write(PROMOTED, probation=False,
                        reason="probation unarmed after recovery")
            return
        self._install_candidate_aot(prev_model, info)
        from deeplearning4j_tpu_torch.serving.registry import ModelVersion

        entry = self.server.model_registry.entry()
        shapes = self.server.compile_cache.register()
        try:
            # warm the restored snapshot's buckets now, so a rollback
            # to it runs no new shape either
            self.server._warm_model(prev_model, shapes,
                                    self.server._ladder_for(entry),
                                    name=entry.name)
        except Exception:
            logger.warning("warm-up of the restored previous step %s "
                           "failed", prev_step, exc_info=True)
        self._prev_snapshot = ModelVersion(
            prev_model, entry.current.version,
            f"checkpoint-step-{prev_step}", shapes,
        )
        scorer = ShadowScorer(
            prev_model, fraction=self.shadow_fraction,
            seed=self.seed ^ int(doc.get("promoted_step") or 0)
            ^ 0xA5A5,
            ladder=self._ladder(), registry=self.registry,
            name=f"probation-prev-{prev_step}",
        )
        feats = self._canary(prev_model)
        if feats is not None:
            scorer.warmup(feats)
        self._scorer = scorer
        self.server.set_shadow(scorer)
        self._errors_at_promote = self.server.metrics.get(
            "server_error_total")
        self._predictions_at_promote = self.server.metrics.get(
            "predictions_total")
        self._promoted_at = time.monotonic()  # dwell restarts
        logger.info("re-armed probation of step %s against restored "
                    "previous step %s", doc.get("promoted_step"),
                    prev_step)

    def _ensure_serving_consistency(self, doc: dict) -> None:
        """Steady states: the server must serve the journal's promoted
        step — a fresh boot restores the NEWEST checkpoint, which may
        be an unvetted candidate; demote it back to the promoted
        version so evaluation starts from a consistent base."""
        promoted = doc.get("promoted_step")
        if promoted is None or self._live_step() == promoted:
            return
        code, body = self.server.reload({"step": promoted})
        if code == 200:
            self._m_recoveries.inc()
            logger.info(
                "recovery demoted serving back to promoted step %d "
                "(was %s)", promoted, self._live_step(),
            )
        else:
            logger.warning(
                "recovery could not restore promoted step %s (%s); "
                "serving continues on step %s", promoted, body,
                self._live_step(),
            )

    # -- background polling ---------------------------------------------

    def run(self, interval: float = 0.25) -> "Promoter":
        """Poll on a daemon thread every ``interval`` seconds."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval):
                try:
                    self.poll()
                except SimulatedKill:
                    raise  # chaos: let the thread die like the process
                except Exception:
                    logger.exception("promoter poll failed")

        self._thread = threading.Thread(
            target=_loop, daemon=True, name="dl4j-loop-promoter",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- introspection --------------------------------------------------

    def snapshot(self) -> dict:
        doc = self.journal.read()
        out = {
            "state": doc.get("state"),
            "candidate_step": doc.get("candidate_step"),
            "previous_step": doc.get("previous_step"),
            "promoted_step": doc.get("promoted_step"),
            "probation": doc.get("probation"),
            "reason": doc.get("reason"),
            "promotions": self._m_promotions.value,
            "rollbacks": self._m_rollbacks.value,
            "rejected": self._m_rejected.value,
            "quarantined": self._m_quarantined.value,
            "journal_recoveries": self._m_recoveries.value,
            "snapshot_pagein_ms": self.snapshot_pagein_ms,
            "rollback_swap_ms": self.rollback_swap_ms,
        }
        if self._scorer is not None:
            out["shadow"] = self._scorer.snapshot()
        return out

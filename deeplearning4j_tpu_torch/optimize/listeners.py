"""Training listeners (reference ``optimize/api/IterationListener`` and
``optimize/listeners/*``).

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``. Every fit
loop of the port calls ``iteration_done(model, iteration)`` after each
optimizer step (both engines' per-step loops and the distributed
trainer's); under megastep the calls for a chunk's K steps come after
the chunk's one readback, each with ``score_value`` set to that step's
score. ``on_epoch_start`` / ``on_epoch_end`` run around each epoch
where a listener has them. Reading ``model.score_value`` waits for the
step on the card, so ``PerformanceListener`` reports end-to-end step
throughput.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)


class IterationListener:
    """SPI: ``iteration_done(model, iteration)``."""

    def iteration_done(self, model, iteration: int) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Log score every N iterations (reference
    ``ScoreIterationListener``)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(int(print_iterations), 1)

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.print_iterations == 0:
            logger.info(
                "Score at iteration %d is %s", iteration, model.score_value
            )


class PerformanceListener(IterationListener):
    """samples/sec + batches/sec (reference
    ``PerformanceListener.java:18,:71-86`` — the metric named in
    BASELINE.md)."""

    def __init__(self, frequency: int = 1, report: bool = False):
        self.frequency = max(int(frequency), 1)
        self.report = report
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self._samples_since = 0
        self.samples_per_sec = float("nan")
        self.batches_per_sec = float("nan")
        self.history: List[Tuple[int, float, float]] = []

    def record_batch(self, num_examples: int) -> None:
        self._samples_since += num_examples

    def iteration_done(self, model, iteration: int) -> None:
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            return
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            batches = iteration - self._last_iter
            self.batches_per_sec = batches / dt if dt > 0 else float("inf")
            if self._samples_since:
                self.samples_per_sec = (
                    self._samples_since / dt if dt > 0 else float("inf")
                )
            self.history.append(
                (iteration, self.samples_per_sec, self.batches_per_sec)
            )
            if self.report:
                logger.info(
                    "iteration %d: %.1f batches/sec, %.1f samples/sec",
                    iteration, self.batches_per_sec, self.samples_per_sec,
                )
            self._last_time = now
            self._last_iter = iteration
            self._samples_since = 0


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) pairs (reference
    ``CollectScoresIterationListener``)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(int(frequency), 1)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners: IterationListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration: int) -> None:
        for listener in self.listeners:
            listener.iteration_done(model, iteration)


class ParamAndGradientIterationListener(IterationListener):
    """Parameter-magnitude tracking (reference
    ``ParamAndGradientIterationListener``); records mean |param| per
    layer each N iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(int(frequency), 1)
        self.records: List[dict] = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency != 0:
            return
        rec = {"iteration": iteration}
        for ln, lp in (model.params or {}).items():
            for pn, p in lp.items():
                rec[f"{ln}.{pn}"] = float(p.detach().abs().float().mean())
        self.records.append(rec)

"""Shape accounting for the serving hot path.

Counterpart of ``deeplearning4j_tpu/serving/compile_cache.py``. The
JAX server compiles one XLA executable per input shape; the port
builds no program per shape (its compile-time cost is the ``nvcc``
build of the kernel library, ``compile/persistent.py``), but the
bucketed micro-batcher's contract is the same: the set of shapes a
model version runs is small and known before traffic, so every one of
them runs at ``start()`` / ``reload()`` and a shape that escapes the
ladder is a fault worth a log line.

- every forward at a shape the version has not run counts
  ``xla_compiles_total`` (the JAX name; on the port: a first forward at
  that shape);
- the guard: once a version is marked warmed, a new shape is logged
  and counted in ``post_warmup_compiles_total``; steady bucketed
  traffic keeps it flat;
- ``preload`` marks the shapes of an installed AOT bundle as run.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Set, Tuple

logger = logging.getLogger(__name__)

NEW = "new"                  # first time this version ran this shape
WARM = "warm"                # shape already run (the steady state)
POST_WARMUP = "post_warmup"  # new shape AFTER warmup: ladder escape


class ModelShapes:
    """The shape set of one model version. Created by
    ``CompileCache.register()`` at load time, marked warmed once every
    ladder bucket has run."""

    __slots__ = ("seen", "warmed", "_lock")

    def __init__(self):
        self.seen: Set[Tuple[int, ...]] = set()
        self.warmed = False
        self._lock = threading.Lock()

    def note(self, shape: Tuple[int, ...]) -> str:
        with self._lock:
            if shape in self.seen:
                return WARM
            self.seen.add(shape)
            return POST_WARMUP if self.warmed else NEW

    def preload(self, shapes) -> None:
        """Mark shapes as already run without counting them (an AOT
        bundle's buckets): ``xla_compiles_total`` stays flat for them."""
        with self._lock:
            for s in shapes:
                self.seen.add(tuple(int(d) for d in s))

    def mark_warmed(self) -> None:
        with self._lock:
            self.warmed = True


class CompileCache:
    """Per-server shape accounting: a ``ModelShapes`` record per model
    version, and the ``xla_compiles_total`` /
    ``post_warmup_compiles_total`` counters with the guard's log line
    and an ``xla.compile`` trace event."""

    def __init__(self, metrics=None, tracer=None):
        self.metrics = metrics
        self.tracer = tracer

    def register(self) -> ModelShapes:
        return ModelShapes()

    def note(self, shapes: Optional[ModelShapes],
             shape: Tuple[int, ...],
             model: Optional[str] = None) -> str:
        if shapes is None:
            return WARM
        verdict = shapes.note(tuple(int(d) for d in shape))
        if verdict == WARM:
            return verdict
        if self.metrics is not None:
            self.metrics.incr("xla_compiles_total")
        if self.tracer is not None:
            attrs = {"shape": [int(d) for d in shape], "verdict": verdict}
            if model is not None:
                attrs["model"] = model
            self.tracer.event("xla.compile", attrs=attrs)
        if verdict == POST_WARMUP:
            if self.metrics is not None:
                self.metrics.incr("post_warmup_compiles_total")
            logger.warning(
                "post-warmup shape: input shape %s%s was not covered by "
                "the warmed bucket ladder", tuple(shape),
                f" (model {model!r})" if model is not None else "")
        return verdict


def jit_cache_size(model) -> Optional[int]:
    """The number of distinct (shape, dtype) inference forwards the
    model has run (``output`` / ``output_padded``); None for a model
    that does not record them."""
    seen = getattr(model, "_output_signatures", None)
    return None if seen is None else len(seen)

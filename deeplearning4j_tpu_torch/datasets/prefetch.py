"""The prefetching training input pipeline.

Counterpart of ``deeplearning4j_tpu/datasets/prefetch.py``.
:class:`PrefetchIterator` wraps any ``DataSetIterator`` with a bounded
background queue (depth ``queue_depth``, default 2) whose one worker
thread does the expensive host work off the step's path:

- **materialization**: ``base.next()`` runs on the worker;
- **validation**: with ``validator`` every base batch is screened there
  before placement (``datasets/validate.py``), rejects quarantined;
- **placement**: an optional ``placement(ds)`` runs there too.
  ``DistributedTrainer.place_minibatch`` is the intended one: on the
  card it stages the rank's rows in pinned memory and copies them on a
  CUDA stream of the worker's own, recording an event after the
  copies; the consumer's stream waits on that event
  (``PlacedDataSet.wait``), so the copy of batch i + 1 overlaps step i;
- **chunking**: with ``megastep=K`` the worker assembles blocks of K
  same-shaped minibatches and hands each to ``chunk_placement``
  (``DistributedTrainer.place_chunk``) or stacks it on the host
  (``ChunkedDataSet``): the megastep executor's double-buffered feed.

Contracts: one worker and one FIFO queue, so the consumer sees the base
order and a pipelined fit is bitwise the synchronous loop; a worker
fault surfaces on the consumer as ``DL4JFaultException`` (the original
chained) after every batch fetched before it; ``shutdown()`` (also run
by ``reset()`` and ``close()``) cancels and joins the worker within its
timeout, even when it is blocked on a full queue. Metrics (the JAX
package's names): ``training_prefetch_queue_depth`` (batches ready at
each take) and ``training_prefetch_wait_ms`` (the consumer's stall for
the next batch); the stall is also noted into the active step
profiler's step (its ``input_stall_ms``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.datasets.iterators import AsyncDataSetIterator
from deeplearning4j_tpu_torch.exceptions import DL4JFaultException
from deeplearning4j_tpu_torch.observability import profiler

# fine buckets at the bottom (a fed pipeline waits ~0) and coarse at
# the top (a starved one waits a whole batch-materialization)
WAIT_MS_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 1000.0)


class _PlacingIterator:
    """Producer-side adapter: run the placement on the worker thread,
    so the cast and the copy to the device overlap training."""

    def __init__(self, base: DataSetIterator,
                 placement: Optional[Callable]):
        self.base = base
        self.placement = placement

    def __iter__(self):
        for ds in self.base:
            yield self.placement(ds) if self.placement else ds

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()


def _chunk_sig(ds):
    """The shape signature deciding which batches may stack into one
    megastep block (shapes only: nothing is read)."""
    import numpy as np

    def sh(a):
        return None if a is None else tuple(np.shape(a))

    return (
        sh(getattr(ds, "features", None)),
        sh(getattr(ds, "labels", None)),
        sh(getattr(ds, "labels_mask", None)),
        sh(getattr(ds, "features_mask", None)),
    )


def _stack_host_chunk(batches):
    """The default chunk assembly: k host minibatches stacked into one
    [k, b, ...] :class:`~.api.ChunkedDataSet` on the worker thread (the
    consumer copies it to the device); a ``chunk_placement`` (e.g.
    ``DistributedTrainer.place_chunk``) stacks and copies it there
    instead, so the copy leaves the step's path too."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet

    def stack(get):
        first = get(batches[0])
        if first is None:
            return None
        return np.stack([np.asarray(get(b)) for b in batches])

    return ChunkedDataSet(
        features=stack(lambda b: b.features),
        labels=stack(lambda b: b.labels),
        features_mask=stack(lambda b: getattr(b, "features_mask", None)),
        labels_mask=stack(lambda b: getattr(b, "labels_mask", None)),
    )


class _ChunkingIterator:
    """Producer-side adapter for megastep training: assemble blocks of
    ``k`` same-shaped minibatches on the worker thread and emit one
    chunk payload a block, the double-buffered feed: while the card
    runs the current chunk, the worker stacks (and through
    ``chunk_placement`` copies to the device) the next block.

    Multi-input batches (list-valued features) and shape-changing or
    trailing partial blocks pass through as individual (optionally
    ``placement``-placed) batches — the consumer's per-step fallback
    keeps the trajectory identical."""

    def __init__(self, base: DataSetIterator, k: int,
                 chunk_placement: Optional[Callable],
                 placement: Optional[Callable]):
        self.base = base
        self.k = int(k)
        self.chunk_placement = chunk_placement
        self.placement = placement

    def _assemble(self, buf):
        if self.chunk_placement is not None:
            return self.chunk_placement(buf)
        return _stack_host_chunk(buf)

    def _passthrough(self, ds):
        return self.placement(ds) if self.placement else ds

    def __iter__(self):
        buf, sig = [], None
        for ds in self.base:
            if isinstance(ds.features, (list, tuple)):
                for b in buf:
                    yield self._passthrough(b)
                buf, sig = [], None
                yield self._passthrough(ds)
                continue
            s = _chunk_sig(ds)
            if buf and s != sig:
                # a shape change ends the block early: a short block
                # still beats per-batch feed when >= 2 stacked
                if len(buf) >= 2:
                    yield self._assemble(buf)
                else:
                    yield self._passthrough(buf[0])
                buf = []
            sig = s
            buf.append(ds)
            if len(buf) >= self.k:
                yield self._assemble(buf)
                buf = []
        if len(buf) >= 2:
            yield self._assemble(buf)
        elif buf:
            yield self._passthrough(buf[0])

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()


class PrefetchIterator(AsyncDataSetIterator):
    """Bounded background prefetch + optional device placement (see
    module docstring). Drop-in for any ``DataSetIterator``::

        it = PrefetchIterator(base, queue_depth=2,
                              placement=trainer.place_minibatch)
        trainer.fit(it, epochs=3)   # or: trainer.fit(base, prefetch=2)

    Without ``placement`` the worker only materializes host batches —
    still worthwhile when ``base.next()`` is expensive. With it, the
    consumer receives :class:`~..api.PlacedDataSet` device batches.

    ``validator`` (a :class:`~.validate.BatchValidator`) screens every
    base batch ON THE WORKER THREAD before placement — the validation
    host pass rides the same overlap as materialization, so a defended
    pipeline costs the consumer nothing extra; offenders go to
    ``quarantine`` (a :class:`~.validate.QuarantineStore`) and are
    skipped. The wrapped validating iterator is exposed as
    ``self.validating`` for ledger access.
    """

    def __init__(self, base: DataSetIterator, queue_depth: int = 2,
                 placement: Optional[Callable] = None,
                 registry=None, validator=None, quarantine=None,
                 megastep: int = 1,
                 chunk_placement: Optional[Callable] = None):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.validating = None
        if validator is not None:
            from deeplearning4j_tpu_torch.datasets.validate import (
                ValidatingIterator,
            )

            if isinstance(base, ValidatingIterator):
                self.validating = base
            else:
                self.validating = base = ValidatingIterator(
                    base, validator, quarantine=quarantine,
                )
        self.megastep = int(megastep or 1)
        if self.megastep > 1:
            # chunk-stacking mode: each queue item is a whole K-batch
            # block, assembled (and placed) on the worker — the
            # double-buffered feed of the megastep executor
            producer = _ChunkingIterator(
                base, self.megastep, chunk_placement, placement
            )
        else:
            producer = _PlacingIterator(base, placement)
        super().__init__(producer, queue_depth)
        self._user_base = base
        if registry is None:
            from deeplearning4j_tpu_torch.observability.metrics import (
                default_registry,
            )

            registry = default_registry()
        self.registry = registry
        self._depth_gauge = registry.gauge(
            "training_prefetch_queue_depth",
            help="prefetched batches ready at the last consumer take",
        )._default()
        self._wait_hist = registry.histogram(
            "training_prefetch_wait_ms", buckets=WAIT_MS_BUCKETS,
            help="consumer stall waiting for the next prefetched "
                 "batch (ms)",
        )._default()

    # -- instrumented queue take ---------------------------------------

    def _advance(self) -> None:
        t0 = time.perf_counter()
        super()._advance()
        wait_ms = (time.perf_counter() - t0) * 1000.0
        self._wait_hist.observe(wait_ms)
        prof = profiler.get_active_profiler()
        if prof is not None:
            prof.note_input_wait_ms(wait_ms)
        q = self._queue
        if q is not None:
            self._depth_gauge.set(q.qsize())

    # -- fault taxonomy -------------------------------------------------

    def next(self) -> DataSet:
        try:
            return super().next()
        except (StopIteration, DL4JFaultException):
            raise
        except BaseException as e:
            # a worker-thread fault (source iterator, placement) is a
            # runtime fault of the input pipeline: surface it in the
            # resilience taxonomy with the original chained
            raise DL4JFaultException(
                f"prefetch pipeline failed: {type(e).__name__}: {e}"
            ) from e

    def shutdown(self, timeout: float = 5.0,
                 raise_pending: bool = False) -> None:
        """Cancel and join the worker within ``timeout`` seconds.

        With ``raise_pending=True`` (the preemption path) a worker
        fault that was queued for delivery but never consumed — the
        consumer is shutting down early, so ``next()`` would never
        surface it — re-raises here as ``DL4JFaultException`` AFTER
        the join, so the fault is neither lost nor racing a live
        worker. The default (False) keeps ``close()``/``reset()``
        unwind-safe: raising from a ``finally`` would mask the
        original exception."""
        super().shutdown(timeout=timeout)
        if raise_pending:
            exc = self._pending_exc or self._exception
            self._pending_exc = None
            self._exception = None
            if exc is not None:
                raise DL4JFaultException(
                    f"prefetch worker fault pending at shutdown: "
                    f"{type(exc).__name__}: {exc}"
                ) from exc

    def close(self) -> None:
        """Alias for ``shutdown()`` (context-manager friendly)."""
        self.shutdown()

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- SPI delegation to the USER base (not the adapter) --------------

    def batch(self) -> int:
        return self._user_base.batch()

    def total_examples(self) -> int:
        return self._user_base.total_examples()

"""Iterator wrappers (reference ``datasets/iterator/*``).

Counterpart of ``AsyncDataSetIterator`` in
``deeplearning4j_tpu/datasets/iterators.py`` (reference
``AsyncDataSetIterator.java:36``): a background thread fills a bounded
queue from the base iterator, a worker exception surfaces on the
consumer after every batch fetched before it, and ``shutdown`` cancels
and joins the worker within a timeout. ``datasets/prefetch.py``'s
``PrefetchIterator`` builds on it. The rest of the JAX module (the
device-prefetching and sampling iterators) is not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

_SENTINEL = object()


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference
    ``AsyncDataSetIterator.java:36,:75-76,:256`` — IteratorRunnable
    feeding a LinkedBlockingQueue of ``queue_size``)."""

    def __init__(self, base: DataSetIterator, queue_size: int = 2):
        if queue_size < 1:
            raise ValueError("queue_size must be >= 1")
        self.base = base
        self.queue_size = queue_size
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._exception: Optional[BaseException] = None
        self._pending_exc: Optional[BaseException] = None
        self._next_item = None
        self._needs_advance = False
        self._started = False

    # -- internals -----------------------------------------------------

    def _runner(self, q: "queue.Queue", stop: threading.Event) -> None:
        def put(item) -> bool:
            # bounded put that gives up when the consumer cancels
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for ds in self.base:
                if not put(ds):
                    return  # cancelled; no sentinel needed
        except BaseException as e:  # surfaced on the consumer thread
            self._exception = e
        finally:
            put(_SENTINEL)

    def _start(self) -> None:
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._stop = threading.Event()
        self._exception = None
        self._thread = threading.Thread(
            target=self._runner, args=(self._queue, self._stop), daemon=True
        )
        self._thread.start()
        self._started = True
        self._needs_advance = False
        self._advance()

    def _advance(self) -> None:
        item = self._queue.get()
        if item is _SENTINEL:
            self._next_item = None
            if self._exception is not None:
                # deliver already-fetched batches first; raise on the
                # call that would need the failed batch
                self._pending_exc = self._exception
                self._exception = None
        else:
            self._next_item = item

    # -- DataSetIterator -----------------------------------------------

    def has_next(self) -> bool:
        if not self._started:
            self._start()
        elif self._needs_advance:
            # deferred take (see next()): block for the following item
            # only now, AFTER the consumer has processed the previous
            # one — an eager advance inside next() would stall the
            # consumer on item N+1's production before it could even
            # start working on item N, fully serializing a producer
            # that is slower than the consumer
            self._needs_advance = False
            self._advance()
        return self._next_item is not None or self._pending_exc is not None

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        if self._next_item is None and self._pending_exc is not None:
            exc, self._pending_exc = self._pending_exc, None
            raise exc
        ds = self._next_item
        self._next_item = None
        self._needs_advance = True
        return ds

    def reset(self) -> None:
        self.shutdown()
        if hasattr(self.base, "reset"):
            self.base.reset()
        self._started = False
        self._next_item = None
        self._needs_advance = False

    def shutdown(self, timeout: float = 5.0) -> None:
        """Cancel and join the worker (reference ``shutdown()``). Safe
        to call mid-stream: the producer observes the stop flag instead
        of blocking on a full queue. The join is bounded by
        ``timeout`` seconds — a worker that refuses to die raises
        instead of hanging the caller (the preemption path runs this
        inside a grace window)."""
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            # unblock a producer stuck between puts
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():  # pragma: no cover
                raise RuntimeError("AsyncDataSetIterator worker leaked")
        self._thread = None

    def batch(self) -> int:
        return self.base.batch()

    def total_examples(self) -> int:
        return self.base.total_examples()

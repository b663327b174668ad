"""Cross-request micro-batching for the serving hot path.

Copy of ``deeplearning4j_tpu/serving/batcher.py``. Batching many small
requests into one device dispatch is the classic serving fix, and a
fixed set of *bucketed* row counts keeps the shapes the device sees to
a few, all warmed at ``start()``:

- ``BucketLadder``: the row-count buckets (powers of two up to
  ``max_batch_size`` by default). A batch of n valid rows pads to the
  smallest bucket >= n.
- ``MicroBatcher``: the coalescing policy of the drain thread. Given
  the first queued item it keeps draining until ``max_batch_size`` rows
  are collected or ``batch_timeout_ms`` elapses, and it dispatches at
  once when nothing else is in the system, so a lone request pays no
  coalescing wait.

``pad_rows`` and ``fill_chunks`` are pure functions, so the padding
contract is testable without a server.
"""

from __future__ import annotations

import queue
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


class BucketLadder:
    """The serving shape ladder: sorted row-count buckets.

    Default is powers of two up to ``max_batch_size`` (1, 2, 4, ...,
    max). ``bucket_for(n)`` returns the smallest bucket that holds n
    rows, or None when n overflows the ladder (the caller falls back
    to the solo path with its own shape).
    """

    def __init__(self, buckets: Optional[Sequence[int]] = None,
                 max_batch_size: int = 32):
        if buckets is None:
            if max_batch_size < 1:
                raise ValueError("max_batch_size must be >= 1")
            buckets = []
            b = 1
            while b < max_batch_size:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch_size)
        self.buckets: List[int] = sorted({int(b) for b in buckets})
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("bucket ladder needs positive row counts")

    @property
    def max(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int) -> Optional[int]:
        if rows < 1:
            raise ValueError("rows must be >= 1")
        for b in self.buckets:
            if b >= rows:
                return b
        return None

    def __repr__(self) -> str:
        return f"BucketLadder({self.buckets})"


def pad_rows(stacked: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a [n, ...] array with zero rows to [bucket, ...]. Zeros —
    not repeats — so a bug that reads a padding row produces visibly
    wrong output instead of a silently-duplicated neighbor."""
    n = stacked.shape[0]
    if n == bucket:
        return stacked
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    pad = np.zeros((bucket - n,) + stacked.shape[1:], stacked.dtype)
    return np.concatenate([stacked, pad], axis=0)


def fill_chunks(pairs: List[Tuple[object, np.ndarray]],
                max_rows: int) -> List[List[Tuple[object, np.ndarray]]]:
    """Greedily pack (item, features) pairs into chunks of at most
    ``max_rows`` total rows, preserving arrival order. A single item
    wider than ``max_rows`` gets a chunk of its own (the caller routes
    it to the solo path)."""
    chunks: List[List[Tuple[object, np.ndarray]]] = []
    cur: List[Tuple[object, np.ndarray]] = []
    rows = 0
    for item, feats in pairs:
        r = int(feats.shape[0])
        if cur and rows + r > max_rows:
            chunks.append(cur)
            cur, rows = [], 0
        cur.append((item, feats))
        rows += r
    if cur:
        chunks.append(cur)
    return chunks


class MicroBatcher:
    """Coalescing policy for the batch-drain loop.

    ``collect(q, first, inflight)`` returns ``(items, carry)``: the
    items to batch now, plus at most one item that would have
    overflowed ``ladder.max`` rows (the caller starts the next batch
    with it instead of re-queueing, which would reorder).

    The wait is adaptive — continuous batching, not fixed windows.
    After draining everything immediately available, the batcher
    dispatches AT ONCE unless ``inflight()`` reports more admitted
    requests than it has collected — i.e. items are provably queued
    or mid-admission, so a short wait trades microseconds for a wider
    dispatch. The wait is one *blocking* ``get`` (it wakes the moment
    the straggler lands — never a poll loop burning the GIL the
    forward needs), bounded by ``batch_timeout_ms`` from the first
    empty read. Saturated closed-loop load therefore self-organizes:
    each dispatch collects everything in the system, the queue
    refills DURING the forward, and the next drain takes the lot. At
    concurrency 1 the inflight test fails immediately and solo-load
    p50 pays no coalescing tax.
    """

    def __init__(self, ladder: BucketLadder,
                 batch_timeout_ms: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if batch_timeout_ms < 0:
            raise ValueError("batch_timeout_ms must be >= 0")
        self.ladder = ladder
        self.batch_timeout_ms = batch_timeout_ms
        self._clock = clock

    def collect(self, q: "queue.Queue", first,
                inflight: Callable[[], int]):
        items = [first]
        rows = first.rows
        give_up_at: Optional[float] = None
        while rows < self.ladder.max:
            try:
                nxt = q.get_nowait()
            except queue.Empty:
                if inflight() <= len(items):
                    break  # nothing else in the system: go now
                now = self._clock()
                if give_up_at is None:
                    give_up_at = now + self.batch_timeout_ms / 1000.0
                remaining = give_up_at - now
                if remaining <= 0:
                    break
                try:
                    nxt = q.get(timeout=remaining)
                except queue.Empty:
                    break  # window exhausted
            if rows + nxt.rows > self.ladder.max:
                return items, nxt  # overflow: starts the next batch
            items.append(nxt)
            rows += nxt.rows
        return items, None

"""The metrics registry: one registry, four instrument kinds.

Counterpart of ``deeplearning4j_tpu/observability/metrics.py``, kept
as its own copy: ``MetricsRegistry`` hands out counter / gauge /
histogram (fixed upper bounds, cumulative at export) / summary
(quantile reservoir) families by name; a family with ``labels=(...)``
fans out into labeled children through ``.labels(...)``, an unlabeled
one is its single instrument. Registration is idempotent by name (a
kind mismatch raises), every update is thread-safe, the clock is
injectable, and a disabled registry (``enabled=False``) makes every
instrument a flag check. The training runtime publishes into
``default_registry()`` under the JAX package's metric names and help
strings: the prefetch queue (``training_prefetch_*``), the dispatch
window (``training_step_gap_ms``), the checkpoint manager
(``checkpoint_*``), the batch validator (``batches_quarantined_total``,
``quarantine_bytes``), preemption (``preemption_*``) and the
divergence guard (``guard_*``). ``Reservoir`` and ``Histogram`` are the
primitives; ``mean_magnitudes`` / ``array_histograms`` summarize a
parameter tree (``host_arrays`` reads one back from the card).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"
SUMMARY = "summary"


class Reservoir:
    """Ring buffer of the last ``size`` observations with
    nearest-rank quantiles. Bounded memory however long the process
    runs; recency bias is the point — dashboards want "how slow is it
    NOW", not a since-boot average."""

    def __init__(self, size: int = 1024):
        if size < 1:
            raise ValueError("size must be >= 1")
        self.size = size
        self._ring: List[float] = []
        self._next = 0
        self.count = 0   # total ever recorded
        self.total = 0.0  # running sum (Prometheus summary _sum)

    def record(self, value: float) -> None:
        if len(self._ring) < self.size:
            self._ring.append(value)
        else:
            self._ring[self._next] = value
        self._next = (self._next + 1) % self.size
        self.count += 1
        self.total += value

    def quantile(self, q: float) -> Optional[float]:
        if not self._ring:
            return None
        s = sorted(self._ring)
        idx = min(len(s) - 1, max(0, int(q * len(s))))
        return s[idx]

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "max": max(self._ring) if self._ring else None,
        }


class Histogram:
    """Fixed-boundary counting histogram: ``record(v)`` counts v into
    the first boundary >= v (an overflow bin catches the rest).
    Bounded memory, O(log b) record. ``cumulative()`` yields the
    Prometheus view: (upper_bound, cumulative_count) pairs ending at
    +Inf == total count."""

    def __init__(self, boundaries: Sequence[float]):
        if not boundaries:
            raise ValueError("histogram needs at least one boundary")
        self.boundaries = sorted(float(b) for b in boundaries)
        self._counts = [0] * (len(self.boundaries) + 1)
        self.count = 0
        self.total = 0.0

    def record(self, value: float) -> None:
        self._counts[bisect.bisect_left(self.boundaries, value)] += 1
        self.count += 1
        self.total += value

    def cumulative(self) -> List[Tuple[float, int]]:
        out = []
        running = 0
        for b, c in zip(self.boundaries, self._counts):
            running += c
            out.append((b, running))
        out.append((float("inf"), running + self._counts[-1]))
        return out

    def snapshot(self) -> dict:
        buckets = {}
        for b, c in zip(self.boundaries, self._counts):
            buckets[f"le_{b:g}"] = c
        buckets["overflow"] = self._counts[-1]
        return {
            "count": self.count,
            "mean": (self.total / self.count) if self.count else None,
            "buckets": buckets,
        }


# -- array-summary helpers (shared with the UI stats listener) ----------


def host_arrays(tree: dict, fresh: bool = False) -> dict:
    """``{layer: {param: array}}`` as host numpy arrays, read in one pass:
    every tensor on a card is queued as a non-blocking ``.detach().to(
    "cpu")`` copy (pinned memory) and the card is waited on once, after
    the last copy, rather than once a parameter. A CPU tensor is read in
    place (bfloat16, which numpy lacks, as float32), a numpy array as it
    is. ``fresh``: every array is a copy that later in-place writes to
    the tree's tensors do not reach."""
    import numpy as np
    import torch

    out: dict = {}
    pending = []  # (row, name, pinned copy of a device tensor)
    cards = set()
    for lname, params in tree.items():
        row = out[lname] = {}
        for pname, arr in params.items():
            if not torch.is_tensor(arr):
                a = np.asarray(arr)
                row[pname] = np.array(a) if fresh else a
                continue
            t = arr.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            if t.device.type == "cpu":
                row[pname] = t.numpy().copy() if fresh else t.numpy()
            else:
                pending.append((row, pname, t.to("cpu", non_blocking=True)))
                cards.add(t.device)
    for dev in cards:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    for row, pname, t in pending:
        row[pname] = t.numpy()
    return out


def mean_magnitudes(tree: dict) -> dict:
    """``{layer: {param: array}}`` -> ``{"layer_param": mean |x|}``
    (tensors on a card read back in one pass, ``host_arrays``)."""
    import numpy as np

    out = {}
    for lname, params in host_arrays(tree).items():
        for pname, a in params.items():
            out[f"{lname}_{pname}"] = float(np.mean(np.abs(a)))
    return out


def array_histograms(tree: dict, bins: int = 20) -> dict:
    """Per-param value histograms of a param tree (the UI's histogram
    tab payload: min/max/counts per ``layer_param``; tensors on a card
    read back in one pass, ``host_arrays``)."""
    import numpy as np

    out = {}
    for lname, params in host_arrays(tree).items():
        for pname, a in params.items():
            counts, edges = np.histogram(a.ravel(), bins=bins)
            out[f"{lname}_{pname}"] = {
                "min": float(edges[0]), "max": float(edges[-1]),
                "counts": counts.tolist(),
            }
    return out


# -- instruments --------------------------------------------------------


class _Instrument:
    """One time series: a (family, label values) pair. All updates
    take the instrument lock; the registry's enabled flag is checked
    first so no-op mode costs one branch."""

    __slots__ = ("family", "label_values", "_lock")

    def __init__(self, family: "Family", label_values: Tuple[str, ...]):
        self.family = family
        self.label_values = label_values
        self._lock = threading.Lock()


class Counter(_Instrument):
    __slots__ = ("_value",)

    def __init__(self, family, label_values):
        super().__init__(family, label_values)
        self._value = 0

    def inc(self, n: float = 1) -> None:
        if not self.family.registry.enabled:
            return
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Instrument):
    __slots__ = ("_value",)

    def __init__(self, family, label_values):
        super().__init__(family, label_values)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self.family.registry.enabled:
            return
        with self._lock:
            self._value = v

    def add(self, n: float = 1) -> None:
        if not self.family.registry.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class HistogramInstrument(_Instrument):
    __slots__ = ("hist",)

    def __init__(self, family, label_values):
        super().__init__(family, label_values)
        self.hist = Histogram(family.buckets)

    def observe(self, v: float) -> None:
        if not self.family.registry.enabled:
            return
        with self._lock:
            self.hist.record(v)

    def snapshot(self) -> dict:
        with self._lock:
            return self.hist.snapshot()

    def cumulative(self) -> List[Tuple[float, int]]:
        with self._lock:
            return self.hist.cumulative()

    @property
    def count(self) -> int:
        with self._lock:
            return self.hist.count

    @property
    def total(self) -> float:
        with self._lock:
            return self.hist.total


class SummaryInstrument(_Instrument):
    __slots__ = ("reservoir",)

    def __init__(self, family, label_values):
        super().__init__(family, label_values)
        self.reservoir = Reservoir(family.reservoir_size)

    def observe(self, v: float) -> None:
        if not self.family.registry.enabled:
            return
        with self._lock:
            self.reservoir.record(v)

    def snapshot(self) -> dict:
        with self._lock:
            return self.reservoir.snapshot()

    def quantile_values(self) -> List[Tuple[float, Optional[float]]]:
        with self._lock:
            return [
                (q, self.reservoir.quantile(q))
                for q in self.family.quantiles
            ]

    @property
    def count(self) -> int:
        with self._lock:
            return self.reservoir.count

    @property
    def total(self) -> float:
        with self._lock:
            return self.reservoir.total


_KIND_CLASSES = {
    COUNTER: Counter,
    GAUGE: Gauge,
    HISTOGRAM: HistogramInstrument,
    SUMMARY: SummaryInstrument,
}


class Family:
    """All time series sharing one metric name. With ``label_names``
    empty the family proxies straight to its single child, so
    ``registry.counter("x").inc()`` works; with labels,
    ``family.labels("a")`` / ``family.labels(model="a")`` returns the
    child for those values (creating it on first use)."""

    def __init__(self, registry: "MetricsRegistry", name: str,
                 kind: str, help: str, label_names: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None,
                 reservoir_size: int = 1024,
                 quantiles: Sequence[float] = (0.5, 0.9, 0.99)):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self.buckets = list(buckets) if buckets is not None else None
        self.reservoir_size = reservoir_size
        self.quantiles = tuple(quantiles)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Instrument] = {}
        # unlabeled families cache their single child so the proxy
        # methods below are one attribute hop (hot-path cost)
        self._child0: Optional[_Instrument] = None
        if not self.label_names:
            self._child0 = _KIND_CLASSES[kind](self, ())
            self._children[()] = self._child0

    def labels(self, *values, **kv) -> _Instrument:
        if kv:
            if values:
                raise ValueError("pass labels positionally OR by name")
            try:
                values = tuple(str(kv[n]) for n in self.label_names)
            except KeyError as e:
                raise ValueError(
                    f"metric {self.name!r} needs labels "
                    f"{self.label_names}, got {tuple(kv)}"
                ) from e
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes {len(self.label_names)} "
                f"label(s) {self.label_names}, got {len(values)}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = _KIND_CLASSES[self.kind](self, values)
                self._children[values] = child
            return child

    def children(self) -> List[_Instrument]:
        with self._lock:
            return list(self._children.values())

    # -- unlabeled proxy ------------------------------------------------

    def _default(self) -> _Instrument:
        if self._child0 is None:
            raise ValueError(
                f"metric {self.name!r} has labels {self.label_names}; "
                "call .labels(...) first"
            )
        return self._child0

    def inc(self, n: float = 1) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def add(self, n: float = 1) -> None:
        self._default().add(n)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self):
        return self._default().value

    def snapshot(self):
        return self._default().snapshot()


class MetricsRegistry:
    """Thread-safe instrument registry (see module docstring).

    ``enabled=False`` (or ``enable(False)`` later) flips every
    instrument into no-op mode: registration still works — the signal
    catalog stays complete — but updates return after one branch.
    The ``clock`` is carried for consumers that time things against
    the registry (injectable so tests advance time manually)."""

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    def _register(self, name: str, kind: str, help: str,
                  labels: Sequence[str], **opts) -> Family:
        if not _NAME_RE.fullmatch(name):
            raise ValueError(
                f"metric name {name!r} is not Prometheus-legal "
                "([a-zA-Z_:][a-zA-Z0-9_:]*)"
            )
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}"
                    )
                return fam
            fam = Family(self, name, kind, help, tuple(labels), **opts)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._register(name, COUNTER, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._register(name, GAUGE, help, labels)

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._register(name, HISTOGRAM, help, labels,
                              buckets=buckets)

    def summary(self, name: str, reservoir_size: int = 1024,
                quantiles: Sequence[float] = (0.5, 0.9, 0.99),
                help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._register(name, SUMMARY, help, labels,
                              reservoir_size=reservoir_size,
                              quantiles=quantiles)

    def collect(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def names(self) -> List[str]:
        with self._lock:
            return list(self._families)

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)


# A process-wide default registry: training-side listeners publish
# here unless handed their own, and the UI server's /metrics scrapes
# it. Serving keeps a per-ModelServer registry (isolated counters per
# server instance).
_default_registry = MetricsRegistry()

# A shared always-disabled registry for "instrumented but off".
NULL_REGISTRY = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _default_registry

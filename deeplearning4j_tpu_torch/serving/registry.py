"""Multi-tenant model registry and LRU weight paging.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``: one serving
process, N named models, whose working set may exceed the card. Cold
models' weights live in host memory and fault back onto the card on
demand, with a pin list for the tenants that must never miss.

- ``ModelVersion``: one immutable (model, version) pair; a hot reload
  swaps it, so an in-flight request finishes on the version it took.
- ``ModelEntry``: one tenant: its current version, admission quota,
  deadline override, optional bucket ladder and paging state
  (``device`` / ``host``, bytes, LRU time, executing count).
- ``ModelRegistry``: the name -> entry map and the paging policy.
  ``touch(entry)`` brackets every forward: it bumps the LRU clock,
  faults the weights in when evicted (``weight_pagein_ms``) and marks
  the entry executing, so the evictor never pages out a running model;
  ``max_device_models`` / ``max_device_bytes`` bound the resident set,
  and the victim is the least recently used unpinned idle entry.

Paging moves only the weights, the ``params`` and ``state`` dicts
(parameters and layer state such as BatchNormalization's running
statistics): card -> pinned host tensors and back, with the same
shapes, dtypes and dict structure, so the same kernels run on the same
operands and the answers after a fault-in are bitwise those before the
eviction. The model is handed fresh dicts each way (a dict the model
held is never refilled in place), and a page-in waits for its copies
before the forward runs. The pinned host tensors are kept for the next
eviction of that model.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

DEVICE = "device"
HOST = "host"

# paging moves these model attributes ({layer: {name: tensor}}); the
# rest of a model (conf, updater state, step caches) stays put
_PAGEABLE_ATTRS = ("params", "state")


class ModelVersion:
    """One immutable (model, version) pair. Workers take the reference
    at predict start, so a swap never changes the model under an
    in-flight request. ``shapes`` is this version's
    ``compile_cache.ModelShapes`` record."""

    __slots__ = ("model", "version", "source", "shapes")

    def __init__(self, model, version: int, source: str, shapes=None):
        self.model = model
        self.version = version
        self.source = source
        self.shapes = shapes


def _leaves(model):
    for attr in _PAGEABLE_ATTRS:
        tree = getattr(model, attr, None) or {}
        for layer in tree.values():
            for t in layer.values():
                if torch.is_tensor(t):
                    yield t


def _tree_device_bytes(model) -> int:
    """Bytes of the model's pageable tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(model))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def page_out_model(model) -> int:
    """Move the model's ``params`` and ``state`` to host tensors (pinned
    when they come from the card; the model's earlier pinned copies are
    reused); returns the bytes moved. Waits for the copies."""
    cache = getattr(model, "_paged_host", None) or {}
    moved = 0
    out = {}
    for attr in _PAGEABLE_ATTRS:
        tree = getattr(model, attr, None)
        if tree is None:
            continue
        host_tree = {}
        for ln, layer in tree.items():
            host_layer = {}
            for name, t in layer.items():
                if not torch.is_tensor(t):
                    host_layer[name] = t
                    continue
                h = cache.get((attr, ln, name))
                if (h is None or h.shape != t.shape or h.dtype != t.dtype):
                    h = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                    pin_memory=t.is_cuda)
                h.copy_(t, non_blocking=t.is_cuda)
                host_layer[name] = h
                moved += t.numel() * t.element_size()
            host_tree[ln] = host_layer
        out[attr] = host_tree
    _sync(model.device)
    for attr, tree in out.items():
        setattr(model, attr, tree)
    model._paged_host = {(attr, ln, name): h for attr, tree in out.items()
                         for ln, layer in tree.items()
                         for name, h in layer.items() if torch.is_tensor(h)}
    return moved


def page_in_model(model) -> int:
    """Move the model's ``params`` and ``state`` back onto its device,
    into fresh tensors and fresh dicts; returns the bytes moved. Waits
    for the copies, so the measured fault-in is the real transfer and
    the next forward reads complete weights."""
    moved = 0
    out = {}
    for attr in _PAGEABLE_ATTRS:
        tree = getattr(model, attr, None)
        if tree is None:
            continue
        dev_tree = {}
        for ln, layer in tree.items():
            dev_layer = {}
            for name, h in layer.items():
                if not torch.is_tensor(h):
                    dev_layer[name] = h
                    continue
                t = torch.empty(h.shape, dtype=h.dtype, device=model.device)
                t.copy_(h, non_blocking=h.is_pinned())
                dev_layer[name] = t
                moved += h.numel() * h.element_size()
            dev_tree[ln] = dev_layer
        out[attr] = dev_tree
    _sync(model.device)
    for attr, tree in out.items():
        setattr(model, attr, tree)
    return moved


def weights_on_host(model) -> bool:
    """True when a model of the card holds its pageable tensors on the
    host (``page_out_model`` ran and no page-in since)."""
    if torch.device(model.device).type == "cpu":
        return False
    return any(t.device.type == "cpu" for t in _leaves(model))


def fault_in(model) -> Optional[float]:
    """Page a paged-out model's weights back onto its device; the
    milliseconds it took, or None when they were there (a version held
    outside the registry: the loop's retained snapshot)."""
    if not weights_on_host(model):
        return None
    t0 = time.perf_counter()
    page_in_model(model)
    return (time.perf_counter() - t0) * 1000.0


class ModelEntry:
    """One tenant: current version, admission policy, paging state.
    Residency and LRU fields are guarded by the registry's lock; the
    admission counter has its own."""

    __slots__ = ("name", "current", "quota", "deadline", "pinned",
                 "ladder", "source_path", "resident", "nbytes",
                 "last_used", "executing", "inflight", "_adm_lock")

    def __init__(self, name: str, current: ModelVersion, *,
                 quota: Optional[int] = None,
                 deadline: Optional[float] = None,
                 pinned: bool = False, ladder=None,
                 source_path: Optional[str] = None):
        self.name = name
        self.current = current
        self.quota = quota
        self.deadline = deadline
        self.pinned = pinned
        self.ladder = ladder
        self.source_path = source_path
        self.resident = DEVICE
        self.nbytes = 0
        self.last_used = 0.0
        self.executing = 0   # forwards running now (the evictor skips)
        self.inflight = 0    # admitted, not yet answered (quota bound)
        self._adm_lock = threading.Lock()

    def admit(self) -> bool:
        """Count one request against the quota; False sheds it
        (``quota=None``: only the global bound)."""
        with self._adm_lock:
            if self.quota is not None and self.inflight >= self.quota:
                return False
            self.inflight += 1
            return True

    def exit_admission(self) -> None:
        with self._adm_lock:
            self.inflight -= 1


class ModelRegistry:
    """Name -> ``ModelEntry`` map and the LRU weight-paging policy.

    ``max_device_models`` / ``max_device_bytes`` bound the resident set
    (None: unbounded, nothing pages). Pinned entries never page out.
    Every residency change happens under one lock; ``touch`` /
    ``release`` bracket forwards."""

    def __init__(self, *, max_device_models: Optional[int] = None,
                 max_device_bytes: Optional[int] = None,
                 metrics_registry=None, clock=time.monotonic):
        if max_device_models is not None and max_device_models < 1:
            raise ValueError("max_device_models must be >= 1")
        self.max_device_models = max_device_models
        self.max_device_bytes = max_device_bytes
        self._entries: Dict[str, ModelEntry] = {}
        self._default_name: Optional[str] = None
        self._lock = threading.RLock()
        self._clock = clock
        reg = metrics_registry
        self._pagein_total = reg.counter(
            "weight_pagein_total",
            help="paging: cold-model fault-ins (host -> device)",
        ) if reg is not None else None
        self._evict_total = reg.counter(
            "weight_evict_total",
            help="paging: LRU weight evictions (device -> host)",
        ) if reg is not None else None
        self._pagein_ms = reg.summary(
            "weight_pagein_ms",
            help="paging: measured fault-in transfer latency",
        ) if reg is not None else None
        self._pageout_ms = reg.summary(
            "weight_pageout_ms",
            help="paging: measured eviction transfer latency",
        ) if reg is not None else None
        self._resident_models = reg.gauge(
            "device_resident_models",
            help="paging: models with device-resident weights",
        ) if reg is not None else None
        self._resident_bytes = reg.gauge(
            "device_resident_bytes",
            help="paging: bytes of device-resident weights",
        ) if reg is not None else None
        # bytes moved each way (the fleet's paging traffic)
        self.bytes_paged_in = 0
        self.bytes_paged_out = 0

    # -- membership -----------------------------------------------------

    def add(self, name: str, current: ModelVersion, *,
            quota: Optional[int] = None,
            deadline: Optional[float] = None,
            pinned: bool = False, ladder=None,
            source_path: Optional[str] = None,
            default: bool = False) -> ModelEntry:
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            entry = ModelEntry(name, current, quota=quota,
                               deadline=deadline, pinned=pinned,
                               ladder=ladder, source_path=source_path)
            entry.nbytes = _tree_device_bytes(current.model)
            entry.last_used = self._clock()
            self._entries[name] = entry
            if default or self._default_name is None:
                self._default_name = name
            self._publish_gauges()
            return entry

    def entry(self, name: Optional[str] = None) -> ModelEntry:
        """A tenant by name (None: the default). Raises ``KeyError``
        naming the known tenants."""
        with self._lock:
            if name is None:
                name = self._default_name
            e = self._entries.get(name)
            if e is None:
                raise KeyError(f"unknown model {name!r}; serving "
                               f"{sorted(self._entries)}")
            return e

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    @property
    def default_name(self) -> Optional[str]:
        return self._default_name

    def __len__(self) -> int:
        return len(self._entries)

    def pin(self, name: str, pinned: bool = True) -> None:
        """(Un)pin a tenant; pinning faults its weights in now."""
        with self._lock:
            entry = self.entry(name)
            entry.pinned = pinned
            if pinned:
                self._ensure_resident(entry)
                self._enforce_budget(protect=entry)

    # -- the forward bracket --------------------------------------------

    def touch(self, entry: ModelEntry) -> Optional[float]:
        """Before a forward on ``entry``: bump its LRU time, mark it
        executing and fault its weights in when paged out. Returns the
        fault-in milliseconds (None: it was resident). Pair with
        ``release``."""
        with self._lock:
            entry.last_used = self._clock()
            entry.executing += 1
            try:
                ms = self._ensure_resident(entry)
                if ms is not None:
                    self._enforce_budget(protect=entry)
            except BaseException:
                entry.executing -= 1  # a failed fault-in must not
                raise                 # wedge the entry as executing
            return ms

    def release(self, entry: ModelEntry) -> None:
        with self._lock:
            entry.executing -= 1

    def swap(self, entry: ModelEntry, new_version: ModelVersion) -> None:
        """Hot-reload swap for one tenant; the new weights are on the
        device (restore and warm-up just ran them; the loop's retained
        snapshot is faulted in at its promotion, ``fault_in``)."""
        with self._lock:
            entry.current = new_version
            entry.resident = DEVICE
            entry.nbytes = _tree_device_bytes(new_version.model)
            entry.last_used = self._clock()
            self._enforce_budget(protect=entry)
            self._publish_gauges()

    # -- paging policy (all under self._lock) ---------------------------

    def _ensure_resident(self, entry: ModelEntry) -> Optional[float]:
        if entry.resident == DEVICE:
            return None
        t0 = time.perf_counter()
        self.bytes_paged_in += page_in_model(entry.current.model)
        ms = (time.perf_counter() - t0) * 1000.0
        entry.resident = DEVICE
        if self._pagein_total is not None:
            self._pagein_total.inc()
            self._pagein_ms.observe(ms)
        logger.info("paged model %r in (%d bytes, %.2f ms)", entry.name,
                    entry.nbytes, ms)
        self._publish_gauges()
        return ms

    def _evict(self, entry: ModelEntry) -> None:
        t0 = time.perf_counter()
        self.bytes_paged_out += page_out_model(entry.current.model)
        ms = (time.perf_counter() - t0) * 1000.0
        entry.resident = HOST
        if self._evict_total is not None:
            self._evict_total.inc()
            self._pageout_ms.observe(ms)
        logger.info("evicted model %r to host (%d bytes, %.2f ms)",
                    entry.name, entry.nbytes, ms)

    def _resident_set(self) -> List[ModelEntry]:
        return [e for e in self._entries.values() if e.resident == DEVICE]

    def _over_budget(self) -> bool:
        res = self._resident_set()
        if (self.max_device_models is not None
                and len(res) > self.max_device_models):
            return True
        return (self.max_device_bytes is not None
                and sum(e.nbytes for e in res) > self.max_device_bytes)

    def _enforce_budget(self, protect: Optional[ModelEntry] = None) -> int:
        """Evict least recently used unpinned idle entries until the
        resident set fits; returns the evictions. Stops over budget
        (logged) when every candidate is pinned, executing or
        protected: never a forward on half-paged weights."""
        evicted = 0
        while self._over_budget():
            victims = [e for e in self._resident_set()
                       if not e.pinned and e.executing == 0
                       and e is not protect]
            if not victims:
                logger.warning("weight paging over budget but every "
                               "resident model is pinned or executing; "
                               "not evicting")
                break
            self._evict(min(victims, key=lambda e: e.last_used))
            evicted += 1
        if evicted:
            self._publish_gauges()
        return evicted

    def enforce_budget(self) -> int:
        """Page out the over-budget tail (after ``start()``'s warm-up,
        which runs every tenant once on the device)."""
        with self._lock:
            return self._enforce_budget()

    def _publish_gauges(self) -> None:
        if self._resident_models is None:
            return
        res = self._resident_set()
        self._resident_models.set(len(res))
        self._resident_bytes.set(sum(e.nbytes for e in res))

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        """The ``/metrics`` paging block and the per-tenant states."""
        with self._lock:
            res = self._resident_set()
            now = self._clock()
            return {
                "max_device_models": self.max_device_models,
                "max_device_bytes": self.max_device_bytes,
                "device_resident_models": len(res),
                "device_resident_bytes": sum(e.nbytes for e in res),
                "weight_pagein_total": (self._pagein_total.value
                                        if self._pagein_total is not None
                                        else 0),
                "weight_evict_total": (self._evict_total.value
                                       if self._evict_total is not None
                                       else 0),
                "weight_pagein_ms": (self._pagein_ms.snapshot()
                                     if self._pagein_ms is not None
                                     else None),
                "weight_pageout_ms": (self._pageout_ms.snapshot()
                                      if self._pageout_ms is not None
                                      else None),
                "bytes_paged_in": self.bytes_paged_in,
                "bytes_paged_out": self.bytes_paged_out,
                "models": {
                    e.name: {
                        "version": e.current.version,
                        "resident": e.resident,
                        "nbytes": e.nbytes,
                        "pinned": e.pinned,
                        "quota": e.quota,
                        "deadline": e.deadline,
                        "inflight": e.inflight,
                        "idle_s": round(max(now - e.last_used, 0.0), 3),
                    }
                    for e in self._entries.values()
                },
            }

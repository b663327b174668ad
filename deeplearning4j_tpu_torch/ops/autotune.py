"""Measured plan search with a persistent on-disk tuning cache.

Counterpart of ``deeplearning4j_tpu/ops/autotune.py``, with the same
contract: per (kernel, identity) the tuner takes the feasible plans of
``ops/tiling.py`` (the module the route heuristics' plans and
feasibility come from, so search and heuristic never disagree about
what fits), ranks them by the family's cost prior, measures the
heuristic and the top ``_TOP_K`` by interleaved best-of-N under a time
budget, and persists the winner, with every candidate's time, as one
atomic JSON entry.

Modes (``DL4J_TPU_TUNE``, read once per process with
``DL4J_TPU_TUNE_BUDGET_MS`` and ``DL4J_TPU_TUNE_CACHE_DIR``, re-read
only through ``reset_for_tests()``, which ``ops.dispatch
.reset_for_tests()`` calls):

* ``off``: the route heuristics; this module is never consulted.
* ``cached`` (the default): persisted winners are used, nothing is
  measured; any miss (absent, corrupt, stale fingerprint, a plan no
  longer feasible) falls back to the heuristic and is counted in
  ``tuner_fallback_total``. With no cache directory there is nothing to
  look up: every plan is the heuristic's, decided at each launch as
  before the tuner, with no memo and no count.
* ``on``: a miss is measured under the budget, and the winner persisted
  when a cache directory is set.

An entry is refused as stale, never applied, when its fingerprint
differs from this process's: torch's version, ``torch.version.cuda``,
the card's name and compute capability, the kernel library's digest
(``_build._digest``: its sources and flags) or the entry format. The
heuristic is always among the plans measured, so a persisted winner is
never slower than the heuristic as measured.

Where the port differs from the JAX module:

- **Time on the device clock.** A candidate's calls are timed with CUDA
  events on the current stream (``cuda_event_ms``), never with
  ``perf_counter``: a launch returns before the card has run it. The
  budget is wall time on the host.
- **A candidate that fails to launch raises**, naming its plan. The JAX
  module drops it through its ``_FAILED`` sentinel; on a card a fault
  can leave the context unusable, and dropping the plan would hide a
  kernel bug. ``tiling``'s feasibility is the only filter.
- **No measurement inside a CUDA-graph capture.** Plans resolve in the
  eager warm-up before a capture, and the capture reads them from the
  per-process memo; a miss in ``on`` mode while
  ``torch.cuda.is_current_stream_capturing()`` raises, naming the
  kernel and the shape.
- **No ``+tuned`` kind suffix.** The JAX suffix exists because its AOT
  executables embed block configurations; the port's AOT records carry
  shapes and the library, no plan (``compile/aot.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from deeplearning4j_tpu_torch.ops.tiling import plan_tag

_TUNE_FORMAT = 1
_MODES = ("off", "cached", "on")
_DEFAULT_BUDGET_MS = 2000.0
_TOP_K = 4
_MEASURE_ROUNDS = 3  # interleaved best-of-N: N rounds over candidates
_MEASURE_INNER = 4   # timed calls per (candidate, round)

Plan = Tuple
Candidates = Union[Sequence[Plan], Callable[[], Sequence[Plan]]]
Heuristic = Union[Plan, Callable[[], Plan]]

_LOCK = threading.RLock()
# (mode, cache_dir or None, budget_ms): read once per process
_ENV: Optional[Tuple[str, Optional[str], float]] = None
# (kernel, identity items) -> chosen plan: the per-process memo
_RESOLVED: Dict[Tuple, Plan] = {}
_ENVIRONMENT: Optional[Dict[str, Any]] = None


# --- env knobs (read once) ----------------------------------------------------


def _env() -> Tuple[str, Optional[str], float]:
    global _ENV
    if _ENV is None:
        mode = os.environ.get("DL4J_TPU_TUNE", "cached").strip().lower()
        if mode not in _MODES:
            mode = "cached"
        cache = os.environ.get("DL4J_TPU_TUNE_CACHE_DIR", "").strip()
        try:
            budget = float(os.environ.get("DL4J_TPU_TUNE_BUDGET_MS",
                                          _DEFAULT_BUDGET_MS))
        except ValueError:
            budget = _DEFAULT_BUDGET_MS
        _ENV = (mode, cache or None, budget)
    return _ENV


def tuning_mode() -> str:
    """``off`` | ``cached`` | ``on`` (DL4J_TPU_TUNE, default cached)."""
    return _env()[0]


def cache_dir() -> Optional[str]:
    return _env()[1]


def measure_budget_ms() -> float:
    return _env()[2]


def reset_for_tests() -> None:
    """Drop the env reads, the resolution memo and the fingerprint, so
    the next launch re-reads ``DL4J_TPU_TUNE*`` and the cache."""
    global _ENV, _ENVIRONMENT
    with _LOCK:
        _ENV = None
        _ENVIRONMENT = None
        _RESOLVED.clear()


def resolved() -> Dict[Tuple, Plan]:
    """The plans this process has resolved, by (kernel, identity
    items)."""
    with _LOCK:
        return dict(_RESOLVED)


# --- observability ------------------------------------------------------------

_METRICS_FOR = None


def _tuner_metrics():
    global _METRICS_FOR
    from deeplearning4j_tpu_torch.observability.metrics import (
        default_registry,
    )

    reg = default_registry()
    if _METRICS_FOR is None or _METRICS_FOR[0] is not reg:
        searches = reg.counter(
            "tuner_searches_total",
            help="measured tuning searches run (mode=on misses)",
            labels=("kernel",))
        hits = reg.counter(
            "tuner_cache_hits_total",
            help="kernel plans resolved from a persisted tuning entry",
            labels=("kernel",))
        fallback = reg.counter(
            "tuner_fallback_total",
            help="tuning-cache misses resolved to the route heuristic, by "
                 "reason (absent/corrupt/stale/invalid)",
            labels=("kernel", "reason"))
        measure_ms = reg.histogram(
            "tuner_measure_ms",
            buckets=(0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0,
                     300.0),
            help="device time of one call of a candidate, best of a "
                 "round (ms)")
        block_cfg = reg.gauge(
            "kernel_block_config",
            help="info gauge: 1 for the plan each kernel shape launches "
                 "(the heuristic's or a tuned winner)",
            labels=("kernel", "config"))
        _METRICS_FOR = (reg, searches, hits, fallback, measure_ms,
                        block_cfg)
    return _METRICS_FOR[1:]


# --- cache identity and IO ----------------------------------------------------


def environment() -> Dict[str, Any]:
    """What an entry was measured under: torch and CUDA versions, the
    card's name and compute capability (None on a machine without a
    card), the kernel library's digest, the entry format."""
    global _ENVIRONMENT
    with _LOCK:
        if _ENVIRONMENT is not None:
            return dict(_ENVIRONMENT)
    from deeplearning4j_tpu_torch.ops import _build

    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        device = torch.cuda.get_device_name(dev)
        capability = list(torch.cuda.get_device_capability(dev))
    else:
        device, capability = "none", None
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": device, "capability": capability,
           "library": _build._digest(), "format": _TUNE_FORMAT}
    with _LOCK:
        _ENVIRONMENT = env
    return dict(env)


def fingerprint(kernel: str) -> Dict[str, Any]:
    """An entry's fingerprint: the kernel's kind and ``environment()``.
    An entry whose fingerprint differs is refused as stale."""
    return {"kind": f"tune:{kernel}", **environment()}


def _name_digest(kernel: str, identity: Dict[str, Any]) -> str:
    # the file name keys on the kernel and the shape alone, so a stale
    # entry sits where a fresh one would and is found and refused
    doc = json.dumps({"kernel": kernel, "identity": identity},
                     sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()[:32]


def entry_path(kernel: str, identity: Dict[str, Any]) -> Optional[str]:
    """Where the entry of (kernel, identity) lives, or None without a
    cache directory."""
    d = cache_dir()
    if not d:
        return None
    return os.path.join(d, f"{kernel}-{_name_digest(kernel, identity)}.json")


def _persist(path: str, doc: Dict[str, Any]) -> None:
    """Atomic write: a temporary file in the destination directory, then
    ``os.replace``, so a reader sees a whole entry or none. Best effort,
    as in the JAX module: a directory that cannot be written leaves the
    winner in this process's memo only."""
    d = os.path.dirname(path)
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    except OSError:
        return
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _as_plan(cfg) -> Optional[Plan]:
    """A persisted plan as a tuple, or None where it is malformed: a
    route name, then ints."""
    if (not isinstance(cfg, (list, tuple)) or not cfg
            or not isinstance(cfg[0], str)
            or not all(isinstance(v, int) and not isinstance(v, bool)
                       for v in cfg[1:])):
        return None
    return tuple(cfg)


def _load_entry(kernel: str, path: Optional[str],
                candidates: Sequence[Plan]) -> Tuple[Optional[Plan], str]:
    """(plan, reason): the plan is None unless the reason is ``hit``.
    Reasons: absent / corrupt / stale / invalid (a persisted plan no
    longer among the candidates)."""
    if path is None or not os.path.exists(path):
        return None, "absent"
    try:
        with open(path, "r") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None, "corrupt"
    if not isinstance(doc, dict):
        return None, "corrupt"
    if (doc.get("format") != _TUNE_FORMAT
            or doc.get("fingerprint") != fingerprint(kernel)
            or doc.get("kernel") != kernel):
        return None, "stale"
    plan = _as_plan(doc.get("config"))
    if plan is None:
        return None, "corrupt"
    if plan not in set(candidates):
        return None, "invalid"
    return plan, "hit"


def read_entry(kernel: str,
               identity: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The persisted entry of (kernel, identity), or None."""
    path = entry_path(kernel, identity)
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path, "r") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


# --- measurement --------------------------------------------------------------


def cuda_event_ms(fn: Callable[[], Any], calls: int) -> float:
    """Device ms a call of ``fn``: ``calls`` calls between two CUDA
    events on the current stream, waited for."""
    stream = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(calls):
        fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / calls


def _failed(kernel: str, plan: Plan, identity, err: Exception):
    return RuntimeError(f"autotune: {kernel} plan {plan_tag(plan)} failed "
                        f"at {identity}: {err}")


def _measure_candidates(kernel: str, identity: Dict[str, Any],
                        plans: Sequence[Plan],
                        measure_factory: Callable[[Plan],
                                                  Callable[[], Any]],
                        budget_ms: float,
                        timer: Callable[[Callable[[], Any], int], float],
                        ) -> Dict[Plan, float]:
    """Interleaved best-of-N: N rounds over the plans (so drift hits
    every plan alike), each plan's best round kept. The first plan (the
    heuristic) is measured whatever the budget; once the budget is
    spent, plans without a round are left out. A plan that fails to
    build or launch raises."""
    (_, _, _, measure_ms, _) = _tuner_metrics()
    fns: Dict[Plan, Callable[[], Any]] = {}
    best: Dict[Plan, float] = {}
    start = time.perf_counter()
    for rnd in range(_MEASURE_ROUNDS):
        for idx, plan in enumerate(plans):
            if (rnd or idx) and (time.perf_counter() - start) * 1e3 \
                    > budget_ms:
                return best
            try:
                fn = fns.get(plan)
                if fn is None:
                    fn = fns[plan] = measure_factory(plan)
                    timer(fn, 1)  # warm-up: first-launch set-up untimed
                ms = timer(fn, _MEASURE_INNER)
            except Exception as e:  # a kernel fault: name the plan
                raise _failed(kernel, plan, identity, e) from e
            measure_ms.observe(ms)
            if plan not in best or ms < best[plan]:
                best[plan] = ms
    return best


def _search(kernel: str, identity: Dict[str, Any], heuristic: Plan,
            candidates: Sequence[Plan],
            cost_fn: Optional[Callable[[Plan], float]],
            measure_factory: Callable[[Plan], Callable[[], Any]],
            timer) -> Plan:
    """Rank by the prior, measure the heuristic and the top K, persist
    the winner with every plan's time."""
    (searches, _, _, _, _) = _tuner_metrics()
    searches.labels(kernel=kernel).inc()
    ranked = list(candidates)
    if cost_fn is not None:
        ranked.sort(key=cost_fn)
    short = [p for p in ranked if p != heuristic][:_TOP_K]
    short.insert(0, heuristic)  # measured first, budget-exempt
    timings = _measure_candidates(kernel, identity, short, measure_factory,
                                  measure_budget_ms(), timer)
    winner = min(timings, key=lambda p: timings[p])
    path = entry_path(kernel, identity)
    if path is not None:
        _persist(path, {
            "format": _TUNE_FORMAT,
            "fingerprint": fingerprint(kernel),
            "kernel": kernel,
            "identity": identity,
            "config": list(winner),
            "heuristic": list(heuristic),
            "best_ms": timings[winner],
            "measured": len(timings),
            "timings_ms": {plan_tag(p): t for p, t in timings.items()},
        })
    return winner


# --- the entry point ------------------------------------------------------------


def resolve(kernel: str, identity: Dict[str, Any], heuristic: Heuristic,
            candidates: Candidates,
            cost_fn: Optional[Callable[[Plan], float]] = None,
            measure_factory: Optional[
                Callable[[Plan], Callable[[], Any]]] = None,
            timer: Optional[Callable[[Callable[[], Any], int],
                                     float]] = None) -> Plan:
    """The plan one launch of ``kernel`` at ``identity`` (its shape and
    dtype, JSON values) should use.

    ``heuristic`` is the route function's plan and ``candidates`` the
    feasible set from ``ops/tiling.py`` (either may be a callable giving
    it, called only on a memo miss: a launch that hits the memo builds
    neither); an entry outside the candidates is refused. ``identity``
    keeps one key order per kernel (the memo keys on its items).
    ``measure_factory(plan)`` returns a zero-argument callable that
    launches the kernel with ``plan`` (only called in mode ``on``);
    ``timer(fn, calls)`` gives a call's ms (default ``cuda_event_ms``).
    Resolutions are kept per process; ``reset_for_tests()`` clears
    them."""
    mode, directory, _ = _env()
    if mode == "off" or (mode == "cached" and directory is None):
        # nothing to look up: the route functions decide at each launch
        # (a test that patches one sees its plan)
        return heuristic() if callable(heuristic) else tuple(heuristic)
    key = (kernel, tuple(identity.items()))
    with _LOCK:
        got = _RESOLVED.get(key)
    if got is not None:
        return got
    heuristic = heuristic() if callable(heuristic) else tuple(heuristic)
    (_, hits, fallback, _, block_cfg) = _tuner_metrics()
    cands = [tuple(c) for c in (candidates() if callable(candidates)
                                else candidates)]
    plan, reason = _load_entry(kernel, entry_path(kernel, identity), cands)
    if plan is not None:
        hits.labels(kernel=kernel).inc()
        chosen = plan
    elif mode == "cached" or measure_factory is None:
        fallback.labels(kernel=kernel, reason=reason).inc()
        chosen = heuristic
    else:
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"autotune: {kernel} at {identity} would be measured "
                "inside a CUDA-graph capture; run the shape once eagerly "
                "before capturing it")
        if reason != "absent":
            # a refused entry: count it, then measure and overwrite
            fallback.labels(kernel=kernel, reason=reason).inc()
        chosen = _search(kernel, identity, heuristic, cands, cost_fn,
                         measure_factory, timer or cuda_event_ms)
    block_cfg.labels(kernel=kernel, config=plan_tag(chosen)).set(1.0)
    with _LOCK:
        _RESOLVED[key] = chosen
    return chosen

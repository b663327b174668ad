"""Tier 1: the persistent cache of built kernel libraries.

Counterpart of ``deeplearning4j_tpu/compile/persistent.py``. The JAX
package's compile-time cost is XLA compilation, cached on disk by JAX.
The port's is the ``nvcc`` build of ``csrc/`` into one shared library
(``ops/_build.py``), named by a digest of the sources and flags, so a
directory of such libraries is the port's persistent cache:

- **one knob**: ``enable_persistent_cache(directory=None)`` resolves
  the argument, then ``DL4J_TPU_COMPILE_CACHE_DIR`` (``off`` / ``0`` /
  empty: no directory of its own), then the package's git-ignored
  ``build/``, creates it, and points ``_build.build()`` / ``load()`` at
  it: they look the library up there by its digest name and build
  into it only on a miss;
- **size bounding**: ``bound_cache_size`` prunes the least recently
  used libraries (file mtime; a hit touches it) down to
  ``DL4J_TPU_COMPILE_CACHE_MAX_BYTES`` (default 2 GiB), never the
  library this process loaded;
- **accounting**: ``cache_stats()`` counts hits (a library found),
  misses (a build) and build seconds, mirrored into
  ``compile_cache_hits_total`` / ``compile_cache_misses_total`` /
  ``xla_backend_compiles_total`` / ``xla_backend_compile_seconds_total``
  on every registry handed to ``install_cache_accounting``, each lookup
  also an ``xla.compile.cache`` trace event and a flight-recorder event.

A build that fails still raises (``_build.build``): without the
library no kernel runs, and nothing falls back to the plain path.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

ENV_CACHE_DIR = _build.ENV_CACHE_DIR
ENV_CACHE_MAX_BYTES = "DL4J_TPU_COMPILE_CACHE_MAX_BYTES"
DEFAULT_MAX_BYTES = 2 << 30  # 2 GiB


class _CacheStats:
    """Process-wide lookup accounting (monotonic counters)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.build_seconds = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "backend_compiles": self.misses,
                    "compile_seconds": round(self.build_seconds, 3)}


_stats = _CacheStats()
_lock = threading.Lock()
_registry_sinks: List[Dict] = []


def cache_stats() -> dict:
    """Process-wide stats: hits, misses, backend_compiles (the nvcc
    builds, = misses) and compile_seconds (their wall seconds)."""
    return _stats.snapshot()


def default_cache_dir() -> Optional[str]:
    """``DL4J_TPU_COMPILE_CACHE_DIR`` when it names a directory, else
    None."""
    return _build.env_cache_dir()


def _on_lookup(outcome: str, path, seconds: float) -> None:
    """``_build``'s listener: one library lookup."""
    from deeplearning4j_tpu_torch.observability import flightrec
    from deeplearning4j_tpu_torch.observability.trace import get_tracer

    try:
        with _stats._lock:
            if outcome == "hit":
                _stats.hits += 1
            else:
                _stats.misses += 1
                _stats.build_seconds += seconds
        for sink in list(_registry_sinks):
            if outcome == "hit":
                sink["hits"].inc()
            else:
                sink["misses"].inc()
                sink["compiles"].inc()
                sink["compile_seconds"].inc(seconds)
        attrs = {"library": os.path.basename(str(path))}
        if outcome == "miss":
            attrs["seconds"] = round(seconds, 4)
        get_tracer().event("xla.compile.cache",
                           attrs={"outcome": outcome, **attrs})
        flightrec.record_event("xla_compile_cache", outcome=outcome,
                               **attrs)
    except Exception:  # accounting must never take down a build
        logger.exception("compile-cache accounting failed")


def install_cache_accounting(registry=None) -> None:
    """Mirror lookups into ``registry`` (default: the process-wide
    observability registry). Idempotent per registry."""
    from deeplearning4j_tpu_torch.observability.metrics import (
        default_registry,
    )

    reg = registry if registry is not None else default_registry()
    with _lock:
        _build.add_listener(_on_lookup)
        if any(s["registry"] is reg for s in _registry_sinks):
            return
        _registry_sinks.append({
            "registry": reg,
            "hits": reg.counter(
                "compile_cache_hits_total",
                help="kernel-library cache: the nvcc build of the kernel "
                     "library found on disk instead of run")._default(),
            "misses": reg.counter(
                "compile_cache_misses_total",
                help="kernel-library cache: the nvcc build of the kernel "
                     "library run and written to disk")._default(),
            "compiles": reg.counter(
                "xla_backend_compiles_total",
                help="nvcc builds of the kernel library this process "
                     "ran")._default(),
            "compile_seconds": reg.counter(
                "xla_backend_compile_seconds_total",
                help="wall seconds inside the nvcc build of the kernel "
                     "library")._default(),
        })


def _is_library(name: str) -> bool:
    return name.startswith(_build.LIB_PREFIX) and name.endswith(".so")


def bound_cache_size(directory, max_bytes: int) -> int:
    """Prune the kernel libraries in ``directory`` to ``max_bytes``,
    least recently used first (mtime order), never the library this
    process loaded. Returns bytes removed; never raises (a sibling
    process may prune the same directory)."""
    keep = _build.loaded_path
    keep = os.path.abspath(keep) if keep is not None else None
    try:
        entries = []
        with os.scandir(os.fspath(directory)) as it:
            for e in it:
                if not (e.is_file(follow_symlinks=False)
                        and _is_library(e.name)):
                    continue
                st = e.stat(follow_symlinks=False)
                entries.append((st.st_mtime, st.st_size, e.path))
    except OSError:
        return 0
    total = sum(size for _, size, _ in entries)
    if total <= max_bytes:
        return 0
    removed = 0
    for _, size, path in sorted(entries):
        if total - removed <= max_bytes:
            break
        if os.path.abspath(path) == keep:
            continue
        try:
            os.unlink(path)
            removed += size
        except OSError:
            pass  # a sibling process got there first
    if removed:
        logger.info("kernel-library cache %s pruned %.1f MiB (bound "
                    "%.1f MiB)", directory, removed / 2**20,
                    max_bytes / 2**20)
    return removed


def resolve_cache_dir(directory=None) -> Optional[str]:
    """The argument, else ``DL4J_TPU_COMPILE_CACHE_DIR`` (None when it
    says off), else the package's ``build/``."""
    if directory is not None:
        return os.fspath(directory)
    env = os.environ.get(ENV_CACHE_DIR)
    if env is not None:
        return default_cache_dir()
    return os.fspath(_build.BUILD_DIR)


def enable_persistent_cache(directory: Optional[str] = None, *,
                            registry=None,
                            max_bytes: Optional[int] = None
                            ) -> Optional[str]:
    """Point the kernel build at the cache directory
    (``resolve_cache_dir``), creating it, bounding its size and
    installing the accounting on ``registry``. Returns the directory, or
    None when the knob says off (the build then uses ``build/``). Never
    raises: a cache problem costs a build, not the process."""
    d = resolve_cache_dir(directory)
    if d is None:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        prev = _build._cache_dir
        if prev is not None and os.path.abspath(prev) != os.path.abspath(d):
            logger.info("re-pointing the kernel-library cache: %s -> %s",
                        prev, d)
        _build.set_cache_dir(d)
        install_cache_accounting(registry)
        if max_bytes is None:
            max_bytes = int(os.environ.get(ENV_CACHE_MAX_BYTES,
                                           DEFAULT_MAX_BYTES))
        if max_bytes > 0:
            bound_cache_size(d, max_bytes)
        return d
    except Exception:
        logger.exception("kernel-library cache setup failed; building "
                         "into the default directory")
        return None

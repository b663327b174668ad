"""Tier 2: the AOT serving bundle, carried in a checkpoint.

Counterpart of ``deeplearning4j_tpu/compile/aot.py``. The JAX package
serializes one compiled XLA executable per serving bucket; the port
compiles no program per shape, and what a fresh host pays before its
first request is the ``nvcc`` build of the kernel library. So the
port's bundle carries that library:

- ``aot-kernel-library`` (``LIBRARY_ARTIFACT``): the built library's
  bytes (format ``"cuda-kernel-library"``), once a bundle, fingerprinted
  by the kernel-source digest (``_build._digest``), the arch, and the
  torch and CUDA versions;
- ``aot-output-b<N>``: one a bucket, the fingerprint and the shape only
  (format ``"shape-record"``): the shapes the server preloads into its
  ``ModelShapes``, as the JAX server does for installed executables.

``install_serving_bundle`` checks each fingerprint, checks that the
library's digest is this checkout's, and writes the library atomically
into the cache directory (``compile/persistent.py``) under its digest
name when it is absent; the first kernel launch then loads it with no
build. The library is still this checkout's sources: a stale,
truncated or foreign artifact counts ``aot_fallback_total`` and is
skipped, and the kernels are then built with ``nvcc`` as without a
bundle. Nothing here is an error on the request path, and nothing skips
the kernels.

The framing is the JAX package's byte for byte: ``MAGIC | meta-length
(<I) | meta-JSON (sorted keys) | blob`` (``pack_artifact``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

MAGIC = b"DL4JAOT1"
FORMAT_LIBRARY = "cuda-kernel-library"
FORMAT_SHAPES = "shape-record"

ARTIFACT_OUTPUT_PREFIX = "aot-output-b"  # + bucket rows
LIBRARY_ARTIFACT = "aot-kernel-library"


class AotArtifactError(ValueError):
    """The bytes are not a usable AOT artifact (bad magic, truncated
    framing, undecodable meta). Loaders catch it and fall back."""


# -- metrics ------------------------------------------------------------

_reg_lock = threading.Lock()
_instrument_cache: Dict[int, dict] = {}


def _instruments(registry=None) -> dict:
    """The aot_* instruments on ``registry`` (default: the process
    registry)."""
    from deeplearning4j_tpu_torch.observability.metrics import (
        default_registry,
    )

    reg = registry if registry is not None else default_registry()
    with _reg_lock:
        inst = _instrument_cache.get(id(reg))
        if inst is not None and inst["registry"] is reg:
            return inst
        inst = {
            "registry": reg,
            "export_ms": reg.summary(
                "aot_export_ms",
                help="time to pack one AOT artifact")._default(),
            "load_ms": reg.summary(
                "aot_load_ms",
                help="time to check and install one AOT "
                     "artifact")._default(),
            "installed": reg.counter(
                "aot_installed_total",
                help="AOT artifacts installed (fingerprint "
                     "matched)")._default(),
            "fallback": reg.counter(
                "aot_fallback_total",
                help="AOT artifacts skipped (missing/stale/corrupt): the "
                     "kernels then build with nvcc as without a "
                     "bundle")._default(),
        }
        _instrument_cache[id(reg)] = inst
        return inst


def _trace_event(outcome: str, **attrs) -> None:
    from deeplearning4j_tpu_torch.observability.trace import get_tracer

    get_tracer().event("xla.compile.aot",
                       attrs={"outcome": outcome, **attrs})


def _versions() -> dict:
    import torch

    return {"backend": _build.ARCH_TAG, "torch": torch.__version__,
            "cuda": str(torch.version.cuda), "digest": _build._digest()}


# -- fingerprint --------------------------------------------------------


def _shape_key_to_list(shape):
    """Shape keys are a tuple of ints (one array) or a tuple of such
    tuples (multi-input graphs); normalize to JSON-able lists."""
    shape = tuple(shape)
    if shape and isinstance(shape[0], (tuple, list)):
        return [[int(d) for d in s] for s in shape]
    return [int(d) for d in shape]


def shape_key(shape) -> tuple:
    """Canonical hashable form of a shape key (ints, tuples)."""
    shape = tuple(shape)
    if shape and isinstance(shape[0], (tuple, list)):
        return tuple(tuple(int(d) for d in s) for s in shape)
    return tuple(int(d) for d in shape)


def artifact_fingerprint(conf, shape, dtype: str, kind: str,
                         backend: Optional[str] = None,
                         extra: str = "") -> str:
    """Hex digest over everything that must match for an artifact to
    be valid here: the model configuration's canonical JSON, the input
    shape and dtype, the entry-point kind (``output`` / ``step`` with
    its suffixes), the arch the library is built for, the torch and
    CUDA versions, and the kernel-source digest."""
    v = _versions()
    conf_json = (conf if isinstance(conf, str)
                 else json.dumps(conf, sort_keys=True, default=str))
    doc = json.dumps({
        "conf": conf_json,
        "shape": _shape_key_to_list(shape),
        "dtype": str(dtype),
        "kind": kind,
        "backend": str(backend if backend is not None else v["backend"]),
        "torch": v["torch"],
        "cuda": v["cuda"],
        "digest": v["digest"],
        "extra": extra,
    }, sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()[:32]


def library_fingerprint(digest: Optional[str] = None) -> str:
    """The library artifact's fingerprint: digest, arch, torch, CUDA."""
    v = _versions()
    doc = json.dumps({"digest": digest or v["digest"],
                      "backend": v["backend"], "torch": v["torch"],
                      "cuda": v["cuda"]}, sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()[:32]


# -- framing ------------------------------------------------------------


def pack_artifact(meta: dict, blob: bytes) -> bytes:
    head = json.dumps(meta, sort_keys=True).encode()
    return MAGIC + struct.pack("<I", len(head)) + head + blob


def unpack_artifact(data: bytes) -> Tuple[dict, bytes]:
    if not isinstance(data, (bytes, bytearray)):
        raise AotArtifactError("artifact is not bytes")
    if len(data) < len(MAGIC) + 4 or data[:len(MAGIC)] != MAGIC:
        raise AotArtifactError("bad artifact magic")
    (n,) = struct.unpack_from("<I", data, len(MAGIC))
    start = len(MAGIC) + 4
    if start + n > len(data):
        raise AotArtifactError("truncated artifact meta")
    try:
        meta = json.loads(bytes(data[start:start + n]))
    except ValueError as e:
        raise AotArtifactError(f"undecodable artifact meta: {e}")
    if not isinstance(meta, dict):
        raise AotArtifactError("artifact meta is not an object")
    return meta, bytes(data[start + n:])


def peek_meta(data: bytes) -> dict:
    """Artifact meta without touching the payload."""
    return unpack_artifact(data)[0]


# -- export / load ------------------------------------------------------


def export_artifact(*, fingerprint: str, shape, kind: str, name: str = "",
                    meta_extra: Optional[dict] = None,
                    registry=None) -> bytes:
    """A shape record: the fingerprint, kind and shape of one entry
    point, no payload (the port builds no program per shape)."""
    t0 = time.perf_counter()
    meta = {"format": FORMAT_SHAPES, "fingerprint": fingerprint,
            "kind": kind, "name": name,
            "shape": _shape_key_to_list(shape), **_versions()}
    if meta_extra:
        meta.update(meta_extra)
    data = pack_artifact(meta, b"")
    ms = (time.perf_counter() - t0) * 1000.0
    _instruments(registry)["export_ms"].observe(ms)
    _trace_event("export", kind=kind, name=name, format=FORMAT_SHAPES)
    return data


def _fallback(inst, reason: str, name: str, detail: str) -> None:
    inst["fallback"].inc()
    _trace_event("fallback", reason=reason, name=name)
    logger.warning("AOT artifact %r unusable (%s: %s); the kernels build "
                   "as without a bundle", name, reason, detail)


def _checked(data, expected_fingerprint: str, expected_format: str,
             inst) -> Optional[Tuple[dict, bytes]]:
    try:
        meta, blob = unpack_artifact(data)
    except AotArtifactError as e:
        _fallback(inst, "corrupt", "?", str(e))
        return None
    name = str(meta.get("name", "?"))
    if meta.get("fingerprint") != expected_fingerprint:
        _fallback(inst, "stale", name,
                  f"fingerprint {meta.get('fingerprint')} != "
                  f"{expected_fingerprint}")
        return None
    if meta.get("format") != expected_format:
        _fallback(inst, "load_failed", name,
                  f"format {meta.get('format')!r}")
        return None
    return meta, blob


def _installed(inst, meta: dict, t0: float) -> None:
    inst["load_ms"].observe((time.perf_counter() - t0) * 1000.0)
    inst["installed"].inc()
    _trace_event("load", kind=meta.get("kind", "?"),
                 name=str(meta.get("name", "?")),
                 format=meta.get("format"))


def load_artifact(data: bytes, *, expected_fingerprint: str,
                  expected_format: str = FORMAT_SHAPES,
                  registry=None) -> Optional[Tuple[dict, bytes]]:
    """``(meta, blob)`` of a usable artifact, or None: wrong magic,
    truncated, a stale fingerprint (another model, shape, kind, torch,
    CUDA or kernel source) or another format. Every None counts
    ``aot_fallback_total``; nothing raises."""
    inst = _instruments(registry)
    t0 = time.perf_counter()
    got = _checked(data, expected_fingerprint, expected_format, inst)
    if got is not None:
        _installed(inst, got[0], t0)
    return got


# -- the kernel library -------------------------------------------------


def _library_path() -> Path:
    """The library this process runs (built or found at the first
    call)."""
    _build.load()
    return _build.loaded_path


def export_library(registry=None) -> bytes:
    """The built kernel library as an artifact."""
    t0 = time.perf_counter()
    path = Path(_library_path())
    blob = path.read_bytes()
    digest = _build._digest()
    meta = {"format": FORMAT_LIBRARY, "kind": "kernel-library",
            "name": LIBRARY_ARTIFACT,
            "fingerprint": library_fingerprint(digest),
            "library": _build.library_name(digest),
            "sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob), **_versions()}
    data = pack_artifact(meta, blob)
    _instruments(registry)["export_ms"].observe(
        (time.perf_counter() - t0) * 1000.0)
    _trace_event("export", kind="kernel-library", name=LIBRARY_ARTIFACT,
                 format=FORMAT_LIBRARY)
    return data


def install_library(data: bytes, registry=None) -> Optional[Path]:
    """Write the bundled library into the cache directory under its
    digest name (atomically, when absent) and return its path; None,
    counted in ``aot_fallback_total``, when the artifact is stale,
    corrupt or built from other sources than this checkout's."""
    inst = _instruments(registry)
    t0 = time.perf_counter()
    got = _checked(data, library_fingerprint(), FORMAT_LIBRARY, inst)
    if got is None:
        return None
    meta, blob = got
    if (meta.get("digest") != _build._digest()
            or hashlib.sha256(blob).hexdigest() != meta.get("sha256")):
        _fallback(inst, "stale", LIBRARY_ARTIFACT,
                  "digest or payload does not match this checkout")
        return None
    directory = _build.cache_dir()
    path = directory / _build.library_name()
    if not path.exists():
        directory.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, path)
    _installed(inst, meta, t0)
    return path


# -- the train-step wrapper ---------------------------------------------


class AotStepFunction:
    """Stands in for an engine's step once ``aot_install_step`` took an
    artifact: the same step (the port builds no program per shape),
    carrying the shapes and the kind the artifact was checked for. An
    artifact of another step kind never gets here: its fingerprint
    differs and the install refuses it."""

    def __init__(self, step, x_shape, y_shape, kind: str):
        self._step = step
        self.x_shape = shape_key(x_shape)
        self.y_shape = shape_key(y_shape)
        self.kind = kind

    def __call__(self, *args, **kwargs):
        return self._step(*args, **kwargs)


# -- serving bundle -----------------------------------------------------


def serving_bucket_name(bucket: int) -> str:
    return f"{ARTIFACT_OUTPUT_PREFIX}{int(bucket)}"


def export_serving_bundle(model, buckets: Sequence[int],
                          feature_shape: Optional[Sequence[int]] = None,
                          registry=None) -> Dict[str, bytes]:
    """``{artifact name: bytes}`` for ``CheckpointManager.save(model,
    artifacts=...)``: the kernel library once, and one shape record a
    ladder bucket. The per-row feature shape is the model's flat input
    width (``feature_shape`` overrides it)."""
    if feature_shape is None:
        from deeplearning4j_tpu_torch.serving.server import feature_dim

        n_in = feature_dim(model)
        if n_in is None:
            raise ValueError(
                "model declares no input width; pass feature_shape=")
        feature_shape = (n_in,)
    out: Dict[str, bytes] = {LIBRARY_ARTIFACT: export_library(registry)}
    for b in buckets:
        shape = (int(b),) + tuple(int(d) for d in feature_shape)
        out[serving_bucket_name(b)] = model.aot_export_output(
            shape, registry=registry)
    return out


def install_serving_bundle(model, blobs: Dict[str, bytes],
                           registry=None) -> List[tuple]:
    """Install the bundle's library into the cache directory and its
    bucket records onto ``model``; returns the shape keys installed.
    Unusable artifacts are counted and skipped: the library then builds
    with ``nvcc`` at the first launch, a bucket's shape counts as new at
    warm-up, exactly as without a bundle."""
    data = blobs.get(LIBRARY_ARTIFACT)
    if data is not None:
        install_library(data, registry=registry)
    installed: List[tuple] = []
    for name, data in sorted(blobs.items()):
        if not name.startswith(ARTIFACT_OUTPUT_PREFIX):
            continue
        try:
            meta = peek_meta(data)
            key = shape_key(tuple(meta["shape"]) if meta.get("shape")
                            else ())
        except (AotArtifactError, KeyError, TypeError) as e:
            _fallback(_instruments(registry), "corrupt", name, str(e))
            continue
        if model.aot_install_output(key, data, registry=registry):
            installed.append(key)
    return installed

"""ctypes bindings for the native data loader (``loader.cpp``, the C++
runtime piece standing in for the reference's libnd4j/DataVec decode
path): the IDX3 parse, the uint8 -> float32 normalize, the fused batch
assembly (gather, normalize, one-hot) and the CIFAR-10 record split.

Counterpart of ``deeplearning4j_tpu/native``. The library is built
with ``g++`` at first use into ``deeplearning4j_tpu_torch/build/``
(git-ignored; never beside the source), named by a hash of the source
and flags so a changed source rebuilds, and written there atomically
so concurrent first uses do not race. Every entry point has a numpy
route with the same bits; ``route()`` says which one this process
takes (``"native"`` or ``"numpy"``), and taking the numpy route warns
once (no ``g++``, a failed build or load). The MNIST and CIFAR-10
readers (``datasets/mnist.py``, ``datasets/cifar.py``) go through
these functions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "loader.cpp"
BUILD_DIR = _DIR.parent / "build"
GXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None  # why the numpy route is taken


def library_path() -> Path:
    """Where the built library lies (a hash of the source and flags)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdl4j_loader-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    gxx = shutil.which(GXX)
    if gxx is None:
        raise RuntimeError(f"{GXX} not found")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([gxx, *FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it if needed; None when it
    cannot be built or loaded (the numpy route, warned once)."""
    global _lib, _failure
    if _lib is not None or _failure is not None:
        return _lib
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except Exception as e:  # no toolchain, a failed build or load
            err = getattr(e, "stderr", None)
            detail = err.decode(errors="replace")[-300:] if err else ""
            _failure = f"{type(e).__name__}: {e} {detail}".strip()
            warnings.warn(
                "the native data loader could not be built or loaded "
                f"({_failure}); the numpy route is taken (the same bits, "
                "slower)", RuntimeWarning, stacklevel=3)
            return None
        lib.idx3_header.restype = ctypes.c_int
        lib.split_cifar_records.restype = ctypes.c_int
        _lib = lib
        return _lib


def route() -> str:
    """``"native"`` where the C++ loader is built and loaded, else
    ``"numpy"`` (builds on the first call)."""
    return "native" if get_lib() is not None else "numpy"


def native_available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


_IDX3_ERRORS = {1: "short IDX3 header", 3: "truncated IDX3 data"}


def parse_idx3(buf: bytes) -> np.ndarray:
    """IDX3 image bytes (big-endian magic 2051) -> uint8 [n, rows*cols]."""
    lib = get_lib()
    arr = np.frombuffer(buf, np.uint8)
    if lib is not None:
        n = ctypes.c_int64()
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        rc = lib.idx3_header(
            _ptr(arr, ctypes.c_uint8), ctypes.c_int64(arr.size),
            ctypes.byref(n), ctypes.byref(rows), ctypes.byref(cols),
        )
        if rc == 2:
            raise ValueError(
                f"bad IDX3 magic {struct.unpack('>I', buf[:4])[0]}")
        if rc != 0:
            raise ValueError(_IDX3_ERRORS.get(rc, f"bad IDX3 data ({rc})"))
        d = rows.value * cols.value
        return arr[16:16 + n.value * d].reshape(n.value, d).copy()
    if len(buf) < 16:
        raise ValueError(_IDX3_ERRORS[1])
    magic, n, rows, cols = struct.unpack(">IIII", buf[:16])
    if magic != 2051:
        raise ValueError(f"bad IDX3 magic {magic}")
    d = rows * cols
    if len(buf) < 16 + n * d:
        raise ValueError(_IDX3_ERRORS[3])
    return np.frombuffer(buf, np.uint8, n * d, 16).reshape(n, d).copy()


def normalize_u8(images: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1]."""
    images = np.ascontiguousarray(images, np.uint8)
    lib = get_lib()
    if lib is not None:
        out = np.empty(images.shape, np.float32)
        lib.normalize_u8(
            _ptr(images, ctypes.c_uint8), _ptr(out, ctypes.c_float),
            ctypes.c_int64(images.size),
        )
        return out
    return images.astype(np.float32) / np.float32(255.0)


def assemble_batch(features_u8: np.ndarray, labels_u8: np.ndarray,
                   perm: np.ndarray, n_classes: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused gather+normalize+one-hot (one memory pass in C++): rows
    ``perm`` of the uint8 features as float32 in [0, 1] [b, d] and
    their one-hot float32 labels [b, n_classes]."""
    features_u8 = np.ascontiguousarray(features_u8, np.uint8)
    labels_u8 = np.ascontiguousarray(labels_u8, np.uint8)
    perm = np.ascontiguousarray(perm, np.int64)
    b = perm.size
    d = features_u8.shape[1]
    lib = get_lib()
    if lib is not None:
        x = np.empty((b, d), np.float32)
        y = np.empty((b, n_classes), np.float32)
        lib.assemble_batch_u8(
            _ptr(features_u8, ctypes.c_uint8),
            _ptr(labels_u8, ctypes.c_uint8),
            _ptr(perm, ctypes.c_int64),
            ctypes.c_int64(b), ctypes.c_int64(d),
            ctypes.c_int64(n_classes),
            _ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float),
        )
        return x, y
    x = features_u8[perm].astype(np.float32) / np.float32(255.0)
    y = np.zeros((b, n_classes), np.float32)
    y[np.arange(b), labels_u8[perm]] = 1.0
    return x, y


def split_cifar(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary records -> (images u8 [n, 3072], labels u8 [n])."""
    arr = np.frombuffer(buf, np.uint8)
    if arr.size % 3073:
        raise ValueError(
            f"size {arr.size} not a multiple of the 3073-byte record"
        )
    n = arr.size // 3073
    lib = get_lib()
    if lib is not None:
        images = np.empty((n, 3072), np.uint8)
        labels = np.empty((n,), np.uint8)
        rc = lib.split_cifar_records(
            _ptr(arr, ctypes.c_uint8), ctypes.c_int64(arr.size),
            _ptr(images, ctypes.c_uint8), _ptr(labels, ctypes.c_uint8),
        )
        if rc != 0:
            raise ValueError("bad CIFAR records")
        return images, labels
    rec = arr.reshape(n, 3073)
    return rec[:, 1:].copy(), rec[:, 0].copy()

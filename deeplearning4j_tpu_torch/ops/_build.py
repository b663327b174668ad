"""Build and bind the hand-written CUDA kernels.

The sources under ``deeplearning4j_tpu_torch/csrc/`` are compiled with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at the first kernel
launch, never at import, so the package imports on a machine without
``nvcc`` (the CPU tests never build). Each source compiles in its own
``nvcc`` process, all started together, then one link step joins them.
The library lands in ``deeplearning4j_tpu_torch/build/`` (git-ignored),
named by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("conv_block.cu", "conv_bwd.cu", "flash_attention.cu",
           "lstm_cell.cu", "lstm_seq.cu", "matmul_block.cu")
HEADERS = ("common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# element-type codes of csrc/common.cuh (enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (None: loaded a cached
# library or never built)
build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels (unless this exact build exists) and return
    the shared library's path."""
    global build_seconds
    lib_path = BUILD_DIR / f"libdl4j_kernels-{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    _run_all([
        [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", str(o)]
        for s, o in zip(SOURCES, objs)
    ])
    tmp = lib_path.with_name(lib_path.name + f".{tag}.tmp")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *(str(o) for o in objs)]])
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink()
    build_seconds = time.perf_counter() - t0
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_conv_block.argtypes = [p] * 8 + [i] * 21 + [p]
    lib.dl4j_conv_block.restype = i
    lib.dl4j_conv_wide_smem_bytes.argtypes = [i] * 3
    lib.dl4j_conv_wide_smem_bytes.restype = i
    lib.dl4j_conv_block_splits.argtypes = [i] * 7
    lib.dl4j_conv_block_splits.restype = i
    lib.dl4j_conv_bwd_data.argtypes = [p] * 4 + [i] * 14 + [p]
    lib.dl4j_conv_bwd_data.restype = i
    lib.dl4j_conv_bwd_w.argtypes = [p] * 4 + [i] * 15 + [p]
    lib.dl4j_conv_bwd_w.restype = i
    lib.dl4j_conv_bwd_data_resident.argtypes = [p] * 4 + [i] * 15 + [p]
    lib.dl4j_conv_bwd_w_resident.argtypes = [p] * 4 + [i] * 17 + [p]
    lib.dl4j_conv_bwd_w_resident.restype = i
    lib.dl4j_conv_bwd_data_resident.restype = i
    lib.dl4j_conv_bwd_data_splits.argtypes = [i] * 7
    lib.dl4j_conv_bwd_data_splits.restype = i
    lib.dl4j_conv_bwd_w_splits.argtypes = [i] * 7
    lib.dl4j_conv_bwd_w_splits.restype = i
    lib.dl4j_matmul_block.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.dl4j_matmul_block.restype = i
    lib.dl4j_matmul_block_splits.argtypes = [i] * 3
    lib.dl4j_matmul_block_splits.restype = i
    lib.dl4j_lstm_cell.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.dl4j_lstm_cell.restype = i
    lib.dl4j_lstm_seq_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.dl4j_lstm_seq_fwd.restype = i
    lib.dl4j_lstm_seq_bwd.argtypes = [p] * 12 + [i] * 5 + [p]
    lib.dl4j_lstm_seq_bwd.restype = i
    for name in ("dl4j_flash_attention", "dl4j_flash_attention_streamed"):
        getattr(lib, name).argtypes = [p] * 4 + [i] * 5 + [ctypes.c_float, p]
        getattr(lib, name).restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dl4j_flash_smem_bytes.argtypes = [i, i, ip]
    lib.dl4j_flash_smem_bytes.restype = i
    lib.dl4j_lstm_seq_plan.argtypes = [i] * 3 + [ip, ip]
    lib.dl4j_lstm_seq_plan.restype = i
    lib.dl4j_lstm_cluster_plan.argtypes = [i] * 5 + [ip, ip]
    lib.dl4j_lstm_cluster_plan.restype = i
    lib.dl4j_lstm_cell_plan.argtypes = [i] * 5 + [ip, ip]
    lib.dl4j_lstm_cell_plan.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def split_scratch(splits: int, numel: int, device: torch.device):
    """The f32 scratch a split-K launch writes its partial sums to
    (``splits`` copies of the output), or None when nothing is split."""
    if splits <= 1:
        return None
    return torch.empty(splits * numel, dtype=torch.float32, device=device)


def current_stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, read in the calling
    thread, as the ``void*`` the C entry points take."""
    return torch.cuda.current_stream(device).cuda_stream

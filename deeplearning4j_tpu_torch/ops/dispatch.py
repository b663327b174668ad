"""Device resolution, kernel routing and launch counters.

Counterpart of ``deeplearning4j_tpu/ops/dispatch.py``, without its
environment knob: here the kernel-or-plain decision follows the
tensor's device alone. A CPU tensor takes a kernel's plain PyTorch
version; a CUDA tensor launches the hand-written kernel or raises.
Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Union

import torch

# Launch counters, one plain integer per kernel wrapper. A wrapper adds
# one where it launches its kernel and nowhere else, so a run can show
# that its main path went through the kernels.
# The two flash-attention entries (one kernel template) count apart, one
# counter per TPU schedule; so does the residual variant of the dense
# kernel, a TPU kernel of its own.
KERNELS = ("conv_block", "conv_bwd_data", "conv_bwd_w", "matmul_block",
           "lstm_cell", "lstm_seq_fwd", "lstm_seq_bwd", "flash_attention",
           "flash_attention_streamed", "matmul_block_residual")
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# the same launches by dtype variant, "kernel[variant]": the operands'
# dtype ("f32", "bf16", "f16"), with "->f32" where a half launch writes
# f32 (the conv forward's recompute in the backward)
_variants: Dict[str, int] = {}
DTYPE_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16"}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and no card is present; never substitutes the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


_meta_plain = threading.local()


@contextlib.contextmanager
def plain_on_meta():
    """Within this block (on this thread) a ``meta`` tensor takes the
    plain version: shapes without data, which the step profiler's cost
    model runs the plain path on to count its FLOPs. Elsewhere a meta
    tensor raises."""
    prev = getattr(_meta_plain, "on", False)
    _meta_plain.on = True
    try:
        yield
    finally:
        _meta_plain.on = prev


def is_kernel_tensor(t: torch.Tensor) -> bool:
    """True when ``t`` must go through a hand-written kernel (it lies
    on a CUDA device), False when it takes the plain version (CPU, and
    ``meta`` inside ``plain_on_meta``)."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu" or (kind == "meta"
                         and getattr(_meta_plain, "on", False)):
        return False
    raise ValueError(f"no kernel or plain version for a tensor on {t.device}")


def note_launch(kernel: str, variant: str = "f32") -> None:
    _launches[kernel] += 1
    key = f"{kernel}[{variant}]"
    _variants[key] = _variants.get(key, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by wrapper. A wrapper counts
    where Python calls it: a CUDA graph's capture counts its launches
    once, and its replays (a megastep chunk's, ``nn/core.py``) count
    none."""
    return dict(_launches)


def variant_counts() -> Dict[str, int]:
    """Launches since the last reset by ``"kernel[variant]"`` (only the
    variants launched)."""
    return dict(_variants)


def reset_for_tests() -> None:
    """Drop the kernel tuner's environment reads, resolution memo and
    fingerprint (``autotune.reset_for_tests``), so the next launch
    re-reads ``DL4J_TPU_TUNE*``: the one way to flip tuning inside a
    process (tests, A/B runs)."""
    from deeplearning4j_tpu_torch.ops import autotune

    autotune.reset_for_tests()


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
    _variants.clear()

"""Absolute-performance accounting: the FLOPs of one train step, and the
card's peak FLOP/s, so throughput can be stated as achieved TFLOP/s and
MFU rather than bare examples a second.

Counterpart of ``deeplearning4j_tpu/util/flops.py``. The JAX module asks
XLA's ``cost_analysis()`` of a compiled program; the port has no
compiler to ask, so its counts come from the step profiler's count
(``observability/profiler.py``): the plain path run on ``meta`` tensors
at the real shapes under ``FlopCounterMode``, no data and no card time.
The peak is the profiler's table of cards, read, not copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.observability import profiler


def device_peak_flops(device=None, dtype: str = "bfloat16"
                      ) -> Tuple[Optional[float], str]:
    """(peak FLOP/s in ``dtype``, the card's name) for ``device``
    (default the current card): the dense bf16 rate, as the JAX module
    gives, unless ``dtype`` names another. None where the profiler's
    table has no such card, or on the CPU (``"cpu"``)."""
    return profiler.peak_flops(device, dtype)


def train_step_cost(model, ds) -> dict:
    """``{"flops", "bytes_accessed", "batch", "flops_per_example"}`` of
    one train step of ``model`` on minibatch ``ds`` (forward, loss,
    backward, updater): ``profiler.train_step_cost``."""
    return profiler.train_step_cost(model, ds)


def _meta(v):
    if isinstance(v, torch.Tensor):
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    if isinstance(v, (list, tuple)):
        return type(v)(_meta(a) for a in v)
    if isinstance(v, dict):
        return {k: _meta(a) for k, a in v.items()}
    return v


def _bytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_bytes(a) for a in v)
    if isinstance(v, dict):
        return sum(_bytes(a) for a in v.values())
    return 0


def jit_cost(fn, *args, **kwargs) -> dict:
    """``{"flops", "bytes_accessed"}`` of an arbitrary callable on these
    arguments (paths that are no engine step): ``fn`` runs once on meta
    copies of its tensor arguments under ``FlopCounterMode``, the
    kernels taking their plain versions (``dispatch.plain_on_meta``);
    bytes count each input read once and each output written once."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.ops import dispatch

    margs, mkw = _meta(args), _meta(kwargs)
    counter = FlopCounterMode(display=False)
    with counter, dispatch.plain_on_meta():
        out = fn(*margs, **mkw)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float(_bytes(args) + _bytes(kwargs)
                                    + _bytes(out))}

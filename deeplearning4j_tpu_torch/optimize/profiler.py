"""Profiler hooks: a listener that brackets a span of training iterations
with ``torch.profiler`` and writes a Chrome trace.

Counterpart of ``deeplearning4j_tpu/optimize/profiler.py`` (which wraps
``jax.profiler``): the trace holds the host's PyTorch operators and,
on a card, the kernels the device ran, under their ``__global__``
names, so it shows the port's own kernels beside the library's.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


class ProfilerListener(IterationListener):
    """Trace iterations ``[start_iteration, start_iteration +
    num_iterations)`` into ``log_dir`` (one Chrome trace,
    ``trace-<start>-<stop>.json``; ``trace_path`` names it once written).

    Usage::

        net.add_listener(ProfilerListener(log_dir, 10, 5))
        net.fit(data)          # iterations 10..14 are traced

    ``supports_batched_iterations`` is False: the listener forces the
    per-step path, as in the JAX package, since on the scan path every
    callback of a chunk comes after the chunk and a trace started there
    would bracket no device work."""

    supports_batched_iterations = False

    def __init__(self, log_dir: str, start_iteration: int = 5,
                 num_iterations: int = 5):
        try:
            os.makedirs(log_dir, exist_ok=True)
        except OSError as e:
            raise ValueError(f"ProfilerListener log_dir {log_dir!r} cannot "
                             f"be created: {e}") from e
        if not os.access(log_dir, os.W_OK):
            raise ValueError(f"ProfilerListener log_dir {log_dir!r} is not "
                             "writable")
        self.log_dir = log_dir
        self.start_iteration = int(start_iteration)
        self.stop_iteration = int(start_iteration) + int(num_iterations)
        self._prof = None
        self.trace_dir: Optional[str] = None
        self.trace_path: Optional[str] = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def _stop(self, model=None) -> None:
        import torch

        from deeplearning4j_tpu_torch.observability.trace import get_tracer

        if model is not None and getattr(model, "device", None) is not None \
                and model.device.type == "cuda":
            # the trace holds the device work of the traced steps
            torch.cuda.synchronize(model.device)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.log_dir, f"trace-{self.start_iteration}-"
                            f"{self.stop_iteration}.json")
        prof.export_chrome_trace(path)
        self.trace_dir = self.log_dir
        self.trace_path = path
        get_tracer().event("profiler.trace_ready",
                           attrs={"trace_dir": self.trace_dir})
        logging.getLogger(__name__).info("profiler trace written to %s",
                                         path)

    def iteration_done(self, model, iteration: int) -> None:
        if not self._active and (
                self.start_iteration <= iteration < self.stop_iteration):
            self._start()
        elif self._active and iteration >= self.stop_iteration:
            self._stop(model)

    def on_epoch_end(self, model) -> None:
        """Finish an open trace when training ends before
        ``stop_iteration``."""
        if self._active:
            self._stop(model)

    def close(self) -> None:
        if self._active:
            self._stop()


def annotate(name: str):
    """A named range in the trace for a host phase (data loading, an
    evaluation): ``torch.profiler.record_function``."""
    import torch.profiler

    return torch.profiler.record_function(name)

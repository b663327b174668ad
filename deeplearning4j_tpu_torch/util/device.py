"""The device-memory budget of the engines' device-cached epochs.

Counterpart of ``deeplearning4j_tpu/util/device.py``: how many bytes of
training data a multi-epoch fit may keep on the device
(``nn/core.py`` ``fit_epochs_device_cached``), a quarter of the card's
memory, so the rest stays for parameters, activations and the CUDA
graphs' pools.
"""

from __future__ import annotations

from typing import Dict

import torch

_FALLBACK_BYTES = 4 << 30  # the CPU: JAX's fallback without memory_stats()
_MIN_BYTES = 256 << 20
_CACHE_FRACTION = 0.25
_cached: Dict[str, int] = {}


def device_cache_budget_bytes(device=None, refresh: bool = False) -> int:
    """Bytes of training data the device cache may hold on ``device``
    (default: the current card when one is present, else the CPU): a
    quarter of the card's total memory (``torch.cuda.mem_get_info``), at
    least 256 MiB; 4 GiB on the CPU. Cached per device: a card's memory
    does not change."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    if not refresh and key in _cached:
        return _cached[key]
    budget = _FALLBACK_BYTES
    if dev.type == "cuda":
        _, total = torch.cuda.mem_get_info(dev)
        budget = max(_MIN_BYTES, int(total * _CACHE_FRACTION))
    _cached[key] = budget
    return budget

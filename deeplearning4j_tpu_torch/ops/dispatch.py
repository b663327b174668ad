"""Device resolution, kernel routing and launch counters.

Counterpart of ``deeplearning4j_tpu/ops/dispatch.py``, without its
environment knob: here the kernel-or-plain decision follows the
tensor's device alone. A CPU tensor takes a kernel's plain PyTorch
version; a CUDA tensor launches the hand-written kernel or raises.
Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

# Launch counters, one plain integer per kernel wrapper. A wrapper adds
# one where it launches its kernel and nowhere else, so a run can show
# that its main path went through the kernels.
KERNELS = ("conv_block", "conv_bwd_data", "conv_bwd_w", "matmul_block")
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


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


def is_kernel_tensor(t: torch.Tensor) -> bool:
    """True when ``t`` must go through a hand-written kernel (it lies
    on a CUDA device), False when it takes the plain version (CPU)."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for a tensor on {t.device}")


def note_launch(kernel: str) -> None:
    _launches[kernel] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0

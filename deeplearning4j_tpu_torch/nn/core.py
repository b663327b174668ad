"""The sequential inference forward shared by the network engines.

Counterpart of the inference half of
``deeplearning4j_tpu/nn/core.py::sequential_forward``: preprocessors,
then each layer's ``apply``, in order. The JAX package's whole-net
transforms (scan over layers, remat) and the conv->BatchNorm peephole
have no counterpart yet: the first are compile-time devices of XLA, the
second arrives with BatchNormalization in the VGG-16 slice.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name) -> torch.dtype:
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} (known: "
                         f"{sorted(_DTYPES)})") from None


def dtype_of(conf) -> torch.dtype:
    return torch_dtype(conf.dtype)


def compute_dtype_of(conf) -> torch.dtype:
    return torch_dtype(conf.compute_dtype or conf.dtype)


def sequential_forward(conf, layer_names: Sequence[str],
                       params: Dict[str, dict], state: Dict[str, dict],
                       x: torch.Tensor) -> torch.Tensor:
    """Inference forward through every layer of ``conf``; returns the
    last layer's activation. With a ``compute_dtype`` the floating
    params and the input are cast to it first (mixed precision)."""
    cdt = compute_dtype_of(conf)
    if cdt != dtype_of(conf):
        params = {ln: {pn: (t.to(cdt) if t.is_floating_point() else t)
                       for pn, t in lp.items()}
                  for ln, lp in params.items()}
        x = x.to(cdt)
    for i, (name, layer) in enumerate(zip(layer_names, conf.layers)):
        if i in conf.preprocessors:
            x = conf.preprocessors[i].preprocess(x)
        x, _ = layer.apply(params[name], x.contiguous(), state.get(name, {}))
    return x

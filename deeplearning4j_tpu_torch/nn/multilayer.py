"""``MultiLayerNetwork``: the sequential-network engine, inference half.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` for ``init``,
``output`` and ``output_padded``. Parameters are a plain dictionary
``{layer name: {param name: tensor}}`` on the network's device, keyed
as in the JAX package (layer names are ``conf.layer_name(i)``), so a
checkpoint's ``"<layer>/<param>"`` arrays map onto it 1:1. ``fit``,
``score`` and the rest of training arrive with the training slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.exceptions import DL4JInvalidConfigException
from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        """``device`` defaults to ``"cuda"`` and raises without a card;
        pass ``"cpu"`` for the plain PyTorch versions of the kernels."""
        self.conf = conf
        self.device = resolve_device(device)
        self.layer_names: List[str] = [
            conf.layer_name(i) for i in range(len(conf.layers))
        ]
        if len(set(self.layer_names)) != len(self.layer_names):
            raise DL4JInvalidConfigException(
                "Duplicate layer names in configuration"
            )
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.state: Dict[str, dict] = {}
        self.iteration_count = 0
        self.epoch_count = 0

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        return t.to(device=self.device, dtype=dtype).contiguous()

    def init(self, params: Optional[dict] = None) -> "MultiLayerNetwork":
        """Fresh weights from ``conf.seed`` (drawn on a CPU
        ``torch.Generator``, then moved to the device), or the given
        ``{layer: {param: array}}`` (numpy arrays or tensors). Layers
        without parameters may be missing from ``params``; a missing
        parameterized layer raises."""
        dtype = core.dtype_of(self.conf)
        if params is not None:
            restored = {}
            for name, layer in zip(self.layer_names, self.conf.layers):
                if name in params:
                    restored[name] = {
                        pn: self._to_device(a, dtype)
                        for pn, a in params[name].items()
                    }
                elif layer.init_params(torch.Generator(), dtype):
                    raise ValueError(
                        f"checkpoint has no params for layer '{name}' "
                        f"({type(layer).__name__})"
                    )
                else:
                    restored[name] = {}
            self.params = restored
        else:
            gen = torch.Generator().manual_seed(int(self.conf.seed))
            self.params = {
                name: {pn: t.to(self.device)
                       for pn, t in layer.init_params(gen, dtype).items()}
                for name, layer in zip(self.layer_names, self.conf.layers)
            }
        self.state = {
            name: layer.init_state(dtype)
            for name, layer in zip(self.layer_names, self.conf.layers)
        }
        return self

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Activated network output for ``x`` (numpy array or tensor),
        as a tensor on the network's device."""
        if train:
            raise NotImplementedError(
                "training-mode forward arrives with the training slice"
            )
        if self.params is None:
            self.init()
        with torch.inference_mode():
            xt = self._to_device(x, core.dtype_of(self.conf))
            return core.sequential_forward(
                self.conf, self.layer_names, self.params, self.state, xt
            )

    def output_padded(self, x, n_valid: int) -> torch.Tensor:
        """Inference on a row-padded batch: the serving micro-batcher
        pads a stack of requests to a bucket size and needs the first
        ``n_valid`` rows back equal to a solo ``output`` on those rows.
        Runs the same forward as ``output`` and slices; padding rows
        cannot perturb the valid ones because every inference-mode
        layer is row-independent."""
        n = int(n_valid)
        b = int(np.shape(x)[0])
        if not 0 < n <= b:
            raise ValueError(
                f"n_valid must be in [1, {b}] for a {b}-row batch; got {n}"
            )
        return self.output(x)[:n]

    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return sum(t.numel() for lp in self.params.values()
                   for t in lp.values())

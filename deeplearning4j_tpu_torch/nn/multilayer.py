"""``MultiLayerNetwork``: the sequential-network engine.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` for ``init``,
``output``, ``output_padded``, ``fit``, ``fit_minibatch`` and ``score``.
Parameters are a plain dictionary ``{layer name: {param name: tensor}}``
on the network's device, keyed as in the JAX package (layer names are
``conf.layer_name(i)``), so a checkpoint's ``"<layer>/<param>"`` arrays
map onto it 1:1; the updater state ``{layer: {param: (tensor, ...)}}``
likewise maps onto ``"<layer>/<param>/<i>"``.

Training is the plain per-step loop (``nn/core.py`` ``build_step``):
each minibatch runs ``conf.iterations`` optimizer steps at the
scheduled learning rates, with Adam's ``t = iteration + 1``. ``fit``
raises, naming the slice that brings them, for what the port does not
carry yet: dropout / drop-connect, truncated BPTT, the line-search
solvers, layer-wise pretraining, gradient accumulation, megastep
dispatch, the divergence guard and loss scaling.
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
from deeplearning4j_tpu_torch.nn.updaters import MultiLayerUpdaterDef
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
        self.updater_def = MultiLayerUpdaterDef({
            name: layer.updater_settings()
            for name, layer in zip(self.layer_names, conf.layers)
        })
        self.updater_state = None
        self.iteration_count = 0
        self.epoch_count = 0
        self._last_score = float("nan")
        self._step = None

    @property
    def score_value(self) -> float:
        """The latest minibatch score (reading it waits for the card)."""
        return float(self._last_score)

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        return t.to(device=self.device, dtype=dtype).contiguous()

    def init(self, params: Optional[dict] = None) -> "MultiLayerNetwork":
        """Fresh weights from ``conf.seed`` (drawn on a CPU
        ``torch.Generator``, then moved to the device), or the given
        ``{layer: {param: array}}`` (numpy arrays or tensors). Layers
        without parameters may be missing from ``params``; a missing
        parameterized layer raises. The updater state starts at zero."""
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
        self.updater_state = self.updater_def.init(self.params)
        return self

    # -- inference ---------------------------------------------------------

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Activated network output for ``x`` (numpy array or tensor),
        as a tensor on the network's device. ``train=True`` runs the
        training-mode forward (no graph is kept either way)."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            xt = self._to_device(x, core.dtype_of(self.conf))
            y, _ = core.sequential_forward(
                self.conf, self.layer_names, self.params, self.state, xt,
                train=train)
            return y

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

    def score(self, ds=None, x=None, labels=None) -> float:
        """Loss (plus the L1/L2 penalty) on a dataset, inference mode
        (reference ``score(DataSet)``)."""
        if self.params is None:
            self.init()
        mask = None
        if ds is not None:
            x, labels = ds.features, ds.labels
            mask = getattr(ds, "labels_mask", None)
        dtype = core.dtype_of(self.conf)
        with torch.no_grad():
            s, _ = core.sequential_score(
                self.conf, self.layer_names, self.params, self.state,
                self._to_device(x, dtype), self._to_device(labels, dtype),
                None if mask is None else self._to_device(mask, dtype),
                train=False)
        return float(s)

    # -- training ----------------------------------------------------------

    def _check_trainable(self) -> None:
        """Refuse, naming the slice that brings it, what this port's
        training loop does not carry yet."""
        conf = self.conf
        missing = []
        if conf.backprop_type == "TruncatedBPTT":
            missing.append("truncated BPTT (char-RNN slice)")
        if conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT":
            missing.append(f"the {conf.optimization_algo} solver "
                           "(periphery: optimize/)")
        if conf.pretrain:
            missing.append("layer-wise pretraining (periphery: "
                           "pretrainable layers)")
        if missing:
            raise NotImplementedError(
                "fit: not ported yet: " + "; ".join(missing))
        for layer in conf.layers:
            layer.check_train(True)

    def set_divergence_guard(self, guard) -> None:
        raise NotImplementedError(
            "the divergence guard arrives with the runtime subsystems "
            "slice (resilience/guard.py)")

    def set_transforms(self, scan_layers=None, remat=None, loss_scale=None,
                       megastep=None) -> "MultiLayerNetwork":
        raise NotImplementedError(
            "whole-net transforms (scan_layers, remat, loss scaling, "
            "megastep) arrive with the runtime subsystems slice")

    def _train_step(self):
        if self._step is None:
            conf, names = self.conf, self.layer_names

            def score_fn(params, state, x, labels, mask):
                return core.sequential_score(conf, names, params, state, x,
                                             labels, mask, train=True)

            self._step = core.build_step(score_fn, self.updater_def)
        return self._step

    def fit(self, data, labels=None, *, epochs: int = 1, grad_accum=None,
            megastep=None) -> None:
        """fit(DataSetIterator) / fit(DataSet) / fit(x, y) (reference
        ``fit:1048``). ``data`` may be an iterable of objects with
        ``.features`` / ``.labels`` (and optional ``.labels_mask``),
        one such object, or the features of an (x, y) pair. An iterator
        with ``reset()`` is reset after each epoch."""
        if grad_accum is not None and int(grad_accum) != 1:
            raise NotImplementedError(
                "fit: grad_accum arrives with the distribution slice")
        if megastep is not None and int(megastep) != 1:
            raise NotImplementedError(
                "fit: megastep arrives with the runtime subsystems slice")
        if self.params is None:
            self.init()
        if labels is not None:
            from deeplearning4j_tpu_torch.datasets.api import DataSet

            batches = [DataSet(features=data, labels=labels)]
        elif hasattr(data, "features"):
            batches = [data]
        else:
            batches = data
        for epoch in range(epochs):
            n_batches = 0
            for ds in batches:
                self.fit_minibatch(ds)
                n_batches += 1
            if epoch > 0 and n_batches == 0:
                raise ValueError(
                    "Iterator yielded no batches after the first epoch — "
                    "a plain generator cannot be re-iterated; pass a list, "
                    "a DataSetIterator with reset(), or epochs=1")
            if hasattr(batches, "reset"):
                batches.reset()
            self.epoch_count += 1

    def fit_minibatch(self, ds) -> torch.Tensor:
        """One minibatch through ``conf.iterations`` optimizer steps;
        returns the last step's score as a 0-d tensor on the device."""
        if self.params is None:
            self.init()
        self._check_trainable()
        dtype = core.dtype_of(self.conf)
        x = self._to_device(ds.features, dtype)
        y = self._to_device(ds.labels, dtype)
        mask = getattr(ds, "labels_mask", None)
        if mask is not None:
            mask = self._to_device(mask, dtype)
        step = self._train_step()
        score = None
        for _ in range(self.conf.iterations):
            lrs = self.updater_def.scheduled_lrs(self.iteration_count)
            t = self.iteration_count + 1
            self.params, self.updater_state, self.state, score = step(
                self.params, self.updater_state, self.state, x, y, mask,
                lrs, t)
            self.iteration_count += 1
            self._last_score = score
        return score

    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return sum(t.numel() for lp in self.params.values()
                   for t in lp.values())

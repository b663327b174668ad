"""``MultiLayerNetwork``: the sequential-network engine.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` for ``init``,
``output``, ``output_padded``, ``fit``, ``fit_minibatch``, ``score``,
truncated BPTT, ``rnn_time_step`` and ``rnn_clear_previous_state``.
Parameters are a plain dictionary ``{layer name: {param name: tensor}}``
on the network's device, keyed as in the JAX package (layer names are
``conf.layer_name(i)``), so a checkpoint's ``"<layer>/<param>"`` arrays
map onto it 1:1; the updater state ``{layer: {param: (tensor, ...)}}``
likewise maps onto ``"<layer>/<param>/<i>"``, and the layer state
``{layer: {key: tensor}}`` (BatchNormalization's running ``mean`` and
``var``) onto ``"<layer>/<key>"``. At inference a Conv(identity) ->
BatchNormalization pair runs as one conv kernel launch (``nn/core.py``).

Training is the plain per-step loop (``nn/core.py`` ``build_step``):
each minibatch runs ``conf.iterations`` optimizer steps at the
scheduled learning rates, with Adam's ``t = iteration + 1`` (with
``fit(grad_accum=K)`` each step runs K contiguous microbatches), and
the recurrent carry is reset after each. Inputs cross to the device at
their own width where they are uint8 / int8 / int16 and are cast there
(``core.to_device``). Under truncated BPTT a minibatch
longer than ``tbptt_fwd_length`` is cut into chunks along time, one
optimizer step and one iteration a chunk, with the carry handed from
chunk to chunk outside the graph (the JAX package's chunk loop; its
fused single-dispatch scan has the same trajectory and is not ported).
The step's flavours are the JAX engine's: dynamic loss scaling under
f16 compute (``set_transforms(loss_scale=...)`` or the Builder's
``loss_scale``), the divergence guard and the statistical guard
(``set_divergence_guard``), each a select on the device, with the
guard's host policy applied after each step (one read of its ok flag);
``remat`` recomputes each layer's activations in the backward and
``scan_layers`` is taken (``nn/core.py``). Dropout and drop-connect
draw the JAX package's masks: the step's key is ``fold_in(PRNGKey(
conf.seed), iteration)`` and layer i's ``fold_in(step key, i)``
(``nn/random.py``), in training and in ``output(train=True)``.
``fit(megastep=K)`` runs K steps a chunk with one readback, on the card
one CUDA-graph replay (``core.run_megastep_chunk``); a chunk is
bitwise the per-step loop. ``fit`` raises, naming the slice that brings
them, for the line-search solvers and layer-wise pretraining.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.exceptions import DL4JInvalidConfigException
from deeplearning4j_tpu_torch.nn import core, random
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
        self._last_batch_rows = 0
        self.grad_accum = 1
        self._step = None
        # the transform knobs, the guard and their device states
        core.init_transforms(self)
        # {"shards": n} while the updater state lies in ZeRO-1's flat
        # layout (set by the distributed trainer); None: parameter-shaped
        self._zero_layout = None
        # rnn_time_step's carried state (the reference's stateMap)
        self._rnn_state: Dict[str, dict] = {}
        self._stream_steps = 0

    @property
    def score_value(self) -> float:
        """The latest minibatch score (reading it waits for the card)."""
        return float(self._last_score)

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return core.to_device(a, self.device, dtype)

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
            name: {k: t.to(self.device)
                   for k, t in layer.init_state(dtype).items()}
            for name, layer in zip(self.layer_names, self.conf.layers)
        }
        self.updater_state = self.updater_def.init(self.params)
        self._zero_layout = None
        return self

    # -- inference ---------------------------------------------------------

    def output(self, x, train: bool = False,
               features_mask=None) -> torch.Tensor:
        """Activated network output for ``x`` (numpy array or tensor),
        as a tensor on the network's device. ``train=True`` runs the
        training-mode forward, dropout drawn from the key of the next
        step (no graph is kept either way); ``features_mask`` is the
        [batch, time] RNN input mask."""
        if self.params is None:
            self.init()
        dtype = core.dtype_of(self.conf)
        with torch.inference_mode():
            xt = self._to_device(x, dtype)
            fm = (None if features_mask is None
                  else self._to_device(features_mask, dtype))
            y, _ = core.sequential_forward(
                self.conf, self.layer_names, self.params, self.state, xt,
                train=train, fmask=fm,
                rng=core.step_rng(self, self.iteration_count)
                if train else None)
            return y

    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """Every layer's activation (reference ``feedForward``); with
        ``train`` the training-mode forward, dropout drawn from
        ``PRNGKey(conf.seed)`` itself, as in the JAX package."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts, _ = core.sequential_forward(
                self.conf, self.layer_names, self.params, self.state,
                self._to_device(x, core.dtype_of(self.conf)), train=train,
                collect=True,
                rng=random.host_key(self.conf.seed) if train else None)
        return acts

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
        mask = fmask = None
        if ds is not None:
            x, labels = ds.features, ds.labels
            mask = getattr(ds, "labels_mask", None)
            fmask = getattr(ds, "features_mask", None)
        dtype = core.dtype_of(self.conf)
        with torch.no_grad():
            s, _ = core.sequential_score(
                self.conf, self.layer_names, self.params, self.state,
                self._to_device(x, dtype), self._to_device(labels, dtype),
                self._maybe_to_device(mask, dtype), train=False,
                fmask=self._maybe_to_device(fmask, dtype))
        return float(s)

    def _maybe_to_device(self, a, dtype) -> Optional[torch.Tensor]:
        return None if a is None else self._to_device(a, dtype)

    # -- training ----------------------------------------------------------

    def _check_trainable(self) -> None:
        """Refuse, naming the slice that brings it, what this port's
        training loop does not carry yet."""
        conf = self.conf
        missing = []
        if conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT":
            missing.append(f"the {conf.optimization_algo} solver "
                           "(periphery: optimize/)")
        if conf.pretrain:
            missing.append("layer-wise pretraining (periphery: "
                           "pretrainable layers)")
        if missing:
            raise NotImplementedError(
                "fit: not ported yet: " + "; ".join(missing))

    def set_divergence_guard(self, guard) -> None:
        """(Un)install a ``resilience.DivergenceGuard`` on the train step
        (NaN/Inf suppression on the device and the host's skip policy;
        with ``guard.stats`` also the statistical guard, whose EWMA
        state threads through the step)."""
        core.set_divergence_guard(self, guard)

    def set_transforms(self, scan_layers=None, remat=None, loss_scale=None,
                       megastep=None) -> "MultiLayerNetwork":
        """(Re)configure the whole-net transforms (``core.
        set_transforms``): ``scan_layers``, ``remat`` (``none |
        dots_saveable | full``), ``loss_scale`` (f16 compute; True: 2**15)
        and ``megastep`` (K steps a chunk). The trajectory is the same
        with them on or off."""
        core.set_transforms(self, scan_layers, remat, loss_scale, megastep)
        return self

    @property
    def _loss_scale_active(self) -> bool:
        return core.loss_scale_active(self)

    def _score_pure(self, params, state, x, labels, mask, *, train: bool,
                    fmask=None, weights=None, rng=None):
        """The loss plus the L1/L2 penalty of ``x`` (``core.
        sequential_score``, training under the model's ``remat``, masks
        drawn from the step's key ``rng``); returns ``(score,
        new_state)``."""
        return core.sequential_score(self.conf, self.layer_names, params,
                                     state, x, labels, mask, train=train,
                                     fmask=fmask, weights=weights,
                                     remat=self.remat if train else "none",
                                     rng=rng)

    def recurrent_names(self) -> List[str]:
        return [n for n, layer in zip(self.layer_names, self.conf.layers)
                if layer.is_recurrent()]

    def layer_confs(self) -> list:
        return list(self.conf.layers)

    def _train_step(self):
        def score_fn(params, state, x, labels, mask, fmask, rng):
            return self._score_pure(params, state, x, labels, mask,
                                    train=True, fmask=fmask, rng=rng)

        return core.model_step(self, score_fn)

    def fit(self, data, labels=None, *, epochs: int = 1, grad_accum=None,
            megastep=None) -> None:
        """fit(DataSetIterator) / fit(DataSet) / fit(x, y) (reference
        ``fit:1048``). ``data`` may be an iterable of objects with
        ``.features`` / ``.labels`` (and optional ``.labels_mask``),
        one such object, or the features of an (x, y) pair. An iterator
        with ``reset()`` is reset after each epoch. ``grad_accum=K``:
        each optimizer step accumulates K equal microbatches (persists
        until changed; BatchNormalization configurations and truncated
        BPTT refuse it). ``megastep=K`` runs each block of K same-shaped
        minibatches as one chunk with one readback (``core.
        fit_epoch_megastep``; persists until changed, 1 restores the
        per-step loop; what ``core.can_megastep`` refuses runs per
        step)."""
        if grad_accum is not None:
            core.set_grad_accum(self, grad_accum)
        if megastep is not None:
            core.set_transforms(self, megastep=megastep)
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
            if core.can_megastep(self):
                n_batches = core.fit_epoch_megastep(self, batches)
            else:
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
        """One minibatch through ``conf.iterations`` optimizer steps, or
        under truncated BPTT one step a chunk; returns the last step's
        score as a 0-d tensor on the device."""
        if self.params is None:
            self.init()
        self._check_trainable()
        # a model left sharded by a zero=True trainer steps canonical
        core.canonicalize_updater_state(self)
        x, y, mask, fmask = self.batch_tensors(ds)
        self._last_batch_rows = int(x.shape[0])
        if (self.conf.backprop_type == "TruncatedBPTT" and x.dim() == 3
                and x.shape[2] > self.conf.tbptt_fwd_length):
            return self._fit_tbptt(x, y, mask, fmask)
        core.check_grad_accum_batch(self.grad_accum, int(x.shape[0]))
        score = None
        for _ in range(self.conf.iterations):
            score = self._one_step(x, y, mask, fmask)
            # each pass over the minibatch starts from a zero carry
            self._reset_recurrent_state()
        return score

    def batch_tensors(self, ds, device=None):
        """(features, labels, labels mask, features mask) of a DataSet as
        the step takes them: tensors on the network's device (or
        ``device``) in the configuration's dtype (masks may be None)."""
        dtype = core.dtype_of(self.conf)
        dev = self.device if device is None else device
        return tuple(None if a is None else core.to_device(a, dev, dtype)
                     for a in (ds.features, ds.labels,
                               getattr(ds, "labels_mask", None),
                               getattr(ds, "features_mask", None)))

    def _ds_scan_sig(self, ds) -> tuple:
        """The shapes and dtypes of a minibatch's fields: a megastep
        chunk stacks minibatches of one signature."""
        return tuple(core.field_sig(a) for a in (
            ds.features, ds.labels, getattr(ds, "labels_mask", None),
            getattr(ds, "features_mask", None)))

    def _stack_chunk(self, batches) -> core.Chunk:
        """Same-signature minibatches stacked into a ``core.Chunk``."""
        dtype = core.dtype_of(self.conf)

        def stack(get):
            arrays = [get(b) for b in batches]
            return (None if arrays[0] is None
                    else core.stack_fields(arrays, dtype))

        return core.Chunk(
            stack(lambda b: b.features), stack(lambda b: b.labels),
            stack(lambda b: getattr(b, "labels_mask", None)),
            stack(lambda b: getattr(b, "features_mask", None)),
            len(batches), int(np.shape(batches[0].features)[0]))

    def _one_step(self, x, y, mask, fmask) -> torch.Tensor:
        return core.run_step(self, self._train_step(), x, y, mask, fmask)

    def _reset_recurrent_state(self) -> None:
        """The recurrent carry does not persist across minibatches
        (reference: reset per fit call)."""
        for name, layer in zip(self.layer_names, self.conf.layers):
            if layer.is_recurrent():
                self.state[name] = {}

    def _fit_tbptt(self, x, y, mask, fmask) -> torch.Tensor:
        """Truncated BPTT: cut the time axis into ``tbptt_fwd_length``
        chunks and carry the recurrent state from chunk to chunk
        (reference ``doTruncatedBPTT:1210``, state carry ``:1259-1276``);
        the layers hand the carry on detached, so each chunk
        backpropagates through itself alone."""
        fwd = self.conf.tbptt_fwd_length
        self._reset_recurrent_state()
        score = None
        for start in range(0, int(x.shape[2]), fwd):
            end = start + fwd
            score = self._one_step(
                x[:, :, start:end].contiguous(),
                y[:, :, start:end].contiguous() if y.dim() == 3 else y,
                None if mask is None else mask[:, start:end].contiguous(),
                None if fmask is None else fmask[:, start:end].contiguous())
        self._reset_recurrent_state()
        return score

    # -- streaming RNN inference (reference rnnTimeStep:2290) ------------

    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed one (or a few) timesteps, carrying the recurrent state
        across calls (reference ``rnnTimeStep``; state in
        ``stateMap``). Input ``[b, size]`` or ``[b, size, t]``."""
        if self.params is None:
            self.init()
        for name, layer in zip(self.layer_names, self.conf.layers):
            if not layer.can_stream():
                raise ValueError(
                    f"Layer '{name}' ({type(layer).__name__}) cannot be "
                    "used with rnn_time_step: it needs the full sequence "
                    "(reference throws UnsupportedOperationException)")
        dtype = core.dtype_of(self.conf)
        named = list(zip(self.layer_names, self.conf.layers))
        with torch.inference_mode():
            xt = self._to_device(x, dtype)
            squeeze = xt.dim() == 2
            if squeeze:
                xt = xt[:, :, None]
            t_new = int(xt.shape[2])
            core.stream_guard_and_prime(named, self._rnn_state,
                                        self._stream_steps, t_new,
                                        int(xt.shape[0]), dtype, self.device)
            merged = dict(self.state)
            for name, carry in self._rnn_state.items():
                merged[name] = {**merged.get(name, {}), **carry}
            out, new_state = core.sequential_forward(
                self.conf, self.layer_names, self.params, merged, xt,
                train=False)
            core.extract_stream_state(named, new_state, self._rnn_state)
        self._stream_steps += t_new
        return out[:, :, 0] if squeeze else out

    def rnn_clear_previous_state(self) -> None:
        """Reference ``rnnClearPreviousState``."""
        self._rnn_state = {}
        self._stream_steps = 0

    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return sum(t.numel() for lp in self.params.values()
                   for t in lp.values())

"""``MultiLayerNetwork``: the sequential-network engine.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` for ``init``,
``output``, ``output_padded``, ``predict``, ``feed_forward_to_layer``,
``summary``, ``fit``, ``fit_minibatch``, ``score``, truncated BPTT,
``rnn_time_step`` and ``rnn_clear_previous_state``; ``evaluate``
(``eval/``), ``params_flat`` / ``set_params_flat``, ``copy`` and the
``aot_*`` entry points are ``nn/engine_api.py``'s, shared with the graph
engine.
Parameters are a plain dictionary ``{layer name: {param name: tensor}}``
on the network's device, keyed as in the JAX package (layer names are
``conf.layer_name(i)``), so a checkpoint's ``"<layer>/<param>"`` arrays
map onto it 1:1; the updater state ``{layer: {param: (tensor, ...)}}``
likewise maps onto ``"<layer>/<param>/<i>"``, and the layer state
``{layer: {key: tensor}}`` (BatchNormalization's running ``mean`` and
``var``) onto ``"<layer>/<key>"``. At inference a Conv(identity) ->
BatchNormalization pair runs as one conv kernel launch (``nn/core.py``).

Training's unit is the step of ``nn/core.py`` ``build_step`` (the scan
path below runs it k times a chunk, bitwise the same): each minibatch
runs ``conf.iterations`` optimizer steps at the
scheduled learning rates, with Adam's ``t = iteration + 1`` (with
``fit(grad_accum=K)`` each step runs K contiguous microbatches), and
the recurrent carry is reset after each. Inputs cross to the device at
their own width where they are uint8 / int8 / int16 and are cast there
(``core.to_device``). Under truncated BPTT a minibatch
longer than ``tbptt_fwd_length`` is cut into chunks along time, one
optimizer step and one iteration a chunk, with the carry handed from
chunk to chunk (the JAX package's chunk loop); where ``_can_fuse_tbptt``
allows it the segments run as one chunk of the fused TBPTT scan
(``core.build_multi_step(tbptt=True)``: the carry threads through the
chunk, zeroed at each minibatch's first segment), on the card one
CUDA-graph replay.
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
bitwise the per-step loop. With its default ``scan_chunk = 16``
``fit`` runs up to 16 same-shaped minibatches as one chunk of the bare
step (``core.fit_epoch_scan``), and a multi-epoch fit of a list within
``device_cache_bytes`` keeps its chunks on the device
(``core.fit_epochs_device_cached``; the TBPTT plan ``_tbptt_cached_plan``
up to 16 minibatches' segments a chunk); ``scan_chunk = 1`` is the
per-step loop. ``fit`` runs the epoch loop of
``core.fit_batches``: the listeners (``set_listeners``), the batch
validator (``set_batch_validator``), the preemption check, and the
dispatch window (``max_in_flight`` / ``guard_lag``); ``resume`` and
``fit(resume_from=)`` restore a checkpoint into the network
(``resilience/checkpoint.py``). A configuration whose
``optimization_algo`` is LBFGS, CONJUGATE_GRADIENT or
LINE_GRADIENT_DESCENT trains each minibatch through
``optimize/solvers.py``'s ``Solver`` (built once, its LBFGS / CG state
kept across calls), which the per-step loop reaches through
``fit_minibatch`` (the chunk paths are the SGD step's). ``pretrain``
fits each pretrainable layer (AutoEncoder, RBM, VariationalAutoencoder)
on the frozen stack's activations, layer ``idx``'s iteration ``it``
drawing from ``fold_in(fold_in(PRNGKey(conf.seed), 7919 + idx), it)``;
``fit`` pretrains once first where ``conf.pretrain`` asks for it, and
stops there with ``backprop=False``.
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
from deeplearning4j_tpu_torch.nn.engine_api import EngineApi
from deeplearning4j_tpu_torch.nn.updaters import MultiLayerUpdaterDef
from deeplearning4j_tpu_torch.observability import profiler
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


class MultiLayerNetwork(EngineApi):
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
        self._solver = None  # built at the first line-search minibatch
        self._pretrain_done = False
        # the transform knobs, the guard and their device states
        core.init_transforms(self)
        # {"shards": n} while the updater state lies in ZeRO-1's flat
        # layout (set by the distributed trainer); None: parameter-shaped
        self._zero_layout = None
        # {"shards", "rank", "layers"} while SparseEmbeddingLayer tables
        # hold this rank's rows only (the distributed trainer); None: whole
        self._row_layout = None
        self._tp_layout = None
        # rnn_time_step's carried state (the reference's stateMap)
        self._rnn_state: Dict[str, dict] = {}
        self._stream_steps = 0
        # (shape, dtype) signatures of the inference forwards run, and
        # the input shapes of installed AOT artifacts (engine_api.py)
        self._output_signatures: set = set()
        self._aot_outputs: dict = {}

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
        self._row_layout = None
        self._tp_layout = None
        self._pretrain_done = False  # fresh parameters: pretrain again
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
            self._note_output((xt,))
            fm = (None if features_mask is None
                  else self._to_device(features_mask, dtype))
            y, _ = core.sequential_forward(
                self.conf, self.layer_names, self.params, self.state, xt,
                train=train, fmask=fm,
                rng=core.step_rng(self, self.iteration_count)
                if train else None, tp=self._tp_layout)
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
                collect=True, tp=self._tp_layout,
                rng=random.host_key(self.conf.seed) if train else None)
        return acts

    def feed_forward_to_layer(self, layer_idx: int, x,
                              train: bool = False) -> List[torch.Tensor]:
        """The activations of layers ``[0, layer_idx]`` (JAX
        ``feed_forward_to_layer``): ``feed_forward`` cut there."""
        return self.feed_forward(x, train=train)[:int(layer_idx) + 1]

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (reference ``predict``)."""
        return self.output(x).argmax(dim=1).cpu().numpy()

    def _evaluate_one(self, e, ds) -> None:
        from deeplearning4j_tpu_torch.eval.evaluation import host_array

        out = self.output(ds.features,
                          features_mask=getattr(ds, "features_mask", None))
        labels = host_array(ds.labels)
        m = getattr(ds, "labels_mask", None)
        if m is None and labels.ndim == 3:
            # per-timestep eval falls back to the features mask; 2-d
            # (per-sequence) labels must NOT — a [b, t] mask cannot
            # index b rows
            m = getattr(ds, "features_mask", None)
        e.eval(labels, out, mask=m)

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
                fmask=self._maybe_to_device(fmask, dtype),
                tp=self._tp_layout)
        return float(s)

    def _maybe_to_device(self, a, dtype) -> Optional[torch.Tensor]:
        return None if a is None else self._to_device(a, dtype)

    # -- training ----------------------------------------------------------

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
                                     rng=rng, tp=self._tp_layout)

    def recurrent_names(self) -> List[str]:
        return [n for n, layer in zip(self.layer_names, self.conf.layers)
                if layer.is_recurrent()]

    def layer_confs(self) -> list:
        return list(self.conf.layers)

    def _score_fn(self):
        def score_fn(params, state, x, labels, mask, fmask, rng):
            return self._score_pure(params, state, x, labels, mask,
                                    train=True, fmask=fmask, rng=rng)

        return score_fn

    def _train_step(self):
        return core.model_step(self, self._score_fn())

    def _scan_step(self, tbptt: bool = False):
        """The scan path's bare step (``core.build_multi_step``)."""
        return core.scan_step(self, self._score_fn(), tbptt)

    def enable_step_telemetry(self, enabled: bool = True) -> None:
        """(Un)install step telemetry: the step also returns the
        gradient's global L2 norm (``_last_grad_norm``, a device scalar;
        ``core.enable_step_telemetry``)."""
        core.enable_step_telemetry(self, enabled)

    def _can_scan_steps(self) -> bool:
        """The scan path applies (JAX ``_can_scan_steps``): one iteration
        a minibatch, backprop without truncated BPTT, the SGD solver, no
        divergence guard, no loss scaling, and listeners that take a
        chunk's callbacks after it (``supports_batched_iterations``)."""
        conf = self.conf
        return (conf.iterations == 1 and conf.backprop
                and conf.backprop_type != "TruncatedBPTT"
                and conf.optimization_algo == "STOCHASTIC_GRADIENT_DESCENT"
                and self.divergence_guard is None
                and not self._loss_scale_active
                and core.batched_listeners(self))

    def fit(self, data, labels=None, *, epochs: int = 1, resume_from=None,
            grad_accum=None, megastep=None) -> None:
        """fit(DataSetIterator) / fit(DataSet) / fit(x, y) (reference
        ``fit:1048``). ``data`` may be an iterable of objects with
        ``.features`` / ``.labels`` (and optional ``.labels_mask``),
        one such object, or the features of an (x, y) pair. An iterator
        with ``reset()`` is reset after each epoch. ``resume_from``: a
        ``CheckpointManager`` or a checkpoint zip restored first
        (``resume``); the caller feeds the stream from the restored
        step. ``grad_accum=K``: each optimizer step accumulates K equal
        microbatches (persists until changed; BatchNormalization
        configurations and truncated BPTT refuse it). ``megastep=K``
        runs each block of K same-shaped minibatches as one chunk with
        one readback (``core.fit_epoch_megastep``; persists until
        changed, 1 restores the per-step loop; what
        ``core.can_megastep`` refuses runs per step). The loop itself is
        ``core.fit_batches``."""
        if grad_accum is not None:
            core.set_grad_accum(self, grad_accum)
        if megastep is not None:
            core.set_transforms(self, megastep=megastep)
        if resume_from is not None:
            self.resume(resume_from)
        core.fit_batches(self, data, labels, epochs)

    def resume(self, source, load_updater: bool = True) -> int:
        """Restore a checkpoint into this network (its configuration
        must match): the parameters, updater state, layer state and the
        iteration and epoch counts. ``source`` is a
        ``resilience.CheckpointManager`` (its newest restorable version,
        falling back past corrupted ones) or a checkpoint zip. Returns
        the restored step. The continuation is exact: the step keys,
        the learning-rate schedule and Adam's ``t`` derive from the
        iteration count."""
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            restore_into,
        )

        _, step = restore_into(self, source, load_updater=load_updater)
        return step

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def set_batch_validator(self, validator, quarantine=None) -> None:
        """(Un)install the data-plane defense on ``fit`` (a
        ``datasets.BatchValidator``; rejects go to ``quarantine``, a
        ``QuarantineStore``, and do not advance the iteration count)."""
        core.set_batch_validator(self, validator, quarantine)

    def fit_minibatch(self, ds) -> torch.Tensor:
        """One minibatch through ``conf.iterations`` optimizer steps (a
        line-search solver's where ``optimization_algo`` names one), or
        under truncated BPTT one step a chunk; returns the last step's
        score as a 0-d tensor on the device."""
        from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet

        if isinstance(ds, ChunkedDataSet):
            score = None
            for b in ds.to_datasets():
                score = self.fit_minibatch(b)
            return score
        if self.params is None:
            self.init()
        if self.conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT":
            return self._solver_minibatch(
                ds.features, ds.labels, getattr(ds, "labels_mask", None),
                getattr(ds, "features_mask", None))
        # a model left sharded by a zero=True trainer steps canonical
        core.canonicalize_updater_state(self)
        x, y, mask, fmask = self.batch_tensors(ds)
        self._last_batch_rows = int(x.shape[0])
        if (self.conf.backprop_type == "TruncatedBPTT" and x.dim() == 3
                and x.shape[2] > self.conf.tbptt_fwd_length):
            return self._fit_tbptt(x, y, mask, fmask)
        if self._wants_last_features():
            self._last_features = ds.features  # activation listeners
        core.check_grad_accum_batch(self.grad_accum, int(x.shape[0]))
        prof = profiler.get_active_profiler()
        if prof is not None:
            prof.begin_step(self.iteration_count + 1, device=self.device)
        score = None
        for _ in range(self.conf.iterations):
            score = self._one_step(x, y, mask, fmask)
            # each pass over the minibatch starts from a zero carry
            self._reset_recurrent_state()
        if prof is not None:
            prof.end_step(model=self, ds=ds, score=self._last_score,
                          grad_norm=self._last_grad_norm,
                          rows=self._last_batch_rows)
        return score

    def _wants_last_features(self) -> bool:
        """Snapshot the minibatch (``_last_features``) only when a
        listener asks for it (``needs_last_features``): holding it
        unconditionally would pin the caller's features for the model's
        lifetime. Each fit path takes the caller's own features of its
        last minibatch (``core.note_last_features``), never a chunk's
        static input buffer, which the next chunk's fill overwrites."""
        return any(getattr(listener, "needs_last_features", False)
                   for listener in self.listeners)

    # -- layer-wise pretraining (reference pretrain(iter)) -----------------

    def _input_to_layer_pure(self, params, state, x, idx: int):
        """The input layer ``idx`` sees: the inference forward through
        layers ``[0, idx)``, then ``idx``'s own preprocessor."""
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
            ShapeContext,
        )

        ctx = ShapeContext(batch=int(x.shape[0]),
                           time=int(x.shape[2]) if x.dim() == 3 else -1)
        for i in range(idx):
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i].preprocess(x, ctx)
            name = self.layer_names[i]
            x, _ = self.conf.layers[i].apply(
                params[name], x.contiguous(), state.get(name, {}),
                train=False, rng=None)
        if idx in self.conf.preprocessors:
            x = self.conf.preprocessors[idx].preprocess(x, ctx)
        return x.contiguous()

    def pretrain(self, data, epochs: int = 1) -> None:
        """Greedy layer-wise unsupervised pretraining (reference
        ``pretrain(DataSetIterator)``): each pretrainable layer in order
        fits its ``pretrain_loss`` on the activations of the frozen
        stack below it, computed once a batch, ``conf.iterations``
        updates a batch with the layer's own updater (fresh state, the
        learning-rate schedule counted from 0). ``data``: a DataSet, a
        list or iterator of them, or an ``(x, y)`` pair."""
        from deeplearning4j_tpu_torch.datasets.api import DataSet

        if self.params is None:
            self.init()
        if (isinstance(data, tuple) and len(data) == 2
                and not hasattr(data[0], "features")):
            data = [DataSet(features=data[0], labels=data[1])]
        data = core.pretrain_batches(data)
        dtype = core.dtype_of(self.conf)
        base = random.host_key(self.conf.seed)
        for idx, (name, layer) in enumerate(zip(self.layer_names,
                                                self.conf.layers)):
            if not layer.is_pretrainable():
                continue

            @torch.no_grad()
            def layer_input(ds, idx=idx):
                x = self._to_device(
                    ds.features if hasattr(ds, "features") else ds, dtype)
                return self._input_to_layer_pure(self.params, self.state, x,
                                                 idx)

            core.pretrain_layer(self, name, layer,
                                random.fold_in(base, 7919 + idx), data,
                                epochs, layer_input)
        self._pretrain_done = True

    def batch_tensors(self, ds, device=None):
        """(features, labels, labels mask, features mask) of a DataSet as
        the step takes them: tensors on the network's device (or
        ``device``) in the configuration's dtype (masks may be None)."""
        dtype = core.dtype_of(self.conf)
        dev = self.device if device is None else device
        if hasattr(ds, "wait"):  # placed by an input pipeline
            ds.wait()
        return tuple(None if a is None else core.to_device(a, dev, dtype)
                     for a in (ds.features, ds.labels,
                               getattr(ds, "labels_mask", None),
                               getattr(ds, "features_mask", None)))

    def _ds_scan_sig(self, ds) -> tuple:
        """The shapes and dtypes of a minibatch's fields: a megastep or
        scan chunk stacks minibatches of one signature."""
        return tuple(core.field_sig(a) for a in (
            ds.features, ds.labels, getattr(ds, "labels_mask", None),
            getattr(ds, "features_mask", None)))

    def _stack_chunk(self, batches) -> core.Chunk:
        """Same-signature minibatches stacked into a ``core.Chunk``; a
        placed minibatch (``PlacedDataSet``) is waited on first, so the
        stack reads its copies after they land."""
        dtype = core.dtype_of(self.conf)
        for b in batches:
            if hasattr(b, "wait"):
                b.wait()

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
        backpropagates through itself alone. Where ``_can_fuse_tbptt``
        allows it the chunks run as one fused scan chunk
        (``_run_tbptt_stacked``), else one step each."""
        fwd = self.conf.tbptt_fwd_length
        if self._can_fuse_tbptt(x, y, fwd):
            return self._run_tbptt_stacked(
                self._stack_tbptt(x, y, mask, fmask))
        self._reset_recurrent_state()
        score = None
        for start in range(0, int(x.shape[2]), fwd):
            end = start + fwd
            score = self._one_step(
                x[:, :, start:end].contiguous(),
                y[:, :, start:end].contiguous() if y.dim() == 3 else y,
                None if mask is None else mask[:, start:end].contiguous(),
                None if fmask is None else fmask[:, start:end].contiguous())
        self._tbptt_carry = self._recurrent_carry()
        self._reset_recurrent_state()
        return score

    def _recurrent_carry(self) -> dict:
        """The recurrent layers' state entries (the carry a TBPTT
        minibatch ended with, kept as ``_tbptt_carry``)."""
        return {n: dict(self.state.get(n, {}))
                for n in self.recurrent_names()}

    def _can_fuse_tbptt(self, x, y, fwd: int) -> bool:
        """The fused TBPTT scan applies (JAX ``_can_fuse_tbptt``): the
        segments tile the sequence, the labels are per time step, one
        iteration a minibatch, no guard, no loss scaling, every
        recurrent layer keeps an h / c carry, listeners that take a
        chunk's callbacks after it; and ``scan_chunk`` > 1 (1 is the
        per-segment loop)."""
        return (int(self.scan_chunk) > 1 and self.conf.iterations == 1
                and np.ndim(x) == 3 and int(np.shape(x)[2]) % fwd == 0
                and np.ndim(y) == 3
                and int(np.shape(y)[2]) == int(np.shape(x)[2])
                and self.divergence_guard is None
                and not self._loss_scale_active
                and all(layer.can_stream()
                        and getattr(layer, "init_stream_state", None)
                        is not None
                        for layer in self.conf.layers
                        if layer.is_recurrent())
                and core.batched_listeners(self))

    def _stack_tbptt(self, x, y, mask, fmask) -> core.Chunk:
        """One minibatch's tensors as the fused scan's chunk of its k
        TBPTT segments: [b, n, k * fwd] -> [k, b, n, fwd] (masks [b, k *
        fwd] -> [k, b, fwd]), with the resets [1, 0, ..., 0] (JAX
        ``_stack_tbptt``)."""
        fwd = self.conf.tbptt_fwd_length
        b = int(x.shape[0])
        k = int(x.shape[2]) // fwd

        def seg3(v):
            return v.reshape(v.shape[0], v.shape[1], k, fwd).permute(
                2, 0, 1, 3).contiguous()

        def seg2(m):
            return (None if m is None else
                    m.reshape(b, k, fwd).permute(1, 0, 2).contiguous())

        resets = torch.zeros(k, dtype=torch.float32, device=x.device)
        resets[0] = 1.0
        return core.Chunk(seg3(x), seg3(y), seg2(mask), seg2(fmask), k, b,
                          resets=resets)

    def _run_tbptt_stacked(self, chunk: core.Chunk) -> torch.Tensor:
        """One chunk of the fused TBPTT scan (JAX ``_run_tbptt_stacked``):
        the recurrent carries primed with zeros, the chunk's segments
        through the TBPTT scan step (one replay on the card, no
        readback), the listeners' callbacks for each step, the carry
        dropped after it. Returns the last score (a device scalar)."""
        cdt = core.compute_dtype_of(self.conf)
        state = dict(self.state)
        for name, layer in zip(self.layer_names, self.conf.layers):
            if layer.is_recurrent():
                state[name] = layer.init_stream_state(chunk.rows, cdt,
                                                      self.device)
        core.canonicalize_updater_state(self)
        launched = core.launch_chunk(self, chunk, self._scan_step(True),
                                     state=state, readback=False,
                                     hint="scan_chunk=1")
        core.finish_scan_chunk(self, launched)
        self._tbptt_carry = self._recurrent_carry()
        self._reset_recurrent_state()
        return self._last_score

    def _fit_epochs_device_cached(self, batches, epochs: int) -> bool:
        return core.fit_epochs_device_cached(
            self, batches, epochs,
            lambda ds: (ds.features, ds.labels,
                        getattr(ds, "labels_mask", None),
                        getattr(ds, "features_mask", None)),
            extra_plan_fn=self._tbptt_cached_plan)

    def _tbptt_cached_plan(self, batches, epochs: int):
        """The device-cached plan of a fused-TBPTT fit (JAX
        ``_tbptt_cached_plan``): each minibatch's segment chunk placed on
        the device once, consecutive same-shaped ones merged into
        balanced chunks of up to ``scan_chunk`` minibatches (their resets
        zero the carry at each minibatch's first segment), replayed every
        epoch. None
        where the configuration or the data does not qualify, or the
        data exceeds ``device_cache_bytes``."""
        conf = self.conf
        if (epochs <= 1 or not isinstance(batches, (list, tuple))
                or len(batches) == 0
                or not all(hasattr(ds, "features") for ds in batches)
                or conf.backprop_type != "TruncatedBPTT"
                or conf.iterations != 1
                or conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT"
                or not core.batched_listeners(self)):
            return None
        fwd = conf.tbptt_fwd_length
        total = 0
        for ds in batches:
            x, y = ds.features, ds.labels
            if (np.ndim(x) != 3 or int(np.shape(x)[2]) <= fwd
                    or not self._can_fuse_tbptt(x, y, fwd)):
                return None
            total += sum(core.nbytes(a) for a in (
                x, y, getattr(ds, "labels_mask", None),
                getattr(ds, "features_mask", None)))
        if total > self.device_cache_bytes:
            return None
        stacks = [(self._stack_tbptt(*self.batch_tensors(ds)), ds)
                  for ds in batches]

        def merge(items):
            parts = [c for c, _ in items]

            def cat(get):
                first = get(parts[0])
                return (None if first is None else
                        torch.cat([get(c) for c in parts]))

            return core.Chunk(
                cat(lambda c: c.xs), cat(lambda c: c.ys),
                cat(lambda c: c.lmasks), cat(lambda c: c.fmasks),
                sum(c.k for c in parts), parts[0].rows,
                resets=cat(lambda c: c.resets))

        plan = core.build_scan_plan(
            stacks, lambda item: tuple(
                None if a is None else tuple(a.shape)
                for a in item[0].fields[:4]),
            merge, self.scan_chunk)
        return [("tbptt", item[0] if kind == "single" else item, last[1])
                for kind, item, last in plan]

    # -- streaming RNN inference (reference rnnTimeStep:2290) ------------

    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed one (or a few) timesteps, carrying the recurrent state
        across calls (reference ``rnnTimeStep``; state in
        ``stateMap``). Input ``[b, size]`` or ``[b, size, t]``."""
        if self.params is None:
            self.init()
        named = list(zip(self.layer_names, self.conf.layers))
        core.refuse_unstreamable(named, "Layer")
        with torch.inference_mode():
            xt = self._to_device(x, core.dtype_of(self.conf))
            squeeze = xt.dim() == 2
            if squeeze:
                xt = xt[:, :, None]
            out = core.stream_forward(
                self, named, int(xt.shape[2]), int(xt.shape[0]),
                lambda state: core.sequential_forward(
                    self.conf, self.layer_names, self.params, state, xt,
                    train=False, tp=self._tp_layout))
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

    def _param_owners(self) -> List[str]:
        return self.layer_names

    def _aot_shape_key(self, shape) -> tuple:
        return tuple(int(d) for d in shape)

    def summary(self) -> str:
        """The JAX engine's table: one line a layer, its parameter
        count, the total."""
        lines = ["=" * 70, f"{'idx/name':<16}{'type':<28}{'params':>10}",
                 "-" * 70]
        total = 0
        for name, layer in zip(self.layer_names, self.conf.layers):
            n = sum(p.numel() for p in self.params[name].values()
                    ) if self.params else 0
            total += n
            lines.append(f"{name:<16}{type(layer).__name__:<28}{n:>10}")
        lines += ["-" * 70, f"Total params: {total}", "=" * 70]
        return "\n".join(lines)

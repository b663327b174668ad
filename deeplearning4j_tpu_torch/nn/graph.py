"""``ComputationGraph``: the DAG engine.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` for ``init``,
``output``, ``feed_forward``, ``score``, ``fit``, ``fit_minibatch``,
``num_params`` and ``params_flat`` / ``set_params_flat``. The forward
walks the configuration's topological order with a ``{name: value}``
map; each graph input's [batch, time] features mask follows its branch
(a ``LastTimeStepVertex`` clears it downstream), and the output
vertices' losses sum. Parameters, layer state (BatchNormalization's
running statistics) and updater state are dictionaries keyed by vertex
name, as the JAX engine's are, so a checkpoint's ``"<vertex>/<param>"``
arrays map onto them 1:1.

Training's unit is the step of ``nn/core.py`` (``build_step``; the
scan path below runs it k times a chunk, bitwise the same): each
minibatch runs ``conf.iterations`` optimizer steps at the scheduled
learning rates, with ``fit(grad_accum=K)`` as K contiguous microbatches
a step. Inputs cross to the device at their own width where they are
uint8 / int8 / int16 and are cast there (``core.to_device``). As in the
JAX engine, ``scan_chunk`` (default 16) runs that many same-shaped
minibatches as one chunk of the bare step (``core.fit_epoch_scan``; on
the card one CUDA-graph replay) and a multi-epoch fit of a list within
``device_cache_bytes`` keeps its chunks on the device
(``core.fit_epochs_device_cached``), with the per-step trajectory;
``scan_chunk = 1`` is the per-step loop. The step's flavours (loss
scaling under f16 compute, the divergence and statistical guards), the
whole-net transforms (``remat`` per layer vertex, ``scan_layers``) and
``fit(megastep=K)`` (K steps a chunk, on the card one CUDA-graph
replay) are the sequential engine's (``nn/core.py``), and so are
``fit``'s epoch loop (``core.fit_batches``: listeners, the batch
validator, the preemption check, the dispatch window), ``resume`` /
``fit(resume_from=)``, and dropout and drop-connect: vertex i of the topological order draws from
``fold_in(step key, i)``, the output vertex's pre-output with the masks
of its ``apply``. ``output_padded`` (the serving bucket's forward),
``copy``, ``summary``, ``evaluate`` (of the first output vertex) and the
``aot_*`` entry points are the shared ones of ``nn/engine_api.py``.
Truncated BPTT (``_fit_tbptt``: every time-bearing input, label and mask
cut into ``tbptt_fwd_length`` segments, one step each, the recurrent
carry handed from segment to segment; inputs without a time axis ride
along whole) and ``rnn_time_step`` / ``rnn_clear_previous_state`` (the
streaming carry of every layer vertex, the JAX engine's 2-d / 3-d
convention) are the JAX engine's. So are the line-search solvers
(``optimize/solvers.py``'s ``Solver`` on the lists of inputs, labels
and masks, through ``fit_minibatch``) and ``pretrain``: each
pretrainable layer vertex in topological order fits its
``pretrain_loss`` on what the frozen graph feeds it, vertex ``i`` of the
order drawing iteration ``it`` from ``fold_in(fold_in(PRNGKey(seed),
7919 + i), it)``; ``fit`` pretrains once first where ``conf.pretrain``
asks for it, and stops there with ``backprop=False``.
Like the JAX engine, this one folds no Conv -> BatchNormalization pair
(that peephole is the sequential engine's, ``nn/core.py``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import core, random
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    LastTimeStepVertex,
    LayerVertex,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import ShapeContext
from deeplearning4j_tpu_torch.nn.engine_api import EngineApi
from deeplearning4j_tpu_torch.nn.updaters import MultiLayerUpdaterDef
from deeplearning4j_tpu_torch.observability import profiler
from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _ds_arrays(ds):
    """(features, labels, features masks or None, labels masks or None)
    of a DataSet or MultiDataSet-like object, each a list."""
    fmasks = _as_list(getattr(ds, "features_masks", None)
                      or getattr(ds, "features_mask", None))
    lmasks = _as_list(getattr(ds, "labels_masks", None)
                      or getattr(ds, "labels_mask", None))
    return (_as_list(ds.features), _as_list(ds.labels), fmasks or None,
            lmasks or None)


class ComputationGraph(EngineApi):
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        """``device`` defaults to ``"cuda"`` and raises without a card;
        pass ``"cpu"`` for the plain PyTorch versions of the kernels."""
        self.conf = conf
        self.device = resolve_device(device)
        self.topo: List[str] = conf.topological_order()
        self.layer_vertex_names: List[str] = [
            n for n in self.topo if isinstance(conf.vertices[n], LayerVertex)]
        self.updater_def = MultiLayerUpdaterDef({
            n: conf.vertices[n].layer_conf.updater_settings()
            for n in self.layer_vertex_names})
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.state: Dict[str, dict] = {}
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
        # (shape, dtype) signatures of the inference forwards run, and
        # the input shapes of installed AOT artifacts (engine_api.py)
        self._output_signatures: set = set()
        self._aot_outputs: dict = {}
        # rnn_time_step's carry by vertex and the timesteps it has seen
        self._rnn_state: Dict[str, dict] = {}
        self._stream_steps = 0

    @property
    def score_value(self) -> float:
        """The latest minibatch score (reading it waits for the card)."""
        return float(self._last_score)

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return core.to_device(a, self.device, dtype)

    def _tensors(self, arrays, device=None
                 ) -> Optional[List[Optional[torch.Tensor]]]:
        """Host or device arrays -> tensors on the device (or
        ``device``) in the configuration's dtype; None stays None."""
        if arrays is None:
            return None
        dtype = core.dtype_of(self.conf)
        dev = self.device if device is None else device
        return [None if a is None else core.to_device(a, dev, dtype)
                for a in arrays]

    def _layer(self, name: str):
        return self.conf.vertices[name].layer_conf

    # ------------------------------------------------------------------

    def init(self, params: Optional[dict] = None) -> "ComputationGraph":
        """Fresh weights from ``conf.seed`` (one CPU ``torch.Generator``
        drawn in topological order, then moved to the device), or the
        given ``{vertex: {param: array}}``. Layer vertices without
        parameters may be missing from ``params``; a missing
        parameterized vertex raises. Layer state and updater state start
        fresh."""
        dtype = core.dtype_of(self.conf)
        if params is not None:
            restored = {}
            for n in self.layer_vertex_names:
                if n in params:
                    restored[n] = {pn: self._to_device(a, dtype)
                                   for pn, a in params[n].items()}
                elif self._layer(n).init_params(torch.Generator(), dtype):
                    raise ValueError(
                        f"checkpoint has no params for vertex '{n}'")
                else:
                    restored[n] = {}
            self.params = restored
        else:
            gen = torch.Generator().manual_seed(int(self.conf.seed))
            self.params = {
                n: {pn: t.to(self.device) for pn, t in
                    self.conf.vertices[n].init_params(gen, dtype).items()}
                for n in self.layer_vertex_names}
        self.state = {
            n: {k: t.to(self.device) for k, t in
                self.conf.vertices[n].init_state(dtype).items()}
            for n in self.layer_vertex_names}
        self.updater_state = self.updater_def.init(self.params)
        self._zero_layout = None
        self._row_layout = None
        self._tp_layout = None
        self._pretrain_done = False  # fresh parameters: pretrain again
        return self

    # ------------------------------------------------------------------

    def _forward_values(self, params, state, inputs, *, train: bool,
                        fmasks=None, preout: bool = False,
                        remat: str = "none", rng=None):
        """Walk the topological order; returns ``({vertex: value},
        preouts, new_state)``. With ``preout`` an output vertex that
        carries a loss gives its pre-activation (what its loss reads, on
        the input dropout and drop-connect mask of its ``apply``) and
        runs its own forward only where another vertex reads it. ``rng``
        is the step's key: vertex i of the topological order draws from
        ``fold_in(rng, i)`` (JAX ``lrng``).
        ``remat`` (training only) recomputes each layer vertex's forward
        in the backward (``core.maybe_remat``)."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            layer_params,
        )

        conf = self.conf
        cdt = core.compute_dtype_of(conf)
        if cdt != core.dtype_of(conf):
            params = {ln: {pn: (t.to(cdt) if t.is_floating_point() else t)
                           for pn, t in lp.items()}
                      for ln, lp in params.items()}
            inputs = [x.to(cdt) for x in inputs]
            if fmasks is not None:
                fmasks = [None if m is None else m.to(cdt) for m in fmasks]
        # the shape context of the whole minibatch for the preprocessors
        gctx = ShapeContext(
            batch=int(inputs[0].shape[0]) if inputs else 0,
            time=max((int(x.shape[2]) for x in inputs if x.dim() == 3),
                     default=-1))
        values: Dict[str, torch.Tensor] = dict(zip(conf.inputs, inputs))
        masks = {} if fmasks is None else {
            n: m for n, m in zip(conf.inputs, fmasks) if m is not None}
        vmask: Dict[str, Optional[torch.Tensor]] = dict(masks)
        read = {s for ins in conf.vertex_inputs.values() for s in ins}
        new_state = dict(state)
        preouts: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(self.topo):
            v = conf.vertices[name]
            srcs = conf.vertex_inputs[name]
            vin = [values[s] for s in srcs]
            mask = next((vmask[s] for s in srcs
                         if vmask.get(s) is not None), None)
            if isinstance(v, LayerVertex):
                layer = v.layer_conf
                vparams = layer_params(self._tp_layout, name, layer,
                                       params.get(name, {}))
                lrng = core.layer_rng(rng, i, layer, train)
                if preout and name in conf.outputs and layer.has_loss():
                    xin = layer.maybe_dropout(
                        v.layer_input(vin[0], gctx).contiguous(),
                        train=train, rng=lrng)
                    preouts[name] = layer.pre_output(
                        layer.maybe_drop_connect(vparams, train=train,
                                                 rng=lrng), xin)
                    if name not in read:
                        continue
                apply_vertex = core.maybe_remat(functools.partial(
                    v.apply, train=train, rng=lrng, mask=mask, ctx=gctx),
                    remat if train and not layer.has_loss() else "none")
                out, new_state[name] = apply_vertex(
                    vparams, vin, state.get(name, {}))
                vmask[name] = mask
            elif isinstance(v, DuplicateToTimeSeriesVertex):
                ref = values[v.reference_input]
                out, _ = v.apply({}, vin, {}, train=train,
                                 time=int(ref.shape[2]))
                vmask[name] = vmask.get(v.reference_input)
            elif isinstance(v, LastTimeStepVertex):
                m = masks.get(v.mask_input) if v.mask_input else mask
                out, _ = v.apply({}, vin, {}, train=train, mask=m)
                vmask[name] = None  # the time axis is gone
            else:
                out, _ = v.apply({}, vin, {}, train=train, mask=mask)
                vmask[name] = mask
            values[name] = out
        return values, preouts, new_state

    def _score_pure(self, params, state, inputs, labels, lmasks, *,
                    train: bool, fmasks=None, weights=None, rng=None):
        """The sum of the output vertices' losses plus the L1/L2 penalty;
        returns ``(score, new_state)``. ``weights`` = ``([one weight an
        output], penalty weight)`` scales the terms (a data-parallel
        rank's share of the global score); None: all 1."""
        from deeplearning4j_tpu_torch.nn import losses

        _, preouts, new_state = self._forward_values(
            params, state, inputs, train=train, fmasks=fmasks, preout=True,
            remat=self.remat if train else "none", rng=rng)
        score = 0.0
        for i, out_name in enumerate(self.conf.outputs):
            v = self.conf.vertices[out_name]
            layer = v.layer_conf if isinstance(v, LayerVertex) else None
            if layer is None or not layer.has_loss():
                raise ValueError(
                    f"Output vertex '{out_name}' has no loss function")
            m = lmasks[i] if lmasks is not None else None
            term = losses.score(layer.loss, labels[i], preouts[out_name],
                                layer.activation, m, True)
            score = score + (term if weights is None
                             else term * weights[0][i])
        reg = 0.0
        for n in self.layer_vertex_names:
            reg = reg + core.reg_penalty(self._layer(n), params[n], n,
                                         self._tp_layout)
        if weights is not None:
            reg = reg * weights[1]
        return score + reg, new_state

    # -- inference ---------------------------------------------------------

    def output(self, *inputs, features_masks=None) -> List[torch.Tensor]:
        """The output vertices' activations for ``inputs`` (one array or
        tensor per graph input), as tensors on the graph's device.
        ``features_masks``: one [batch, time] mask (or None) per graph
        input."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            xs = self._tensors(inputs)
            self._note_output(xs)
            values, _, _ = self._forward_values(
                self.params, self.state, xs, train=False,
                fmasks=self._tensors(_as_list(features_masks)) or None)
            return [values[n] for n in self.conf.outputs]

    def output_padded(self, *inputs, n_valid: int, features_masks=None
                      ) -> List[torch.Tensor]:
        """Inference on row-padded inputs (the serving micro-batcher's
        bucket): ``output``'s forward, each output vertex sliced to its
        first ``n_valid`` rows. Padding rows cannot perturb the valid
        ones (every inference-mode vertex is row-independent); a
        features mask covering only the ``n_valid`` rows gets all-ones
        rows for the padding (an all-zero row would poison masked
        reductions with 0/0), as in JAX's ``output_padded``."""
        n = int(n_valid)
        if not inputs:
            raise ValueError("output_padded needs at least one input")
        b = int(np.shape(inputs[0])[0])
        if not 0 < n <= b:
            raise ValueError(
                f"n_valid must be in [1, {b}] for a {b}-row batch; got {n}")
        fms = features_masks
        if fms is not None:
            padded = []
            for m in _as_list(fms):
                if m is not None:
                    m = np.asarray(m.cpu() if torch.is_tensor(m) else m)
                    if m.shape[0] == n and n < b:
                        m = np.concatenate(
                            [m, np.ones((b - n,) + m.shape[1:], m.dtype)])
                    elif m.shape[0] != b:
                        raise ValueError(
                            f"features_mask covers {m.shape[0]} rows; "
                            f"expected {n} (valid) or {b} (padded)")
                padded.append(m)
            fms = padded
        return [o[:n] for o in self.output(*inputs, features_masks=fms)]

    def feed_forward(self, *inputs, train: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """The activation of every vertex (and input) by name; with
        ``train`` the training-mode forward, dropout drawn from the key
        of the next step, as in the JAX engine."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            values, _, _ = self._forward_values(
                self.params, self.state, self._tensors(inputs), train=train,
                rng=core.step_rng(self, self.iteration_count)
                if train else None)
        return values

    def score(self, ds) -> float:
        """Loss (plus the L1/L2 penalty) on a DataSet or MultiDataSet,
        inference mode."""
        if self.params is None:
            self.init()
        f, l, fm, lm = _ds_arrays(ds)
        with torch.no_grad():
            s, _ = self._score_pure(
                self.params, self.state, self._tensors(f), self._tensors(l),
                self._tensors(lm), train=False, fmasks=self._tensors(fm))
        return float(s)

    # -- training ----------------------------------------------------------

    def recurrent_names(self) -> List[str]:
        return [n for n in self.layer_vertex_names
                if self._layer(n).is_recurrent()]

    def layer_confs(self) -> list:
        return [self._layer(n) for n in self.layer_vertex_names]

    def _score_fn(self):
        def score_fn(params, state, inputs, labels, lmasks, fmasks, rng):
            return self._score_pure(params, state, inputs, labels,
                                    lmasks, train=True, fmasks=fmasks,
                                    rng=rng)

        return score_fn

    def _train_step(self):
        return core.model_step(self, self._score_fn())

    def _scan_step(self, tbptt: bool = False):
        """The scan path's bare step (``core.build_multi_step``)."""
        return core.scan_step(self, self._score_fn(), tbptt)

    def enable_step_telemetry(self, enabled: bool = True) -> None:
        """As ``MultiLayerNetwork.enable_step_telemetry``."""
        core.enable_step_telemetry(self, enabled)

    def _can_scan_steps(self) -> bool:
        """The scan path applies (JAX ``_can_scan_steps``): one iteration
        a minibatch, no truncated BPTT, the SGD solver, no divergence
        guard, no loss scaling, no recurrent vertex, and listeners that
        take a chunk's callbacks after it."""
        conf = self.conf
        return (conf.iterations == 1
                and conf.backprop_type != "TruncatedBPTT"
                and conf.optimization_algo == "STOCHASTIC_GRADIENT_DESCENT"
                and self.divergence_guard is None
                and not self._loss_scale_active
                and not self.recurrent_names()
                and core.batched_listeners(self))

    def _fit_epochs_device_cached(self, batches, epochs: int) -> bool:
        def arrays_of(ds):
            for group in _ds_arrays(ds):
                yield from group or []

        return core.fit_epochs_device_cached(self, batches, epochs,
                                             arrays_of)

    def fit(self, data, labels=None, *, epochs: int = 1, resume_from=None,
            grad_accum=None, megastep=None) -> None:
        """fit(iterator) / fit(DataSet or MultiDataSet) / fit(inputs,
        labels) (reference ``ComputationGraph.fit``). ``data`` may be an
        iterable of objects with ``.features`` / ``.labels`` (a list of
        arrays each, or one array), one such object, or the inputs of an
        (inputs, labels) pair. An iterator with ``reset()`` is reset
        after each epoch. ``resume_from``, ``grad_accum=K`` (refused by
        BatchNormalization configurations) and ``megastep=K``: as
        ``MultiLayerNetwork.fit``; the loop is ``core.fit_batches``."""
        if grad_accum is not None:
            core.set_grad_accum(self, grad_accum)
        if megastep is not None:
            core.set_transforms(self, megastep=megastep)
        if resume_from is not None:
            self.resume(resume_from)
        core.fit_batches(self, data, labels, epochs)

    def resume(self, source, load_updater: bool = True) -> int:
        """As ``MultiLayerNetwork.resume``: a checkpoint restored into
        this graph; returns the restored step."""
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
        """As ``MultiLayerNetwork.set_batch_validator``."""
        core.set_batch_validator(self, validator, quarantine)

    def fit_minibatch(self, ds) -> torch.Tensor:
        """One minibatch through ``conf.iterations`` optimizer steps (a
        line-search solver's where ``optimization_algo`` names one);
        returns the last step's score as a 0-d tensor on the device."""
        from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet

        if isinstance(ds, ChunkedDataSet):
            score = None
            for b in ds.to_datasets():
                score = self.fit_minibatch(b)
            return score
        if self.params is None:
            self.init()
        if self.conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT":
            f, l, fm, lm = _ds_arrays(ds)
            return self._solver_minibatch(f, l, lm, fm)
        # a model left sharded by a zero=True trainer steps canonical
        core.canonicalize_updater_state(self)
        inputs, labels, lmasks, fmasks = self.batch_tensors(ds)
        core.check_grad_accum_batch(self.grad_accum, int(inputs[0].shape[0]))
        self._last_batch_rows = int(inputs[0].shape[0])
        if (self.conf.backprop_type == "TruncatedBPTT" and any(
                x.dim() == 3 and x.shape[2] > self.conf.tbptt_fwd_length
                for x in inputs)):
            return self._fit_tbptt(inputs, labels, lmasks, fmasks)
        prof = profiler.get_active_profiler()
        if prof is not None:
            prof.begin_step(self.iteration_count + 1, device=self.device)
        score = None
        for _ in range(self.conf.iterations):
            # a listener may change the step's flavour (telemetry, the
            # guard) between iterations
            score = core.run_step(self, self._train_step(), inputs, labels,
                                  lmasks, fmasks)
            self._reset_recurrent_state()
        if prof is not None:
            prof.end_step(model=self, ds=ds, score=self._last_score,
                          grad_norm=self._last_grad_norm,
                          rows=self._last_batch_rows)
        return score

    def batch_tensors(self, ds, device=None):
        """(inputs, labels, labels masks, features masks) of a DataSet
        or MultiDataSet as the step takes them: lists of tensors on the
        graph's device (or ``device``) in the configuration's dtype
        (masks: None or lists)."""
        if hasattr(ds, "wait"):  # placed by an input pipeline
            ds.wait()
        f, l, fm, lm = _ds_arrays(ds)
        return tuple(self._tensors(a, device) for a in (f, l, lm, fm))

    def _ds_scan_sig(self, ds) -> tuple:
        """The shapes and dtypes of a minibatch's fields: a megastep or
        scan chunk stacks minibatches of one signature."""
        return tuple(None if v is None else tuple(core.field_sig(a)
                                                  for a in v)
                     for v in _ds_arrays(ds))

    def _stack_chunk(self, batches) -> core.Chunk:
        """Same-signature minibatches stacked into a ``core.Chunk``, one
        tensor a graph input, output and mask."""
        dtype = core.dtype_of(self.conf)
        rows = [_ds_arrays(b) for b in batches]

        def stack(idx):
            first = rows[0][idx]
            if first is None:
                return None
            return [None if first[j] is None else core.stack_fields(
                [r[idx][j] for r in rows], dtype) for j in range(len(first))]

        f, l, fm, lm = (stack(i) for i in range(4))
        return core.Chunk(f, l, lm, fm, len(batches),
                          int(np.shape(rows[0][0][0])[0]))

    def _reset_recurrent_state(self) -> None:
        """Each pass over a minibatch starts from a zero carry."""
        for n in self.recurrent_names():
            self.state[n] = {}

    def _fit_tbptt(self, inputs, labels, lmasks, fmasks) -> torch.Tensor:
        """Truncated BPTT over the graph (JAX ``_fit_tbptt``, reference
        ``ComputationGraph.doTruncatedBPTT``): every [b, n, T] input and
        label and every [b, T] mask cut into ``tbptt_fwd_length``
        segments, one optimizer step each, the recurrent carry handed on
        detached in the layer state; arrays without the time axis ride
        along whole. Returns the last segment's score."""
        fwd = self.conf.tbptt_fwd_length
        t_lens = {int(x.shape[2]) for x in inputs if x.dim() == 3}
        for group in (labels, lmasks, fmasks):
            for v in group or []:
                if v is not None and v.dim() == 3:
                    t_lens.add(int(v.shape[2]))
        if len(t_lens) > 1:
            raise ValueError(
                "TruncatedBPTT requires every time-series input/label to "
                f"share one sequence length; got {sorted(t_lens)} "
                "(chunking mixed lengths would re-feed the shorter series "
                "each chunk with stale recurrent carry)")
        t_total = t_lens.pop()

        def cut3(vs, s, e):
            if vs is None:
                return None
            return [v[:, :, s:e].contiguous() if v is not None
                    and v.dim() == 3 and v.shape[2] == t_total else v
                    for v in vs]

        def cut_mask(vs, s, e):
            if vs is None:
                return None
            return [m[:, s:e].contiguous() if m is not None
                    and m.dim() == 2 and m.shape[1] == t_total else m
                    for m in vs]

        self._reset_recurrent_state()
        score = None
        for start in range(0, t_total, fwd):
            end = min(start + fwd, t_total)
            score = core.run_step(
                self, self._train_step(), cut3(inputs, start, end),
                cut3(labels, start, end), cut_mask(lmasks, start, end),
                cut_mask(fmasks, start, end))
        self._reset_recurrent_state()
        return score

    # -- streaming inference (reference rnnTimeStep) -------------------------

    def rnn_time_step(self, *inputs) -> List[torch.Tensor]:
        """Feed one (or a few) timesteps of each input, carrying the
        recurrent state across calls (reference
        ``ComputationGraph.rnnTimeStep``). Inputs [b, size] or [b, size,
        t]; each 2-d input gets a time axis of its own, and the outputs
        come back 2-d only when every input arrived 2-d."""
        if self.params is None:
            self.init()
        named = [(n, self._layer(n)) for n in self.layer_vertex_names]
        core.refuse_unstreamable(named, "Vertex")
        with torch.inference_mode():
            arr = self._tensors(inputs)
            was_2d = [x.dim() == 2 for x in arr]
            squeeze = bool(arr) and all(was_2d)
            arr = [x[:, :, None] if w else x for x, w in zip(arr, was_2d)]

            def forward(state):
                values, _, new_state = self._forward_values(
                    self.params, state, arr, train=False)
                return values, new_state

            values = core.stream_forward(
                self, named,
                max((int(x.shape[2]) for x in arr if x.dim() == 3),
                    default=1),
                int(arr[0].shape[0]) if arr else 1, forward)
        return [values[n][:, :, 0] if squeeze and values[n].dim() == 3
                else values[n] for n in self.conf.outputs]

    def rnn_clear_previous_state(self) -> None:
        """Reference ``rnnClearPreviousState``."""
        self._rnn_state = {}
        self._stream_steps = 0

    def set_transforms(self, scan_layers=None, remat=None, loss_scale=None,
                       megastep=None) -> "ComputationGraph":
        """As ``MultiLayerNetwork.set_transforms`` (``core.
        set_transforms``)."""
        core.set_transforms(self, scan_layers, remat, loss_scale, megastep)
        return self

    @property
    def _loss_scale_active(self) -> bool:
        return core.loss_scale_active(self)

    def set_divergence_guard(self, guard) -> None:
        """As ``MultiLayerNetwork.set_divergence_guard``."""
        core.set_divergence_guard(self, guard)

    def _pretrain_input(self, name: str, inputs) -> torch.Tensor:
        """What vertex ``name`` sees: its first input's value in the
        frozen graph's inference forward, through its preprocessor."""
        with torch.no_grad():
            values, _, _ = self._forward_values(self.params, self.state,
                                                inputs, train=False)
            x = values[self.conf.vertex_inputs[name][0]]
            return self.conf.vertices[name].layer_input(x).contiguous()

    def pretrain(self, data, epochs: int = 1) -> None:
        """Greedy layer-wise unsupervised pretraining of every
        pretrainable layer vertex (AutoEncoder, RBM,
        VariationalAutoencoder) in topological order, each on what the
        frozen graph feeds it (reference ``ComputationGraph.pretrain``),
        computed once a batch; ``conf.iterations`` updates a batch with
        the vertex's own updater (fresh state, the schedule counted from
        0)."""
        if self.params is None:
            self.init()
        data = core.pretrain_batches(data)
        base = random.host_key(self.conf.seed)
        for topo_idx, n in enumerate(self.topo):
            v = self.conf.vertices[n]
            if not (isinstance(v, LayerVertex)
                    and v.layer_conf.is_pretrainable()):
                continue
            core.pretrain_layer(
                self, n, v.layer_conf, random.fold_in(base, 7919 + topo_idx),
                data, epochs, lambda ds, n=n: self._pretrain_input(
                    n, self._tensors(_as_list(ds.features))))
        self._pretrain_done = True

    def _evaluate_one(self, e, ds) -> None:
        from deeplearning4j_tpu_torch.eval.evaluation import host_array

        fm = (getattr(ds, "features_masks", None)
              or getattr(ds, "features_mask", None))
        out = self.output(*_as_list(ds.features), features_masks=fm)[0]
        labels = host_array(_as_list(ds.labels)[0])
        m = _as_list(getattr(ds, "labels_masks", None)
                     or getattr(ds, "labels_mask", None))
        mask = m[0] if m else None
        if mask is None and labels.ndim == 3:
            # per-timestep labels without a labels mask: fall back to
            # the features mask (same rule as MultiLayerNetwork's);
            # 2-d per-sequence labels must not take a [b, t] mask
            fml = _as_list(fm)
            mask = fml[0] if fml else None
        e.eval(labels, out, mask=mask)

    # -- parameters ---------------------------------------------------------

    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return sum(t.numel() for lp in self.params.values()
                   for t in lp.values())

    def _param_owners(self) -> List[str]:
        return self.layer_vertex_names

    def _aot_shape_key(self, shapes) -> tuple:
        """One shape -> a 1-tuple of shape tuples (the engine takes a
        list of inputs), as JAX's ``_aot_shape_key``."""
        shapes = tuple(shapes)
        if shapes and not isinstance(shapes[0], (tuple, list)):
            shapes = (shapes,)
        return tuple(tuple(int(d) for d in s) for s in shapes)

    def summary(self) -> str:
        """The JAX engine's table: one line a vertex, its parameter
        count, the total."""
        lines = ["=" * 72, f"{'vertex':<20}{'type':<30}{'params':>10}",
                 "-" * 72]
        total = 0
        for name in self.topo:
            v = self.conf.vertices[name]
            n = (sum(p.numel() for p in self.params[name].values())
                 if self.params and name in self.params else 0)
            total += n
            tname = (type(v.layer_conf).__name__
                     if isinstance(v, LayerVertex) else type(v).__name__)
            lines.append(f"{name:<20}{tname:<30}{n:>10}")
        lines += ["-" * 72, f"Total params: {total}", "=" * 72]
        return "\n".join(lines)

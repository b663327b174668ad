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

Training is the plain per-step loop of ``nn/core.py`` (``build_step``):
each minibatch runs ``conf.iterations`` optimizer steps at the scheduled
learning rates, with ``fit(grad_accum=K)`` as K contiguous microbatches
a step. Inputs cross to the device at their own width where they are
uint8 / int8 / int16 and are cast there (``core.to_device``). The JAX
engine's ``scan_chunk`` fuses 16 minibatches into one dispatch with the
same trajectory; it is not ported. The step's flavours (loss scaling
under f16 compute, the divergence and statistical guards), the
whole-net transforms (``remat`` per layer vertex, ``scan_layers``) and
``fit(megastep=K)`` (K steps a chunk, on the card one CUDA-graph
replay) are the sequential engine's (``nn/core.py``), and so are
dropout and drop-connect: vertex i of the topological order draws from
``fold_in(step key, i)``, the output vertex's pre-output with the masks
of its ``apply``. Graph truncated BPTT, ``rnn_time_step``, AOT export,
``pretrain`` and ``evaluate`` are not ported: each raises, naming the
slice that brings it.
Like the JAX engine, this one folds no Conv -> BatchNormalization pair
(that peephole is the sequential engine's, ``nn/core.py``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import core
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    LastTimeStepVertex,
    LayerVertex,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import ShapeContext
from deeplearning4j_tpu_torch.nn.updaters import MultiLayerUpdaterDef
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


class ComputationGraph:
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
        # the transform knobs, the guard and their device states
        core.init_transforms(self)
        # {"shards": n} while the updater state lies in ZeRO-1's flat
        # layout (set by the distributed trainer); None: parameter-shaped
        self._zero_layout = None

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
                vparams = params.get(name, {})
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
            reg = reg + core.reg_penalty(self._layer(n), params[n])
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
            values, _, _ = self._forward_values(
                self.params, self.state, self._tensors(inputs), train=False,
                fmasks=self._tensors(_as_list(features_masks)) or None)
            return [values[n] for n in self.conf.outputs]

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

    def _check_trainable(self) -> None:
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

    def recurrent_names(self) -> List[str]:
        return [n for n in self.layer_vertex_names
                if self._layer(n).is_recurrent()]

    def layer_confs(self) -> list:
        return [self._layer(n) for n in self.layer_vertex_names]

    def _train_step(self):
        def score_fn(params, state, inputs, labels, lmasks, fmasks, rng):
            return self._score_pure(params, state, inputs, labels,
                                    lmasks, train=True, fmasks=fmasks,
                                    rng=rng)

        return core.model_step(self, score_fn)

    def fit(self, data, labels=None, *, epochs: int = 1, grad_accum=None,
            megastep=None) -> None:
        """fit(iterator) / fit(DataSet or MultiDataSet) / fit(inputs,
        labels) (reference ``ComputationGraph.fit``). ``data`` may be an
        iterable of objects with ``.features`` / ``.labels`` (a list of
        arrays each, or one array), one such object, or the inputs of an
        (inputs, labels) pair. An iterator with ``reset()`` is reset
        after each epoch. ``grad_accum=K``: each optimizer step
        accumulates K equal microbatches (persists until changed;
        BatchNormalization configurations refuse it). ``megastep=K``: K
        same-shaped minibatches a chunk, as ``MultiLayerNetwork.fit``."""
        if grad_accum is not None:
            core.set_grad_accum(self, grad_accum)
        if megastep is not None:
            core.set_transforms(self, megastep=megastep)
        if self.params is None:
            self.init()
        if labels is not None:
            from deeplearning4j_tpu_torch.datasets.api import DataSet

            batches = [DataSet(features=_as_list(data),
                               labels=_as_list(labels))]
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
        """One minibatch through ``conf.iterations`` optimizer steps;
        returns the last step's score as a 0-d tensor on the device."""
        if self.params is None:
            self.init()
        self._check_trainable()
        # a model left sharded by a zero=True trainer steps canonical
        core.canonicalize_updater_state(self)
        inputs, labels, lmasks, fmasks = self.batch_tensors(ds)
        core.check_grad_accum_batch(self.grad_accum, int(inputs[0].shape[0]))
        self._last_batch_rows = int(inputs[0].shape[0])
        if (self.conf.backprop_type == "TruncatedBPTT" and any(
                x.dim() == 3 and x.shape[2] > self.conf.tbptt_fwd_length
                for x in inputs)):
            raise NotImplementedError(
                "fit: truncated BPTT over a ComputationGraph is not ported "
                "yet (ROADMAP queue 1)")
        step = self._train_step()
        score = None
        for _ in range(self.conf.iterations):
            score = core.run_step(self, step, inputs, labels, lmasks, fmasks)
            self._reset_recurrent_state()
        return score

    def batch_tensors(self, ds, device=None):
        """(inputs, labels, labels masks, features masks) of a DataSet
        or MultiDataSet as the step takes them: lists of tensors on the
        graph's device (or ``device``) in the configuration's dtype
        (masks: None or lists)."""
        f, l, fm, lm = _ds_arrays(ds)
        return tuple(self._tensors(a, device) for a in (f, l, lm, fm))

    def _ds_scan_sig(self, ds) -> tuple:
        """The shapes and dtypes of a minibatch's fields: a megastep
        chunk stacks minibatches of one signature."""
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

    # -- what the port does not carry yet ------------------------------------

    def rnn_time_step(self, *inputs):
        raise NotImplementedError(
            "ComputationGraph.rnn_time_step is not ported yet (ROADMAP "
            "queue 1); MultiLayerNetwork has it")

    def rnn_clear_previous_state(self) -> None:
        raise NotImplementedError(
            "ComputationGraph.rnn_time_step is not ported yet (ROADMAP "
            "queue 1)")

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

    def pretrain(self, data, epochs: int = 1) -> None:
        raise NotImplementedError(
            "layer-wise pretraining is not ported yet (periphery: "
            "pretrainable layers)")

    def evaluate(self, iterator):
        raise NotImplementedError(
            "evaluate arrives with the periphery (eval/)")

    def aot_export_output(self, shapes, registry=None):
        raise NotImplementedError(
            "AOT export arrives with the runtime subsystems slice "
            "(compile/)")

    # -- parameters ---------------------------------------------------------

    def num_params(self) -> int:
        if self.params is None:
            self.init()
        return sum(t.numel() for lp in self.params.values()
                   for t in lp.values())

    def _flat_order(self) -> List[Tuple[str, str]]:
        """(vertex, param) in the JAX engine's flat order: topological,
        W and b first, the rest sorted."""
        order = []
        for name in self.layer_vertex_names:
            pnames = list(self.params[name])
            first = [p for p in ("W", "b") if p in pnames]
            order += [(name, p) for p in
                      first + sorted(p for p in pnames if p not in first)]
        return order

    def params_flat(self) -> np.ndarray:
        """Every parameter, raveled and concatenated on the host."""
        if self.params is None:
            self.init()
        parts = [self.params[ln][pn].detach().cpu().numpy().ravel()
                 for ln, pn in self._flat_order()]
        return np.concatenate(parts) if parts else np.zeros((0,))

    def set_params_flat(self, vec) -> None:
        """The inverse of ``params_flat``."""
        vec = np.asarray(vec)
        off = 0
        for ln, pn in self._flat_order():
            p = self.params[ln][pn]
            n = p.numel()
            self.params[ln][pn] = self._to_device(
                vec[off:off + n].reshape(tuple(p.shape)), p.dtype)
            off += n
        if off != vec.size:
            raise ValueError(f"set_params_flat: {vec.size} values for "
                             f"{off} parameters")

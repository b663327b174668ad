"""Data-parallel training over ``torch.distributed``.

Counterpart of ``deeplearning4j_tpu/parallel/trainer.py``
(``DistributedTrainer``), the replacement for the reference's
``SparkDl4jMultiLayer`` / ``ParameterAveragingTrainingMaster`` with a
gradient all-reduce every step. The JAX trainer jits the step over a
mesh with the batch sharded ``P("data")``; here each rank is one process
driving one device (``parallel/mesh.py``): every rank is handed the same
global minibatch, trains on its contiguous row shard, and the ranks
meet in collectives (NCCL on the card, gloo on the CPU):

- the gradients (and the score) of every parameter in ONE all-reduce
  of a flat bucket (``_fused_all_reduce``; f32, or wider where a
  parameter is), each rank's loss
  weighted by its share of the global row or mask count, so masked and
  padded batches weight rows exactly as one device does;
- ``batch_stats="sync"``: BatchNormalization over the global batch (an
  autograd-aware all-reduce of the sum, then of the centred sum of
  squares: the two-pass variance; the backward sees the global
  statistics); ``"local"``: per-rank statistics and per-rank mean
  losses, the running statistics averaged after each step (the
  reference's workers); ``"auto"``: as the JAX trainer picks;
- ``zero=True`` (ZeRO-1): each rank keeps and updates 1/N of every
  flattened optimizer moment and all-gathers the updated parameters
  (the trajectory is bitwise the replicated one's: every rule is
  elementwise);
- ``grad_accum=K`` (on the model, ``fit(grad_accum=K)``): microbatch j
  is global rows ``[j·b/K, (j+1)·b/K)``, each rank taking its whole
  shard of it, the JAX layout;
- a trailing batch that does not split into equal shards is padded with
  zero rows masked out of the loss (a model with batch statistics
  raises instead);
- dynamic loss scaling (the model's, under f16 compute) and the
  divergence guard (``divergence_guard=``, the trainer's own, with its
  statistical guard): the shared ``core.finish_step`` after the
  gradient all-reduce, so the finite probe and the guard's select see
  the global gradient and every rank takes the same branch; both run
  the synchronous step, as in the JAX trainer;
- dropout and drop-connect: the synchronous step draws the global
  batch's masks, each rank exactly its rows of them (``nn/random.py``
  ``row_window``: the generator's counter is the flat index), so a
  world of N draws what one process draws; ``"local"`` draws each
  shard's own from ``fold_in(key, rank)``, as JAX's shard_map step.

Tensor parallelism, megastep dispatch (``fit_megachunk``), ``resume``,
prefetching and batch validation are not ported: each raises, naming
the slice that brings it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn import core, random
from deeplearning4j_tpu_torch.nn.updaters import normalize_layer_grads
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, build_mesh

_RUNTIME_SLICE = "the runtime subsystems slice"


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: the gradient of each rank's
    input is the sum over the ranks of the output's gradients (the loss
    is the sum of the ranks' weighted losses)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def _host(a):
    """A host array of a batch field (None stays None)."""
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _as_list(v):
    if v is None:
        return None
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _common_dtype(tensors) -> torch.dtype:
    """The dtype every tensor of a flat bucket widens to exactly."""
    return functools.reduce(torch.promote_types,
                            (t.dtype for t in tensors), torch.float32)


def _loss_count(labels, mask) -> float:
    """The denominator ``losses.score`` divides by: the unmasked rows
    (at least 1), or every row (example, or example-timestep for 3-d
    labels)."""
    if mask is not None:
        return max(float(np.sum(mask, dtype=np.float64)), 1.0)
    return float(labels.shape[0] * (labels.shape[2] if labels.ndim == 3
                                    else 1))


class DistributedTrainer:
    """Data-parallel trainer for a ``MultiLayerNetwork`` or
    ``ComputationGraph`` on the device of this rank (the model's)."""

    def __init__(self, model, mesh: Optional[Mesh] = None,
                 tensor_parallel: bool = False, batch_stats: str = "auto",
                 divergence_guard=None, zero: bool = False):
        """``batch_stats``: ``"sync"`` (BatchNormalization sees the global
        batch: the single-device math), ``"local"`` (each rank's own
        shard, the reference's worker semantics; running statistics
        averaged after each step) or ``"auto"`` (local exactly where it
        equals sync: no batch statistics, no dropout, no masks).
        ``zero=True`` shards the optimizer state 1/N over the ranks."""
        if batch_stats not in ("auto", "sync", "local"):
            raise ValueError(
                f"batch_stats must be auto|sync|local, got {batch_stats!r}")
        if tensor_parallel:
            raise NotImplementedError(
                "tensor_parallel: tensor parallelism is not ported yet "
                "(ROADMAP queue 1: the distribution slice's tensor "
                "parallelism)")
        if zero and batch_stats == "local":
            raise ValueError(
                "zero=True needs the synchronous step; batch_stats='local' "
                "keeps per-rank replicated updater state, exactly what "
                "zero removes")
        self.model = model
        self.set_divergence_guard(divergence_guard)
        self.mesh = mesh if mesh is not None else build_mesh(
            device=model.device)
        self._check_device()
        self._check_row_sharded()
        self.batch_stats = batch_stats
        self.zero = bool(zero)
        self._is_graph = hasattr(model.conf, "vertices")
        if model.params is None:
            model.init()
        # a model that arrives sharded (an earlier zero=True trainer) is
        # gathered to parameter shapes first, never sliced twice
        core.canonicalize_updater_state(model)
        self._broadcast_model()
        self._zero_ranges: Dict[str, Dict[str, tuple]] = {}
        if self.zero:
            self._shard_updater_state()
        self._publish_updater_bytes()

    # -- placement ----------------------------------------------------------

    def _check_device(self) -> None:
        """One rank drives one device: the model lies on the mesh's
        device, CUDA models talk over NCCL and CPU models over gloo. A
        CUDA model never goes on over gloo or on the CPU."""
        m, mesh = self.model, self.mesh
        if mesh.backend is None:
            if mesh.data != 1:
                raise ValueError("a mesh of several ranks needs a group")
            return
        want = "nccl" if m.device.type == "cuda" else "gloo"
        if mesh.backend != want:
            raise RuntimeError(
                f"a {m.device.type} model needs a {want} group, the world "
                f"was formed with {mesh.backend}")
        if m.device != mesh.device:
            raise RuntimeError(f"the model lies on {m.device}, this rank "
                               f"drives {mesh.device}")

    def _check_row_sharded(self) -> None:
        """The JAX trainer shards a ``SparseEmbeddingLayer``'s rows over
        the data axis; that branch is not ported, so a world of several
        ranks refuses such a layer rather than replicate it silently."""
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            SparseEmbeddingLayer,
        )

        if self.mesh.data > 1 and any(
                isinstance(lc, SparseEmbeddingLayer) and lc.row_sharded
                for lc in self.model.layer_confs()):
            raise NotImplementedError(
                "SparseEmbeddingLayer(row_sharded=True) over more than one "
                "rank: the trainer's row-sharded embedding branch is not "
                "ported yet (ROADMAP queue 1: the row-sharded trainer "
                "branch for SparseEmbeddingLayer); use row_sharded=False")

    @property
    def _collective(self) -> bool:
        return self.mesh.backend is not None

    def _leaves(self, tree) -> List[torch.Tensor]:
        """Every floating tensor of ``{a: {b: tensor or tuple}}``, in
        order."""
        out = []
        for lp in tree.values():
            for v in lp.values():
                for t in (v if isinstance(v, tuple) else (v,)):
                    if t.is_floating_point():
                        out.append(t)
        return out

    def _broadcast_model(self) -> None:
        """Rank 0's parameters, layer state and updater state to every
        rank (the reference's broadcast step, done once), in place."""
        if not self._collective or self.mesh.data == 1:
            return
        m = self.model
        leaves = (self._leaves(m.params) + self._leaves(m.state)
                  + self._leaves(m.updater_state))
        if not leaves:
            return
        dt = _common_dtype(leaves)
        flat = torch.cat([t.reshape(-1).to(dt) for t in leaves])
        dist.broadcast(flat, src=0)
        off = 0
        for t in leaves:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    def _shard_updater_state(self) -> None:
        """ZeRO-1: every updater leaf flattened, zero-padded to a
        multiple of the ranks, and this rank's 1/N slice kept
        (``_zero_ranges``: (start, stop, numel) of each parameter). The
        model is marked ``_zero_layout = {"shards": N}``: ``write_model``
        and the engines' ``fit`` gather it back."""
        m, n, r = self.model, self.mesh.data, self.mesh.rank
        sharded = {}
        for ln, lp in m.params.items():
            self._zero_ranges[ln] = {}
            sharded[ln] = {}
            for pn, p in lp.items():
                size = -(-p.numel() // n)
                lo = r * size
                self._zero_ranges[ln][pn] = (lo, lo + size, p.numel())
                sharded[ln][pn] = tuple(
                    self._flat_slice(a, ln, pn).clone()
                    for a in m.updater_state[ln][pn])
        m.updater_state = sharded
        m._zero_layout = {"shards": n}

    def _flat_slice(self, a: torch.Tensor, ln: str, pn: str) -> torch.Tensor:
        lo, hi, numel = self._zero_ranges[ln][pn]
        flat = a.reshape(-1)
        if hi > numel:
            flat = torch.cat([flat, flat.new_zeros(hi - numel)])
        return flat[lo:hi]

    def _publish_updater_bytes(self) -> None:
        """The JAX trainer's two gauges: optimizer-state bytes on this
        rank, and of them the bytes of its 1/N ZeRO shard (0 without
        zero)."""
        total = sum(t.numel() * t.element_size()
                    for t in self._leaves(self.model.updater_state))
        self.updater_state_bytes_per_device = int(total)
        self.zero_shard_bytes = int(total) if self.zero else 0

    def gather_updater_state(self):
        """The updater state in the canonical (parameter-shaped) layout:
        the model's own where it is not sharded, all-gathered (on every
        rank) where it is."""
        m = self.model
        layout = getattr(m, "_zero_layout", None)
        if not layout:
            return m.updater_state
        return core.zero_gather_updater_state(m.updater_state, m.params,
                                              layout["shards"])

    # -- the batch ------------------------------------------------------------

    def _fields(self, ds):
        """(features, labels, labels masks, features masks) of a batch as
        lists of host arrays (masks: None or lists that may hold
        None)."""
        lm = getattr(ds, "labels_masks", None)
        if lm is None:
            lm = getattr(ds, "labels_mask", None)
        fm = getattr(ds, "features_masks", None)
        if fm is None:
            fm = getattr(ds, "features_mask", None)
        return tuple(None if v is None else [_host(a) for a in v]
                     for v in (_as_list(ds.features), _as_list(ds.labels),
                               _as_list(lm), _as_list(fm)))

    def _uses_batch_statistics(self) -> bool:
        return any(layer.uses_batch_statistics()
                   for layer in self.model.layer_confs())

    def _pad(self, fields, batch_n: int):
        """Pad-and-mask a trailing batch up to the next multiple of the
        ranks (JAX ``_pad_minibatch``): zero rows, and a labels mask on
        every output that keeps them out of the loss."""
        n_data = self.mesh.data
        if self._uses_batch_statistics():
            raise ValueError(
                f"Batch size {batch_n} is not divisible by the data-"
                f"parallel degree {n_data}, and this model uses batch "
                "statistics (BatchNormalization) — zero padding rows "
                "would corrupt the batch stats. Drop or regroup the "
                "trailing partial batch.")
        pad = n_data - batch_n % n_data

        def padded(a):
            return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

        feats, labels, lmasks, fmasks = fields
        lmasks = lmasks or [None] * len(labels)
        ones = [np.ones((y.shape[0], y.shape[2]) if y.ndim == 3
                        else (y.shape[0],), np.float32) for y in labels]
        lmasks = [padded(ones[i] if m is None else m)
                  for i, m in enumerate(lmasks)]
        fmasks = (None if fmasks is None or all(m is None for m in fmasks)
                  else [None if m is None else padded(m) for m in fmasks])
        return ([padded(f) for f in feats], [padded(y) for y in labels],
                lmasks, fmasks)

    def _rows(self, batch_n: int, k: int):
        """This rank's rows of a ``batch_n`` batch: for each of the ``k``
        microbatches (global rows ``[j·b/k, (j+1)·b/k)``) its contiguous
        shard."""
        n, r = self.mesh.data, self.mesh.rank
        m = batch_n // (k * n)
        return [np.arange(j * batch_n // k + r * m,
                          j * batch_n // k + (r + 1) * m) for j in range(k)]

    def _weights(self, fields, rows, micro, local: bool, k: int):
        """``([a weight an output], penalty weight)`` of this rank's loss
        on one microbatch: its share of the global count (``local``:
        1/N, the mean of the ranks' means), the penalty 1/N of the
        whole."""
        n = self.mesh.data
        if local:
            return ([1.0 / n] * len(fields[1]), 1.0 / n)
        _, labels, lmasks, fmasks = fields
        b = labels[0].shape[0]
        glob = np.arange(micro * b // k, (micro + 1) * b // k)
        out = []
        for i, y in enumerate(labels):
            m = lmasks[i] if lmasks is not None else None
            if m is None and not self._is_graph and y.ndim == 3:
                m = fmasks[0] if fmasks is not None else None
            mine = _loss_count(y[rows], None if m is None else m[rows])
            total = _loss_count(y[glob], None if m is None else m[glob])
            out.append(mine / total)
        return (out, 1.0 / n)

    def _local_dataset(self, fields, rows):
        from deeplearning4j_tpu_torch.datasets.api import (
            DataSet,
            MultiDataSet,
        )

        feats, labels, lmasks, fmasks = (
            None if v is None else [None if a is None else a[rows]
                                    for a in v] for v in fields)
        if self._is_graph:
            return MultiDataSet(feats, labels, features_masks=fmasks,
                                labels_masks=lmasks)
        return DataSet(feats[0], labels[0],
                       features_mask=None if fmasks is None else fmasks[0],
                       labels_mask=None if lmasks is None else lmasks[0])

    def _use_local(self, has_masks: bool) -> bool:
        """The JAX trainer's ``_pick_shard_map``: per-rank statistics and
        losses where asked, or under ``"auto"`` where they equal the
        global ones."""
        if (self.zero or self.model.grad_accum > 1
                or core.loss_scale_active(self.model)
                or self._sg_config() is not None):
            # loss-scale and EWMA state ride the synchronous step
            return False
        if self.batch_stats != "auto":
            return self.batch_stats == "local"
        return not (self._uses_batch_statistics() or has_masks or any(
            layer.dropout > 0.0 for layer in self.model.layer_confs()))

    # -- the step -------------------------------------------------------------

    def _score_fn(self, weights):
        m = self.model
        kw = "fmasks" if self._is_graph else "fmask"

        def score_fn(params, state, x, labels, lmask, fmask, rng):
            return m._score_pure(params, state, x, labels, lmask,
                                 train=True, weights=weights, rng=rng,
                                 **{kw: fmask})
        return score_fn

    def _fused_all_reduce(self, grads, score, state, local: bool):
        """Sum the gradients and the score over the ranks in ONE flat
        all-reduce (JAX ``_fused_pmean``: one collective, not one a
        leaf); under ``local`` the running statistics ride along and are
        averaged."""
        if not self._collective:
            return grads, score, state
        n = self.mesh.data
        g_leaves = [g for lg in grads.values() for g in lg.values()]
        recurrent = set(self.model.recurrent_names())
        s_leaves = ([t for ln, st in state.items() if ln not in recurrent
                     for t in st.values() if t.is_floating_point()]
                    if local and n > 1 else [])
        leaves = g_leaves + [score.reshape(1)] + s_leaves
        dt = _common_dtype(leaves)
        flat = torch.cat([t.reshape(-1).to(dt) for t in leaves])
        dist.all_reduce(flat)
        off = 0

        def take(t):
            nonlocal off
            v = flat[off:off + t.numel()].view_as(t).to(t.dtype)
            off += t.numel()
            return v

        grads = {ln: {pn: take(g) for pn, g in lg.items()}
                 for ln, lg in grads.items()}
        score = take(score.reshape(1)).reshape(())
        if s_leaves:
            state = {ln: ({k: (take(t) / n if t.is_floating_point() else t)
                           for k, t in st.items()}
                          if ln not in recurrent else st)
                     for ln, st in state.items()}
        return grads, score, state

    def _sg_config(self):
        """The ``StatGuardConfig`` of the trainer's own guard (the
        trainer's and the engine's guards are separate installs)."""
        g = self.divergence_guard
        return g.stats if g is not None else None

    def _zero_update(self, grads, lrs, t):
        """ZeRO-1: the rule on this rank's slice of every parameter, then
        one all-gather of the updated slices."""
        m = self.model
        upd = m.updater_def
        new_upd, mine, order = {}, [], []
        for ln, lg in grads.items():
            lg = normalize_layer_grads(upd.settings[ln], lg)
            new_upd[ln] = {}
            for pn, g in lg.items():
                p_sl = self._flat_slice(m.params[ln][pn], ln, pn)
                g_sl = self._flat_slice(g, ln, pn)
                p_new, new_upd[ln][pn] = upd.update_param(
                    ln, pn, g_sl, m.updater_state[ln][pn], p_sl, lrs, t)
                mine.append(p_new)
                order.append((ln, pn))
        new_params = {ln: {} for ln in m.params}
        if not order:
            return m.params, new_upd
        flat = torch.cat(mine)
        parts = ([flat] if not self._collective else
                 [torch.empty_like(flat) for _ in range(self.mesh.data)])
        if self._collective:
            dist.all_gather(parts, flat)
        off = 0
        for (ln, pn), sl in zip(order, mine):
            p = m.params[ln][pn]
            size = sl.numel()
            full = torch.cat([q[off:off + size] for q in parts])
            new_params[ln][pn] = full[:p.numel()].view_as(p).clone()
            off += size
        return new_params, new_upd

    def fit_minibatch(self, ds) -> torch.Tensor:
        """One synchronous data-parallel step on the global minibatch
        ``ds`` (every rank passes the same one); returns the global score
        as a 0-d tensor on the device."""
        m = self.model
        m._check_trainable()
        if self.zero and m._zero_layout != {"shards": self.mesh.data}:
            # the engine's own fit gathered the moments in between
            core.canonicalize_updater_state(m)
            self._shard_updater_state()
        fields = self._fields(ds)
        batch_n = int(fields[0][0].shape[0])
        n, k = self.mesh.data, int(m.grad_accum)
        if k > 1 and batch_n % (k * n) != 0:
            raise ValueError(
                f"grad_accum={k} on a {n}-wide data mesh needs the batch "
                f"to split into {k} microbatches of whole shards; got "
                f"batch size {batch_n} (make it a multiple of {k * n})")
        if batch_n % n != 0:
            fields = self._pad(fields, batch_n)
        padded_n = int(fields[0][0].shape[0])
        has_masks = any(a is not None for v in fields[2:] if v
                        for a in v)
        local = self._use_local(has_masks)
        micro = self._rows(padded_n, k)
        batches = [m.batch_tensors(self._local_dataset(fields, rows))
                   for rows in micro]
        weights = [self._weights(fields, rows, j, local, k)
                   for j, rows in enumerate(micro)]

        ls = (core.ensure_loss_scale_state(m)
              if core.loss_scale_active(m) else None)
        sg_cfg = self._sg_config()
        sg = core.ensure_stat_guard_state(m) if sg_cfg is not None else None

        # dropout: the synchronous step draws the global mask, each rank
        # its rows of it (microbatch j from fold_in(key, j), as in JAX's
        # accumulation); the local step draws a mask of its own shard
        # from fold_in(key, rank), as JAX's shard_map step does
        rng = core.step_rng(m, m.iteration_count)
        if rng is not None and local:
            rng = random.fold_in(rng, self.mesh.rank)
        shard = padded_n // (k * n)

        def micro_grads(j, st):
            x, y, lm, fm = batches[j]
            key = rng if k == 1 or rng is None else random.fold_in(rng, j)
            window = (contextlib.nullcontext() if local else
                      random.row_window(self.mesh.rank * shard, shard))
            with window:
                return core.grad_step(
                    self._score_fn(weights[j]), m.params, st, x, y, lm, fm,
                    scale=None if ls is None else ls["scale"], rng=key)

        # (the layers import the kernels, whose attention imports this
        # package: imported here, not at the top)
        from deeplearning4j_tpu_torch.nn.layers.convolution import (
            global_batch_statistics,
        )

        # sync statistics over a group; one process's batch is global
        ctx = (contextlib.nullcontext() if local or not self._collective
               else global_batch_statistics(_AllReduceSum.apply, n))
        with ctx:
            if k > 1:
                (score, new_state), grads = core.accum_grad_step(
                    micro_grads, k, m.state, m.recurrent_names())
            else:
                (score, new_state), grads = micro_grads(0, m.state)
        grads, score, new_state = self._fused_all_reduce(
            grads, score, new_state, local)
        lrs = m.updater_def.scheduled_lrs(m.iteration_count)
        t = m.iteration_count + 1
        # after the all-reduce the gradients and score are the same on
        # every rank, so the finite probe and the guard's select are too
        out = core.finish_step(
            m.updater_def, grads, score, new_state, m.params,
            m.updater_state, m.state, lrs, t,
            guarded=self.divergence_guard is not None, ls=ls, sg=sg,
            sg_cfg=sg_cfg,
            update=(functools.partial(self._zero_update, lrs=lrs, t=t)
                    if self.zero else None))
        core.apply_step_out(m, out)
        m.iteration_count += 1
        m._last_score = out.score
        m._last_batch_rows = batch_n
        if self.divergence_guard is not None:
            self.divergence_guard.consult(m, out.ok)
        m._reset_recurrent_state()
        return out.score

    def fit(self, iterator, epochs: int = 1,
            prefetch: Optional[int] = None,
            grad_accum: Optional[int] = None,
            megastep: Optional[int] = None,
            validator=None, quarantine=None) -> list:
        """``epochs`` passes of ``iterator`` (every rank iterates the
        same global minibatches), one step each; returns the per-epoch
        mean scores. ``grad_accum=K`` sets the model's microbatch count
        (it persists, as on the engines). The iterator is reset after
        each epoch, also when an exception unwinds it."""
        if prefetch:
            raise NotImplementedError(
                "prefetch: the prefetching input pipeline arrives with "
                + _RUNTIME_SLICE + " (datasets/prefetch.py)")
        if validator is not None or quarantine is not None:
            raise NotImplementedError(
                "batch validation and quarantine arrive with "
                + _RUNTIME_SLICE + " (datasets/validate.py)")
        if megastep is not None and int(megastep) != 1:
            raise NotImplementedError(
                "megastep arrives with " + _RUNTIME_SLICE)
        m = self.model
        if grad_accum is not None:
            core.set_grad_accum(m, grad_accum)
        epoch_scores = []
        for _ in range(epochs):
            scores = []
            try:
                for ds in iterator:
                    scores.append(self.fit_minibatch(ds))
            finally:
                if hasattr(iterator, "reset"):
                    iterator.reset()
            epoch_scores.append(float(torch.stack(scores).mean())
                                if scores else float("nan"))
            m.epoch_count += 1
        return epoch_scores

    # -- what the port does not carry yet ------------------------------------

    def fit_megachunk(self, chunk):
        raise NotImplementedError("megastep (fit_megachunk) arrives with "
                                  + _RUNTIME_SLICE)

    def set_divergence_guard(self, guard) -> None:
        """(Un)install a ``resilience.DivergenceGuard`` on the trainer's
        step (the trainer's own, apart from any on the model); the
        model keeps a back-reference for checkpoint capture."""
        from deeplearning4j_tpu_torch.resilience.guard import (
            DivergenceGuard,
        )

        if guard is not None and not isinstance(guard, DivergenceGuard):
            raise TypeError("divergence_guard must be a DivergenceGuard or "
                            f"None, got {type(guard).__name__}")
        self.divergence_guard = guard
        self.model._ckpt_guard = guard

    def resume(self, source, load_updater: bool = True) -> int:
        raise NotImplementedError(
            "resume from a checkpoint manager arrives with "
            + _RUNTIME_SLICE + " (resilience/checkpoint.py)")


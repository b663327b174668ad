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
- a ``SparseEmbeddingLayer(row_sharded=True)``'s table is sharded by
  rows (JAX ``_row_sharded_embedding_param``): rank ``i`` of ``N`` holds
  rows ``[i·V/N, (i+1)·V/N)`` of ``W`` and of its updater state, and
  nothing else of them; the forward gathers the batch's rows from their
  owners, the backward sends each row's gradient to its owner, and the
  owner's rule updates its shard with the dense gradient of its rows
  (Adam's moments decay on rows no batch touched, as JAX's GSPMD step
  does). The exchange is ``all_reduce`` alone (``parallel/
  row_exchange.py``), so a gloo world on one card runs it too. The
  other gradients ride the flat bucket; the guard's and telemetry's
  global norm, a per-layer or per-parameter gradient normalization's
  norm and the L1/L2 penalty sum the shards' terms over the ranks.
  Under ``zero=True`` or a vocabulary the ranks do not divide, ``W``
  stays replicated with the JAX trainer's warning. A save gathers the table
  (``core.canonical_trees``), so the file is a replicated run's; a
  restore re-shards at the new world's width;
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

``fit`` is the JAX trainer's pipelined loop: ``prefetch=N`` runs the
batch's host work and its copy to the device (``place_minibatch``: this
rank's rows, pinned, copied on a CUDA stream of the prefetch worker's
own) on a ``PrefetchIterator`` worker; ``validator`` / ``quarantine``
screen every batch there first (``datasets/validate.py``); steps go
through an ``AsyncDispatchWindow`` (``max_in_flight`` enqueued, the
guard's flags read ``guard_lag`` steps late; a rollback guard reads at
once); ``megastep=K`` runs blocks of K steps as one chunk of this
trainer's own step, its fused all-reduce included (``fit_megachunk``,
``place_chunk``): on the card one CUDA-graph replay, on gloo CPU ranks
eagerly; the preemption check runs before each step (each chunk) and
listeners fire per step. ``resume`` restores a checkpoint into the
model. The global tracer gets a ``train.fit`` span with a
``train.epoch`` child an epoch, the active step profiler a record a
step (parented on the epoch's span), and ``enable_step_telemetry``
makes the step also return the global gradient's norm (after the
all-reduce, on the device), as in the JAX trainer.

``tensor_parallel=True`` over a mesh with a ``model`` axis
(``build_mesh(data, model)``) splits every parameter the JAX trainer's
``default_partition_rules`` split (``parallel/tensor_parallel.py``;
replicated where the axis does not divide, silently, as in JAX) and its
updater moments alike; the layers split their products over the model
ranks with explicit collectives, so a step equals the replicated step up
to the order of its sums. The gradient and score all-reduce runs over
the data group only; the global norms (the guard's and telemetry's,
gradient normalization's) and the L1/L2 penalty sum the shards' terms
over the model group; every model rank draws the same dropout masks
(the rows of its data index). A save gathers the shards, so the file is
a replicated run's; a restore re-shards at the new mesh. The JAX
trainer's refusals hold: ``zero=True`` and ``batch_stats="local"`` with
tensor parallelism. Not in this slice, and refused with a message: a
megastep chunk under tensor parallelism, drop-connect (its mask is drawn
on the whole weight) and a ``SparseEmbeddingLayer`` (ROADMAP).
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn import core, random
from deeplearning4j_tpu_torch.nn.updaters import normalize_layer_grads
from deeplearning4j_tpu_torch.observability import profiler
from deeplearning4j_tpu_torch.observability.trace import get_tracer
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, build_mesh


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
                 divergence_guard=None, zero: bool = False,
                 max_in_flight: int = 2, guard_lag: Optional[int] = None):
        """``batch_stats``: ``"sync"`` (BatchNormalization sees the global
        batch: the single-device math), ``"local"`` (each rank's own
        shard, the reference's worker semantics; running statistics
        averaged after each step) or ``"auto"`` (local exactly where it
        equals sync: no batch statistics, no dropout, no masks).
        ``zero=True`` shards the optimizer state 1/N over the ranks.
        ``max_in_flight`` / ``guard_lag``: ``fit``'s dispatch window."""
        if batch_stats not in ("auto", "sync", "local"):
            raise ValueError(
                f"batch_stats must be auto|sync|local, got {batch_stats!r}")
        if batch_stats == "local" and tensor_parallel:
            raise ValueError(
                "batch_stats='local' is incompatible with "
                "tensor_parallel=True: sharded weights need the GSPMD "
                "step, which computes global (sync) batch statistics")
        if zero and tensor_parallel:
            raise ValueError(
                "zero=True shards optimizer state over the data axis; "
                "tensor_parallel=True already shards it with the "
                "params — combining the two layouts is not supported")
        if zero and batch_stats == "local":
            raise ValueError(
                "zero=True needs the synchronous step; batch_stats='local' "
                "keeps per-rank replicated updater state, exactly what "
                "zero removes")
        core.check_sgd_step(model, "DistributedTrainer")
        self.model = model
        self.max_in_flight = int(max_in_flight)
        self.guard_lag = guard_lag
        self._steps = {}
        self._epoch_span = None  # the open train.epoch span
        self.set_divergence_guard(divergence_guard)
        self.mesh = mesh if mesh is not None else build_mesh(
            device=model.device)
        self._check_device()
        self.batch_stats = batch_stats
        self.zero = bool(zero)
        self.tensor_parallel = bool(tensor_parallel) and self.mesh.model > 1
        if (self.zero and self.mesh.data > 1 and self.mesh.backend == "gloo"
                and model.device.type == "cuda"):
            raise ValueError(
                "zero=True over a gloo group of CUDA tensors: gloo has no "
                "all_gather or reduce_scatter on CUDA tensors")
        self._is_graph = hasattr(model.conf, "vertices")
        if model.params is None:
            model.init()
        # a model that arrives sharded (an earlier zero=True or
        # row-sharded trainer) is gathered whole first, never sliced twice
        core.canonicalize_updater_state(model)
        self._broadcast_model()
        self._zero_ranges: Dict[str, Dict[str, tuple]] = {}
        self._row_layers = self._plan_row_sharding()
        if self._row_layers:
            self._shard_rows()
        self._tp_layout = self._plan_tensor_parallel()
        if self._tp_layout:
            self._shard_tensor_parallel()
        if self.zero:
            self._shard_updater_state()
        self._publish_updater_bytes()

    # -- placement ----------------------------------------------------------

    def _check_device(self) -> None:
        """One rank drives one device: the model lies on the mesh's
        device, CUDA models talk over NCCL and CPU models over gloo. A
        CUDA model goes on over gloo only where the world's caller named
        that backend (``init_distributed(backend="gloo")``, several
        ranks on one card), and never on the CPU."""
        from deeplearning4j_tpu_torch.parallel.mesh import backend_named

        m, mesh = self.model, self.mesh
        if mesh.backend is None:
            if mesh.data != 1:
                raise ValueError("a mesh of several ranks needs a group")
            return
        want = "nccl" if m.device.type == "cuda" else "gloo"
        if (m.device.type == "cuda" and mesh.backend == "gloo"
                and backend_named()):
            want = "gloo"
        if mesh.backend != want:
            raise RuntimeError(
                f"a {m.device.type} model needs a {want} group, the world "
                f"was formed with {mesh.backend}")
        if m.device != mesh.device:
            raise RuntimeError(f"the model lies on {m.device}, this rank "
                               f"drives {mesh.device}")

    def _plan_row_sharding(self) -> List[str]:
        """The layers whose ``W`` rows shard over the ranks (JAX
        ``_spec_for``'s row branch): every ``SparseEmbeddingLayer`` with
        ``row_sharded=True`` over more than one rank, except where a
        fallback keeps ``W`` replicated, loudly, with the JAX trainer's
        words: ``zero=True`` and an indivisible vocabulary."""
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            SparseEmbeddingLayer,
        )

        n = self.mesh.data
        if n == 1 or not core.has_row_sharded_embedding(self.model):
            return []
        out = []
        for lname, lc in core.named_layer_confs(self.model):
            if not (isinstance(lc, SparseEmbeddingLayer)
                    and lc.row_sharded):
                continue
            if self.zero:
                warnings.warn(
                    f"SparseEmbeddingLayer {lname!r}: row sharding "
                    "falls back to replication under zero=True (the "
                    "flat P('data') updater layout owns the data "
                    "axis); use the embeddings/ subsystem for tables "
                    "that need both", stacklevel=3)
            elif lc.n_in % n != 0:
                warnings.warn(
                    f"SparseEmbeddingLayer {lname!r}: vocab {lc.n_in} not "
                    f"divisible by data axis {n}; falling back to "
                    "replication", stacklevel=3)
            else:
                out.append(lname)
        return out

    def _plan_tensor_parallel(self) -> Optional[dict]:
        """``{"mesh": mesh, "params": {layer: {param: (axis, shard
        shape)}}}`` of the parameters the partition rules split over the
        model axis (JAX ``_spec_for``), or None without tensor
        parallelism."""
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            SparseEmbeddingLayer,
        )
        from deeplearning4j_tpu_torch.parallel import tensor_parallel

        if not self.tensor_parallel:
            return None
        n = self.mesh.model
        plan = {}
        for lname, lc in core.named_layer_confs(self.model):
            if isinstance(lc, SparseEmbeddingLayer):
                raise NotImplementedError(
                    f"SparseEmbeddingLayer {lname!r} under "
                    "tensor_parallel=True: its rows shard over the data "
                    "axis; the two layouts together are not ported "
                    "(ROADMAP)")
            if lc.dropout > 0.0 and getattr(lc, "drop_connect", False):
                raise NotImplementedError(
                    f"layer {lname!r}: drop-connect under "
                    "tensor_parallel=True (its mask is drawn on the whole "
                    "weight) is not ported (ROADMAP)")
            for pn, p in self.model.params.get(lname, {}).items():
                axis = tensor_parallel.spec_for(lc, pn, p.shape, n)
                if axis is None:
                    continue
                shape = list(p.shape)
                shape[axis] //= n
                plan.setdefault(lname, {})[pn] = (axis, tuple(shape))
        return {"mesh": self.mesh, "params": plan}

    def _shard_tensor_parallel(self) -> None:
        """Keep this rank's shard of every split parameter and of its
        updater moments; the model is marked ``_tp_layout``, which its
        forward hands to the layers (``canonicalize_updater_state`` and
        a save gather it back)."""
        from deeplearning4j_tpu_torch.parallel import tensor_parallel

        m, mesh = self.model, self.mesh
        for ln, entries in self._tp_layout["params"].items():
            for pn, (axis, _) in entries.items():
                m.params[ln][pn] = tensor_parallel.shard_of(
                    m.params[ln][pn], axis, mesh)
                if pn in m.updater_state.get(ln, {}):
                    m.updater_state[ln][pn] = tuple(
                        tensor_parallel.shard_of(a, axis, mesh)
                        for a in m.updater_state[ln][pn])
        m._tp_layout = self._tp_layout

    def _tp_sharded(self, ln: str, pn: str) -> bool:
        return bool(self._tp_layout) and pn in self._tp_layout[
            "params"].get(ln, {})

    def _shard_rows(self) -> None:
        """Keep this rank's rows of each row-sharded ``W`` and of its
        updater moments, nothing else of them; the model is marked
        ``_row_layout`` (``canonicalize_updater_state`` and a save gather
        it back)."""
        from deeplearning4j_tpu_torch.parallel import row_exchange

        m, n, r = self.model, self.mesh.data, self.mesh.rank
        for ln in self._row_layers:
            m.params[ln]["W"] = row_exchange.shard_rows(m.params[ln]["W"],
                                                        n, r)
            if ln in m.updater_state and "W" in m.updater_state[ln]:
                m.updater_state[ln]["W"] = tuple(
                    row_exchange.shard_rows(a, n, r)
                    for a in m.updater_state[ln]["W"])
        m._row_layout = {"shards": n, "rank": r,
                         "layers": list(self._row_layers)}

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
        if not self._collective or self.mesh.data * self.mesh.model == 1:
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
        self._publish_embedding_gauge()

    def _publish_embedding_gauge(self) -> None:
        """``embedding_shard_bytes`` (JAX ``_publish_embedding_gauge``,
        the gauge ``embeddings/table.py`` also sets): the bytes of this
        rank's shard of every row-sharded ``W``, summed (a replicated
        fallback's whole table)."""
        if not core.has_row_sharded_embedding(self.model):
            return
        from deeplearning4j_tpu_torch.embeddings.table import (
            note_shard_bytes,
        )
        from deeplearning4j_tpu_torch.nn.layers.feedforward import (
            SparseEmbeddingLayer,
        )

        total = 0
        for ln, lc in core.named_layer_confs(self.model):
            if isinstance(lc, SparseEmbeddingLayer) and lc.row_sharded:
                w = self.model.params[ln]["W"]
                total += w.numel() * w.element_size()
        self.embedding_shard_bytes = int(total)
        note_shard_bytes(total)

    def gather_updater_state(self):
        """The updater state in the canonical (parameter-shaped) layout:
        the model's own where it is not sharded, gathered (on every
        rank) where it is."""
        return core.canonical_trees(self.model)[1]

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
        n, r = self.mesh.data, self.mesh.data_index
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
        if (self.zero or self.tensor_parallel
                or self.model.grad_accum > 1
                or core.loss_scale_active(self.model)
                or self._sg_config() is not None):
            # loss-scale and EWMA state ride the synchronous step
            return False
        if self.batch_stats != "auto":
            return self.batch_stats == "local"
        return not (self._uses_batch_statistics() or has_masks or any(
            layer.dropout > 0.0 for layer in self.model.layer_confs()))

    # -- placement --------------------------------------------------------------

    def _prepare(self, ds):
        """The host half of a step: the batch's fields (padded where a
        trailing batch does not split over the ranks), this rank's rows
        of each microbatch concatenated, each microbatch's loss weights,
        whether the local step runs, and the global row count."""
        m = self.model
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
        weights = [self._weights(fields, rows, j, local, k)
                   for j, rows in enumerate(micro)]
        mine = self._local_dataset(fields, np.concatenate(micro))
        return mine, weights, local, has_masks, batch_n

    def _layout(self, ds):
        """(features, labels, labels mask, features mask) of a host
        batch in the engine's layout: arrays for a
        ``MultiLayerNetwork``, lists for a ``ComputationGraph``."""
        if self._is_graph:
            from deeplearning4j_tpu_torch.nn.graph import _ds_arrays

            f, l, fm, lm = _ds_arrays(ds)
            return f, l, lm, fm
        return (ds.features, ds.labels, getattr(ds, "labels_mask", None),
                getattr(ds, "features_mask", None))

    def place_minibatch(self, ds):
        """This rank's rows of one global minibatch, padded and masked
        where needed, cast and copied to the device (JAX
        ``place_minibatch``): a ``PlacedDataSet`` with the microbatches'
        loss weights. On the card the copies run on the calling thread's
        own CUDA stream from pinned memory, so ``PrefetchIterator(base,
        placement=trainer.place_minibatch)`` overlaps them with the step
        (the step waits on their event). An already placed batch passes
        through."""
        from deeplearning4j_tpu_torch.datasets.api import PlacedDataSet

        if isinstance(ds, PlacedDataSet):
            return ds
        mine, weights, local, has_masks, batch_n = self._prepare(ds)
        x, y, lm, fm = self._layout(mine)
        (x, y, lm, fm), ready = core.place_tree(
            (x, y, lm, fm), self.model.device, core.dtype_of(self.model.conf))
        return PlacedDataSet(x, y, features_mask=fm, labels_mask=lm,
                             num_rows=batch_n, has_masks=has_masks,
                             weights=weights, local=local, ready=ready)

    def place_chunk(self, batches):
        """K same-shaped global minibatches as one placed block (JAX
        ``place_chunk``): this rank's rows of each stacked ``[k, ...]``
        and copied to the device in one go, with a ``[k, w]`` table of
        each step's loss weights; the megastep feed's placement, run on
        the prefetch worker by ``PrefetchIterator(megastep=K,
        chunk_placement=trainer.place_chunk)``. Accepts a list of host
        batches or a ``ChunkedDataSet``."""
        from deeplearning4j_tpu_torch.datasets.api import (
            ChunkedDataSet,
            PlacedChunk,
        )

        if isinstance(batches, PlacedChunk):
            return batches
        if isinstance(batches, ChunkedDataSet):
            batches = batches.to_datasets()
        prepared = [self._prepare(b) for b in batches]
        locals_ = {p[2] for p in prepared}
        if len(locals_) != 1:
            raise ValueError("a megastep block mixes masked and unmasked "
                             "batches; they take different steps")
        laid = [self._layout(p[0]) for p in prepared]

        def stack(i):
            first = laid[0][i]
            if first is None:
                return None
            if isinstance(first, list):
                return [None if first[j] is None else
                        np.stack([np.asarray(b[i][j]) for b in laid])
                        for j in range(len(first))]
            return np.stack([np.asarray(b[i]) for b in laid])

        table = np.asarray([[w for ws, wr in p[1] for w in (*ws, wr)]
                            for p in prepared], np.float32)
        (x, y, lm, fm), ready = core.place_tree(
            tuple(stack(i) for i in range(4)), self.model.device,
            core.dtype_of(self.model.conf))
        wt, wready = core.place_tree(table, self.model.device, None)
        if wready is not None:  # one event after both copies
            ready = wready
        return PlacedChunk(x, y, features_mask=fm, labels_mask=lm,
                           num_rows=sum(p[4] for p in prepared),
                           weights=wt, local=locals_.pop(), ready=ready)

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
        averaged. A row-sharded ``W``'s gradient is already its owner's
        sum over the ranks (the row exchange's backward) and stays out."""
        if not self._collective:
            return grads, score, state
        n = self.mesh.data
        sharded = {ln: grads[ln]["W"] for ln in self._row_layers}
        grads = {ln: {pn: g for pn, g in lg.items()
                      if not (pn == "W" and ln in sharded)}
                 for ln, lg in grads.items()}
        g_leaves = [g for lg in grads.values() for g in lg.values()]
        recurrent = set(self.model.recurrent_names())
        s_leaves = ([t for ln, st in state.items() if ln not in recurrent
                     for t in st.values() if t.is_floating_point()]
                    if local and n > 1 else [])
        leaves = g_leaves + [score.reshape(1)] + s_leaves
        dt = _common_dtype(leaves)
        flat = torch.cat([t.reshape(-1).to(dt) for t in leaves])
        dist.all_reduce(flat, group=self.mesh.data_group)
        off = 0

        def take(t):
            nonlocal off
            v = flat[off:off + t.numel()].view_as(t).to(t.dtype)
            off += t.numel()
            return v

        grads = {ln: {pn: take(g) for pn, g in lg.items()}
                 for ln, lg in grads.items()}
        for ln, g in sharded.items():
            grads[ln]["W"] = g
        score = take(score.reshape(1)).reshape(())
        if s_leaves:
            state = {ln: ({k: (take(t) / n if t.is_floating_point() else t)
                           for k, t in st.items()}
                          if ln not in recurrent else st)
                     for ln, st in state.items()}
        return grads, score, state

    def _is_shard(self, ln: str, pn: str) -> bool:
        """True for a row-sharded table's ``W`` and a tensor-parallel
        shard."""
        return ((pn == "W" and ln in self._row_layers)
                or self._tp_sharded(ln, pn))

    @property
    def _shard_group(self):
        """The group a shard's terms sum over: the model ranks under
        tensor parallelism, else (row-sharded tables) every rank."""
        return self.mesh.model_group if self._tp_layout else None

    def _norm_sq(self, grads) -> torch.Tensor:
        """The squared global norm of the gradients where parameters are
        sharded: the replicated leaves' (the same on every rank) plus the
        shards' squares summed over the shards' ranks."""
        from deeplearning4j_tpu_torch.resilience.guard import (
            grad_global_norm_sq,
        )

        rest = {ln: {pn: g for pn, g in lg.items()
                     if not self._is_shard(ln, pn)}
                for ln, lg in grads.items()}
        shards = grad_global_norm_sq(
            [g for ln, lg in grads.items() for pn, g in lg.items()
             if self._is_shard(ln, pn)]).reshape(1)
        dist.all_reduce(shards, group=self._shard_group)
        return grad_global_norm_sq(rest) + shards[0]

    def _row_update(self, grads, params, upd_state, lrs, t):
        """The updater's rule where parameters are sharded: a gradient
        normalization's norms sum a shard's squares over its ranks."""
        from deeplearning4j_tpu_torch.parallel.row_exchange import sum_ranks

        def sq(ln, pn, g):
            s = torch.sum(g * g)
            return (sum_ranks(s, self._shard_group)
                    if self._is_shard(ln, pn) else s)

        return self.model.updater_def.update(grads, upd_state, params, lrs,
                                             t, sq=sq)

    def _sg_config(self):
        """The ``StatGuardConfig`` of the trainer's own guard (the
        trainer's and the engine's guards are separate installs)."""
        g = self.divergence_guard
        return g.stats if g is not None else None

    def _zero_update(self, grads, params, upd_state, lrs, t):
        """ZeRO-1: the rule on this rank's slice of every parameter, then
        one all-gather of the updated slices."""
        upd = self.model.updater_def
        new_upd, mine, order = {}, [], []
        for ln, lg in grads.items():
            lg = normalize_layer_grads(upd.settings[ln], lg)
            new_upd[ln] = {}
            for pn, g in lg.items():
                p_sl = self._flat_slice(params[ln][pn], ln, pn)
                g_sl = self._flat_slice(g, ln, pn)
                p_new, new_upd[ln][pn] = upd.update_param(
                    ln, pn, g_sl, upd_state[ln][pn], p_sl, lrs, t)
                mine.append(p_new)
                order.append((ln, pn))
        new_params = {ln: {} for ln in params}
        if not order:
            return params, new_upd
        flat = torch.cat(mine)
        parts = ([flat] if not self._collective else
                 [torch.empty_like(flat) for _ in range(self.mesh.data)])
        if self._collective:
            dist.all_gather(parts, flat)
        off = 0
        for (ln, pn), sl in zip(order, mine):
            p = params[ln][pn]
            size = sl.numel()
            full = torch.cat([q[off:off + size] for q in parts])
            new_params[ln][pn] = full[:p.numel()].view_as(p).clone()
            off += size
        return new_params, new_upd

    def _step_for(self, local: bool):
        """The trainer's step for the model's current flavours (cached:
        a megastep chunk is captured once for each step function):
        ``step(params, upd_state, state, x, labels, lmask, lrs, t,
        fmask=None, ls=None, sg=None, rng=None, weights=None) ->
        StepOut`` on this rank's rows (the microbatches' shards
        concatenated), with ``weights`` each microbatch's ``([one an
        output], penalty)`` loss weights, as host numbers or a row of
        a chunk's table. The microbatches' gradients, the one fused
        all-reduce, then ``core.finish_step`` (loss scaling, the guard,
        ZeRO's sliced update)."""
        m = self.model
        key = (local, int(m.grad_accum), core.loss_scale_active(m),
               id(self._sg_config()), self.divergence_guard is not None,
               self.zero, m.remat, m._telemetry_grad_norm)
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = self._build_step(local)
        return step

    def _build_step(self, local: bool):
        m = self.model
        k, n, rank = int(m.grad_accum), self.mesh.data, self.mesh.data_index
        n_out = len(m.conf.outputs) if self._is_graph else 1
        guarded = self.divergence_guard is not None
        sg_cfg = self._sg_config()
        ls_on = core.loss_scale_active(m)
        telemetry = m._telemetry_grad_norm
        recurrent = m.recurrent_names()
        sharded = bool(self._row_layers or self._tp_layout)

        def unpack(weights):
            if not torch.is_tensor(weights):
                return weights
            w = n_out + 1
            return [([weights[j * w + i] for i in range(n_out)],
                     weights[j * w + n_out]) for j in range(k)]

        def step(params, upd_state, state, x, labels, lmask, lrs, t,
                 fmask=None, ls=None, sg=None, rng=None, weights=None):
            wts = unpack(weights)
            micro = list(zip(*(core.split_rows(a, k)
                               for a in (x, labels, lmask, fmask))))
            shard = int(core.split_rows(x, k)[0][0].shape[0]
                        if self._is_graph else micro[0][0].shape[0])
            # dropout: the synchronous step draws the global mask, each
            # rank its rows of it (microbatch j from fold_in(key, j), as
            # in JAX's accumulation); the local step draws a mask of its
            # own shard from fold_in(key, rank), as JAX's shard_map step
            key = rng
            if key is not None and local:
                key = random.fold_in(key, rank)
            scale = None if ls is None else ls["scale"]

            def micro_grads(j, st):
                xj, yj, lmj, fmj = micro[j]
                kj = key if k == 1 or key is None else random.fold_in(key, j)
                window = (contextlib.nullcontext() if local else
                          random.row_window(rank * shard, shard))
                with window:
                    return core.grad_step(self._score_fn(wts[j]), params,
                                          st, xj, yj, lmj, fmj, scale=scale,
                                          rng=kj)

            # (the layers import the kernels, whose attention imports
            # this package: imported here, not at the top)
            from deeplearning4j_tpu_torch.nn.layers.convolution import (
                global_batch_statistics,
            )
            from deeplearning4j_tpu_torch.parallel.row_exchange import (
                sum_ranks,
            )

            # sync statistics over a group; one process's batch is global
            ctx = (contextlib.nullcontext() if local or not self._collective
                   else global_batch_statistics(functools.partial(
                       sum_ranks, group=self.mesh.data_group), n))
            with ctx:
                if k > 1:
                    (score, new_state), grads = core.accum_grad_step(
                        micro_grads, k, state, recurrent)
                else:
                    (score, new_state), grads = micro_grads(0, state)
            grads, score, new_state = self._fused_all_reduce(
                grads, score, new_state, local)
            # after the all-reduce the gradients and score are the same on
            # every rank, so the finite probe and the guard's select are
            return core.finish_step(
                m.updater_def, grads, score, new_state, params, upd_state,
                state, lrs, t, guarded=guarded,
                ls=ls if ls_on else None, sg=sg, sg_cfg=sg_cfg,
                update=(functools.partial(self._zero_update, params=params,
                                          upd_state=upd_state, lrs=lrs, t=t)
                        if self.zero else
                        functools.partial(self._row_update, params=params,
                                          upd_state=upd_state, lrs=lrs, t=t)
                        if sharded else None), telemetry=telemetry,
                norm_sq=self._norm_sq if sharded else None)

        return step

    def _check_zero_layout(self) -> None:
        m = self.model
        core.check_sgd_step(m, "DistributedTrainer")
        want_rows = ({"shards": self.mesh.data, "rank": self.mesh.rank,
                      "layers": list(self._row_layers)}
                     if self._row_layers else None)
        if ((self.zero and m._zero_layout != {"shards": self.mesh.data})
                or getattr(m, "_row_layout", None) != want_rows
                or getattr(m, "_tp_layout", None) is not self._tp_layout):
            # the engine's own fit (or a restore) made the trees whole
            # in between
            core.canonicalize_updater_state(m)
            if self._row_layers:
                self._shard_rows()
            if self.zero:
                self._shard_updater_state()
            if self._tp_layout:
                self._shard_tensor_parallel()

    def fit_minibatch(self, ds, _window=None) -> torch.Tensor:
        """One synchronous data-parallel step on the global minibatch
        ``ds`` (every rank passes the same one; or a ``PlacedDataSet``
        from ``place_minibatch``); returns the global score as a 0-d
        tensor on the device."""
        m = self.model
        prof = profiler.get_active_profiler()
        if prof is not None:
            span = self._epoch_span
            prof.begin_step(m.iteration_count + 1,
                            parent=span.context if span is not None
                            else None, device=m.device)
        self._check_zero_layout()
        placed = self.place_minibatch(ds).wait()
        ls = (core.ensure_loss_scale_state(m)
              if core.loss_scale_active(m) else None)
        sg = (core.ensure_stat_guard_state(m)
              if self._sg_config() is not None else None)
        out = self._step_for(placed.local)(
            m.params, m.updater_state, m.state, placed.features,
            placed.labels, placed.labels_mask,
            m.updater_def.scheduled_lrs(m.iteration_count),
            m.iteration_count + 1, placed.features_mask, ls=ls, sg=sg,
            rng=core.step_rng(m, m.iteration_count), weights=placed.weights)
        core.apply_step_out(m, out)
        m.iteration_count += 1
        m._last_score = out.score
        m._last_batch_rows = placed.num_examples()
        core.after_step(m, self.divergence_guard, out.ok, _window)
        m._reset_recurrent_state()
        if prof is not None:
            prof.end_step(model=m, ds=ds, score=out.score,
                          grad_norm=m._last_grad_norm,
                          rows=m._last_batch_rows)
        return out.score

    def enable_step_telemetry(self, enabled: bool = True) -> None:
        """(Un)install step telemetry on the trainer's steps (JAX
        ``DistributedTrainer.enable_step_telemetry``): as the engines',
        the step also returns the gradient's global norm, here of the
        all-reduced gradient. The flag lives on the model."""
        core.enable_step_telemetry(self.model, enabled)

    def _can_megastep(self) -> bool:
        """Megastep under this trainer (JAX ``_can_megastep``): the
        model's eligibility (``core.can_megastep``) and no rollback
        policy on the trainer's own guard."""
        from deeplearning4j_tpu_torch.resilience.guard import ROLLBACK

        g = self.divergence_guard
        if g is not None and g.policy == ROLLBACK:
            return False
        if self.tensor_parallel and core.can_megastep(self.model):
            self._refuse_chunk()
        return core.can_megastep(self.model)

    def _refuse_chunk(self) -> None:
        raise NotImplementedError(
            "a megastep chunk under tensor_parallel=True is not ported "
            "(ROADMAP: tensor parallelism inside a megastep or scan "
            "chunk); fit per step (megastep=1)")

    def _launch_chunk(self, chunk, feed):
        """One placed block through ``feed`` (``core.MegastepFeed``) as a
        chunk of this trainer's step."""
        if self.tensor_parallel:
            self._refuse_chunk()
        self._check_zero_layout()
        c = core.prestacked_chunk(self.model, chunk)
        feed.run(c, step=self._step_for(chunk.local),
                 stat_guard=self._sg_config() is not None)

    def fit_megachunk(self, chunk) -> float:
        """One K-step chunk of the trainer's step from a placed block
        (``place_chunk``; a list of host batches is placed here), read
        back at once: returns the chunk's last score."""
        from deeplearning4j_tpu_torch.datasets.api import PlacedChunk

        if not isinstance(chunk, PlacedChunk):
            chunk = self.place_chunk(chunk)
        feed = core.MegastepFeed(self.model, guard=self.divergence_guard)
        self._launch_chunk(chunk, feed)
        feed.drain()
        return float(self.model._last_score)

    def _fit_epoch_megastep(self, source, window) -> list:
        """One megastep epoch (JAX ``_fit_epoch_megastep``): the stream
        grouped into blocks of K (or taken as placed blocks from a
        chunk-mode prefetch), each one chunk, one in flight; a lone or
        multi-input batch takes the per-step step. The preemption check
        runs before each item, so the chunk boundaries are the
        emergency checkpoint's. Returns the scores (a step's as a
        tensor, a chunk's last as a float), in order."""
        from deeplearning4j_tpu_torch.datasets.api import (
            ChunkedDataSet,
            PlacedChunk,
            PlacedDataSet,
        )
        from deeplearning4j_tpu_torch.datasets.prefetch import _chunk_sig
        from deeplearning4j_tpu_torch.parallel import control_plane
        from deeplearning4j_tpu_torch.resilience import preemption

        m = self.model
        k_target = int(m.megastep)
        scores = []
        feed = core.MegastepFeed(m, guard=self.divergence_guard,
                                 scores=scores)

        class _Quiesce:  # the preemption path drains both
            @staticmethod
            def drain():
                feed.drain()
                window.drain()

        buf, sig = [], None

        def single(ds):
            feed.drain()
            scores.append(self.fit_minibatch(ds, _window=window))

        def flush():
            nonlocal buf
            if len(buf) == 1:
                single(buf[0])
            elif buf:
                window.drain()
                self._launch_chunk(self.place_chunk(buf), feed)
            buf = []

        prefetch = source if hasattr(source, "shutdown") else None
        try:
            for ds in iter(source):
                preemption.check_fit(m, window=_Quiesce, prefetch=prefetch)
                control_plane.check_fit(m)
                if isinstance(ds, (ChunkedDataSet, PlacedChunk)):
                    flush()
                    sig = None
                    if ds.k >= 2:
                        window.drain()
                        self._launch_chunk(self.place_chunk(ds), feed)
                    else:
                        for b in ds.to_datasets():
                            single(b)
                    continue
                if isinstance(ds, PlacedDataSet) or isinstance(
                        ds.features, (list, tuple)):
                    flush()
                    sig = None
                    single(ds)
                    continue
                s = _chunk_sig(ds)
                if buf and s != sig:
                    flush()
                sig = s
                buf.append(ds)
                if len(buf) >= k_target:
                    flush()
            flush()
            feed.drain()
        finally:
            feed.launched = None
        return scores

    def fit(self, iterator, epochs: int = 1,
            prefetch: Optional[int] = None,
            grad_accum: Optional[int] = None,
            megastep: Optional[int] = None,
            validator=None, quarantine=None) -> list:
        """``epochs`` passes of ``iterator`` (every rank iterates the same
        global minibatches), pipelined (JAX ``DistributedTrainer.fit``):
        ``prefetch=N`` wraps the iterator in a depth-N
        ``PrefetchIterator`` placing each batch (``place_minibatch``; a
        block of K under megastep, ``place_chunk``) on its worker;
        ``validator`` (default the model's ``set_batch_validator`` one)
        screens every batch first, on the worker when prefetching,
        quarantining rejects to ``quarantine`` without advancing the
        iteration count; steps go through an ``AsyncDispatchWindow``;
        ``megastep=K`` runs blocks of K as chunks (``fit_megachunk``;
        the knob persists on the model, as ``grad_accum=K`` does). The
        trajectory is bitwise the synchronous per-step loop's. Returns
        the per-epoch mean scores (the one read each epoch). The source
        is reset after each epoch, also when an exception unwinds it."""
        from deeplearning4j_tpu_torch.observability import flightrec
        from deeplearning4j_tpu_torch.parallel.dispatch import (
            AsyncDispatchWindow,
        )
        from deeplearning4j_tpu_torch.parallel import control_plane
        from deeplearning4j_tpu_torch.resilience import preemption

        m = self.model
        if grad_accum is not None:
            core.set_grad_accum(m, grad_accum)
        if megastep is not None:
            core.set_transforms(m, megastep=megastep)
        use_mega = self._can_megastep()
        if validator is None:
            validator = m._batch_validator
        if validator is not None:
            from deeplearning4j_tpu_torch.datasets.validate import (
                ValidatingIterator,
            )

            if quarantine is None:
                quarantine = m._quarantine_store
            if not isinstance(iterator, ValidatingIterator):
                iterator = ValidatingIterator(iterator, validator,
                                              quarantine=quarantine)
        source = iterator
        owned_prefetch = None
        if prefetch is not None and int(prefetch) > 0:
            from deeplearning4j_tpu_torch.datasets.prefetch import (
                PrefetchIterator,
            )

            if not isinstance(iterator, PrefetchIterator):
                source = owned_prefetch = PrefetchIterator(
                    iterator, queue_depth=int(prefetch),
                    placement=self.place_minibatch,
                    megastep=int(m.megastep) if use_mega else 1,
                    chunk_placement=self.place_chunk)
        window = AsyncDispatchWindow(
            model=m, guard_fn=lambda: self.divergence_guard,
            max_in_flight=self.max_in_flight, guard_lag=self.guard_lag)
        prefetching = source if hasattr(source, "shutdown") else None
        epoch_scores = []
        tracer = get_tracer()
        fit_span = tracer.start_span(
            "train.fit", attrs={"epochs": int(epochs),
                                "engine": type(m).__name__,
                                "max_in_flight": int(self.max_in_flight)})
        try:
            for _ in range(epochs):
                epoch_span = tracer.start_span(
                    "train.epoch", parent=fit_span.context,
                    attrs={"epoch": int(m.epoch_count)})
                self._epoch_span = epoch_span
                for listener in m.listeners:
                    if hasattr(listener, "on_epoch_start"):
                        listener.on_epoch_start(m)
                scores = []
                try:
                    if use_mega:
                        scores = self._fit_epoch_megastep(source, window)
                    else:
                        for ds in iter(source):
                            preemption.check_fit(m, window=window,
                                                 prefetch=prefetching)
                            control_plane.check_fit(m)
                            scores.append(self.fit_minibatch(
                                ds, _window=window))
                    window.drain()
                finally:
                    if hasattr(source, "reset"):
                        source.reset()
                epoch_scores.append(float(torch.stack([
                    (s if torch.is_tensor(s) else torch.tensor(s)).float()
                    .to(m.device) for s in scores]).mean())
                    if scores else float("nan"))
                for listener in m.listeners:
                    if hasattr(listener, "on_epoch_end"):
                        listener.on_epoch_end(m)
                m.epoch_count += 1
                epoch_span.set_attr("score", epoch_scores[-1])
                epoch_span.end()
                self._epoch_span = None
        except BaseException as e:
            window.abandon()
            prof = profiler.get_active_profiler()
            if prof is not None:
                prof.abandon_step()
            span, self._epoch_span = self._epoch_span, None
            if span is not None:
                span.end(status=type(e).__name__)
            fit_span.end(status=type(e).__name__)
            if not isinstance(e, preemption.PreemptedException):
                flightrec.dump_on_crash("fit_exception")
            raise
        finally:
            if owned_prefetch is not None:
                owned_prefetch.shutdown()
        fit_span.end()
        return epoch_scores

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
        """Restore a checkpoint into the trainer's model (JAX
        ``DistributedTrainer.resume``): the parameters, updater state,
        layer state and step count from ``source``, a
        ``CheckpointManager`` (its newest restorable version) or a
        checkpoint zip; every rank restores the same bytes, and the
        trainer re-shards them (ZeRO's moments, row-sharded tables) at
        this world's width. Returns the restored step, so the caller can
        skip the batches already consumed. The continuation is exact:
        keys, schedules and Adam's ``t`` derive from the step count."""
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            restore_into,
        )

        _, step = restore_into(self.model, source,
                               load_updater=load_updater)
        self._check_zero_layout()
        return step

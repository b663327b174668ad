"""The sequential forward, the score and the train step shared by the
network engines.

Counterpart of ``deeplearning4j_tpu/nn/core.py`` for the host-to-device
move with its cast on the device (``to_device``), the sequential
forward (inference and training, with the features mask),
``sequential_score`` with the L1/L2 penalty, the train step
(``grad_step`` + ``finish_step``, assembled by ``build_step``) with its
flavours: dynamic loss scaling for f16 compute, the divergence guard
and the statistical guard, each a select on the device; gradient
accumulation over contiguous microbatches (``accum_grad_step``), the
whole-net transforms (``set_transforms``: ``remat`` through
``torch.utils.checkpoint``, ``scan_layers`` accepted) and the
``rnn_time_step`` bookkeeping (``stream_guard_and_prime``,
``extract_stream_state``). PyTorch runs eagerly, so the step is an
ordinary function that returns new parameters, updater state and layer
state (BatchNormalization's running statistics). The inference forward
folds a Conv(identity) -> BatchNormalization pair into one conv kernel
launch, as the JAX package's does. Dropout keys: the step's is
``fold_in(PRNGKey(conf.seed), iteration)`` (``step_rng``), layer i's
``fold_in(step key, i)`` (``layer_rng``; ``nn/random.py``). ``megastep``
(JAX's K steps a dispatch) runs K steps a chunk with one readback
(``run_megastep_chunk``): eagerly on the CPU, on the card one replay of
the chunk captured in a CUDA graph (``GraphedChunk``). The scan path
(JAX ``build_multi_step`` / ``fit_epoch_scan``, the engines' default
with ``scan_chunk = 16``) runs up to ``scan_chunk`` same-shaped
minibatches of the bare step flavour as one such chunk, with no
readback; ``fit_epochs_device_cached`` keeps a list's stacked chunks on
the device across epochs (within ``device_cache_bytes``), and the
fused truncated-BPTT scan threads the recurrent carry through a chunk
of TBPTT segments, zeroed by a per-step reset flag. ``fit_batches`` is
both engines' epoch loop (JAX ``core.fit_batches``): the batch
validator, layer-wise pretraining first where the configuration asks
for it (``pretrain``; no backprop after it with ``backprop=False``),
the listeners' epoch hooks, the preemption check at each
step (each chunk under megastep and the scan), the order megastep,
device-cached replay, scan epoch, per-step loop, the last through an
``AsyncDispatchWindow`` (``max_in_flight`` steps enqueued, the guard's
flags read ``guard_lag`` steps late). The active ``StepProfiler``
(``observability/profiler.py``) sees each step, or each chunk as one
record; with step telemetry on (``enable_step_telemetry``) the step
also returns the gradient's global norm, computed on the device.
``build_pretrain_step`` is one pretrainable layer's update on its
precomputed input (both engines' ``pretrain``). The line-search solvers
(``optimize/solvers.py``) take the engines' ``fit_minibatch`` instead of
the step; the chunk paths and the data-parallel trainers run the SGD
step alone and refuse them (``check_sgd_step``).
"""

from __future__ import annotations

import functools
import gc
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from deeplearning4j_tpu_torch.nn import random

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


# integer types that cross to the device at their own width (uint8
# pixels and one-hots: a quarter of the f32 bytes) and are cast there
NARROW_INTS = (torch.uint8, torch.int8, torch.int16)


def to_device(a, device, dtype=None, non_blocking: bool = False
              ) -> torch.Tensor:
    """A host array or tensor as a contiguous tensor on ``device`` in
    ``dtype`` (JAX ``core.to_device``): uint8 / int8 / int16 data moves
    at its own width and is cast on the device, everything else is
    cast first."""
    t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    if dtype is not None and t.dtype in NARROW_INTS:
        t = t.to(device=device, non_blocking=non_blocking)
    return t.to(device=device, dtype=dtype,
                non_blocking=non_blocking).contiguous()


_copy_streams = threading.local()


def place_tree(tree, device, dtype):
    """A tree (lists, tuples and None) of host arrays as tensors on
    ``device`` (``to_device`` each) and the event after their copies.
    On the card the arrays are staged in pinned memory and copied
    non-blocking on a CUDA stream of the calling thread's own (an input
    pipeline's worker overlaps the copies with the step on the compute
    stream); the consumer waits on the event (``PlacedDataSet.wait``).
    On the CPU the copies are done when this returns and the event is
    None."""
    tree = _map_tree_np(tree)
    device = torch.device(device)
    if device.type != "cuda":
        return _map_tree(lambda t: to_device(t, device, dtype), tree), None
    stream = getattr(_copy_streams, "stream", None)
    if stream is None or stream.device != device:
        stream = _copy_streams.stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        out = _map_tree(lambda t: to_device(
            t if t.is_cuda else t.pin_memory(), device, dtype,
            non_blocking=True), tree)
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def _map_tree_np(tree):
    """Numpy arrays of a tree of lists, tuples and None as tensors (the
    leaves ``_map_tree`` maps)."""
    if tree is None or torch.is_tensor(tree):
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree_np(e) for e in tree)
    return torch.from_numpy(np.ascontiguousarray(tree))


# --- whole-net transform: activation rematerialization ----------------------

REMAT_POLICIES = ("none", "dots_saveable", "full")


def check_remat_policy(policy: str) -> str:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    return policy


def maybe_remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` per the remat policy (JAX
    ``maybe_remat``): the backward recomputes ``fn``'s forward from its
    inputs instead of keeping its activations. ``"full"`` recomputes
    everything; ``"dots_saveable"`` in JAX keeps the matmul and conv
    outputs, but here those come from hand-written kernels that a
    selective-checkpoint policy (which sees ATen operators) cannot
    name, so it recomputes everything too, as ``"full"``. ``"none"`` is
    the identity. The forward's values are the same, and so are the
    gradients: the recompute runs the same operations on the same
    inputs."""
    if check_remat_policy(policy) == "none":
        return fn

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return remat


def reg_penalty(layer, layer_params, name: Optional[str] = None,
                tp: Optional[dict] = None):
    """L1/L2 penalty for one layer (reference calcL1/calcL2), each
    parameter's term the whole parameter's (``layer.whole_sum``; a shard
    of layer ``name`` under the model's tensor-parallel layout ``tp``:
    summed over the model ranks)."""
    from deeplearning4j_tpu_torch.parallel import tensor_parallel

    reg = 0.0
    if layer.l1 > 0.0 or layer.l2 > 0.0:
        for pn in layer.regularizable_params():
            if pn in layer_params:
                w = layer_params[pn]

                def whole(term):
                    term = layer.whole_sum(pn, w, term)
                    return tensor_parallel.penalty_term(tp, name, pn, term)
                if layer.l2 > 0.0:
                    reg = reg + whole(0.5 * layer.l2 * torch.sum(w * w))
                if layer.l1 > 0.0:
                    reg = reg + whole(layer.l1 * torch.sum(torch.abs(w)))
    return reg


def layer_rng(rng, i: int, layer, train: bool):
    """The key of layer (or vertex) ``i``: ``fold_in(rng, i)`` (JAX
    ``lrng``) where the layer draws a mask (training, a dropout rate),
    else None: a key is derived only where a mask is drawn."""
    if rng is None or not train or getattr(layer, "dropout", 0.0) <= 0.0:
        return None
    return random.fold_in(rng, i)


def draws_masks(model) -> bool:
    """True when a layer of ``model`` draws a dropout or drop-connect
    mask in training (its step then takes a key)."""
    return any(layer.dropout > 0.0 for layer in model.layer_confs())


def step_rng(model, iteration: int):
    """The step's key ``fold_in(PRNGKey(conf.seed), iteration)`` (JAX
    ``fold_in(self._base_key, self.iteration_count)``) in its host form,
    or None when no layer draws a mask."""
    if not draws_masks(model):
        return None
    return random.fold_in(random.host_key(model.conf.seed), iteration)


def sequential_forward(conf, layer_names: Sequence[str],
                       params: Dict[str, dict], state: Dict[str, dict],
                       x: torch.Tensor, *, train: bool = False,
                       rng=None, preout: bool = False,
                       fmask: Optional[torch.Tensor] = None,
                       remat: str = "none", collect: bool = False,
                       tp: Optional[dict] = None):
    """Forward through every layer of ``conf``; returns ``(y,
    new_state)``. ``y`` is the last layer's activation, or with
    ``preout`` its pre-activation when it carries a loss (what the
    score reads: the loss applies the activation in its stable form,
    on the input dropout and drop-connect mask of the layer's own
    ``apply``), or with ``collect`` the list of every layer's
    activation. ``rng`` is the step's key: layer ``i`` draws from
    ``fold_in(rng, i)`` (``layer_rng``). ``fmask`` is the [batch, time]
    features mask, handed to every layer (recurrent layers read it;
    reference ``setLayerMaskArrays``). With a ``compute_dtype`` the
    floating params, the input and the mask are cast to it first (mixed
    precision; gradients flow back through the cast to the stored
    params). ``remat`` (training only) recomputes each layer's forward
    in the backward instead of keeping its activations
    (``maybe_remat``; the recompute draws the same masks). ``tp`` is the
    model's tensor-parallel layout (``model._tp_layout``), None where
    nothing is sharded (``tensor_parallel.layer_params``)."""
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import ShapeContext
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        layer_params,
    )

    cdt = compute_dtype_of(conf)
    if cdt != dtype_of(conf):
        params = {ln: {pn: (t.to(cdt) if t.is_floating_point() else t)
                       for pn, t in lp.items()}
                  for ln, lp in params.items()}
        x = x.to(cdt)
        fmask = fmask.to(cdt) if fmask is not None else None
    ctx = ShapeContext(batch=int(x.shape[0]),
                       time=int(x.shape[2]) if x.dim() == 3 else -1)
    new_state = dict(state)
    acts = []
    n = len(conf.layers)
    i = 0
    while i < n:
        name, layer = layer_names[i], conf.layers[i]
        if i in conf.preprocessors:
            x = conf.preprocessors[i].preprocess(x, ctx)
        x = x.contiguous()
        if (not train and not collect and i + 1 < n
                and (i + 1) not in conf.preprocessors
                and getattr(layer, "kernel_size", None) is not None):
            # the inference peephole: Conv(identity) -> BN(act) as one
            # conv_block launch (None: the pair does not fold)
            from deeplearning4j_tpu_torch.nn.layers.convolution import (
                maybe_fused_conv_bn,
            )

            nxt = layer_names[i + 1]
            fused = maybe_fused_conv_bn(
                layer, conf.layers[i + 1],
                layer_params(tp, name, layer, params.get(name, {})),
                params.get(nxt, {}), state.get(nxt, {}), x)
            if fused is not None:
                x = fused
                i += 2
                continue
        lrng = layer_rng(rng, i, layer, train)
        lp = layer_params(tp, name, layer, params.get(name, {}))
        if preout and i == n - 1 and layer.has_loss():
            xin = layer.maybe_dropout(x, train=train, rng=lrng)
            pw = layer.maybe_drop_connect(lp, train=train, rng=lrng)
            return layer.pre_output(pw, xin), new_state
        apply_one = maybe_remat(functools.partial(
            layer.apply, train=train, rng=lrng, mask=fmask),
            remat if train and not layer.has_loss() else "none")
        x, new_state[name] = apply_one(lp, x, state.get(name, {}))
        if collect:
            acts.append(x)
        i += 1
    return (acts if collect else x), new_state


def sequential_score(conf, layer_names: Sequence[str],
                     params: Dict[str, dict], state: Dict[str, dict],
                     x: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     train: bool, rng=None,
                     fmask: Optional[torch.Tensor] = None,
                     weights=None, remat: str = "none",
                     tp: Optional[dict] = None):
    """Loss score plus the L1/L2 penalty (the reference's
    computeGradientAndScore adds calcL1/calcL2 to the loss); returns
    ``(score, new_state)``. ``mask`` is the labels mask; for 3-d labels
    without one the features mask ``fmask`` masks the loss (the
    reference's output-layer masking). ``weights`` = ``([loss weight],
    penalty weight)`` scales the two terms (a data-parallel rank's share
    of the global score); None: both 1. ``rng``: the step's key. ``tp``:
    the model's tensor-parallel layout (``sequential_forward``)."""
    from deeplearning4j_tpu_torch.nn import losses

    last = conf.layers[-1]
    if not last.has_loss():
        raise ValueError(
            "Last layer has no loss function; use an OutputLayer/LossLayer")
    preout, new_state = sequential_forward(
        conf, layer_names, params, state, x, train=train, rng=rng,
        preout=True, fmask=fmask, remat=remat, tp=tp)
    if mask is None and labels.dim() == 3:
        mask = fmask
    score = losses.score(last.loss, labels, preout, last.activation, mask,
                         True)
    reg = 0.0
    for lname, layer in zip(layer_names, conf.layers):
        reg = reg + reg_penalty(layer, params[lname], lname, tp)
    if weights is not None:
        (w_out,), w_reg = weights
        return score * w_out + reg * w_reg, new_state
    return score + reg, new_state


# --- dynamic loss scaling (compute_dtype="float16") --------------------------

DEFAULT_LOSS_SCALE = 2.0 ** 15
LOSS_SCALE_GROWTH_INTERVAL = 2000
MAX_LOSS_SCALE = 2.0 ** 24


def loss_scale_state(initial: float = DEFAULT_LOSS_SCALE,
                     device=None) -> dict:
    """The dynamic loss-scale state threaded through the step on the
    device: the current scale (f32), the clean steps since its last
    change and the overflows so far (int32); nothing reads it back on
    the host unless asked."""
    return {
        "scale": torch.tensor(float(initial), dtype=torch.float32,
                              device=device),
        "good_steps": torch.zeros((), dtype=torch.int32, device=device),
        "overflows": torch.zeros((), dtype=torch.int32, device=device),
    }


def _scale_tree(tree, factor):
    """Every floating tensor of ``{layer: {param: tensor}}`` times
    ``factor`` cast to its dtype."""
    return {ln: {pn: (g * factor.to(g.dtype) if g.is_floating_point()
                      else g) for pn, g in lp.items()}
            for ln, lp in tree.items()}


def grad_step(score_fn: Callable, params, state, x, labels, mask,
              fmask=None, scale=None, rng=None):
    """The forward and backward of one step: ``((score, new_state),
    grads)`` of ``score_fn(params, state, x, labels, mask, fmask, rng)``,
    with ``grads`` shaped like ``params``. The parameters are taken as
    fresh leaves, so the caller's tensors gain no graph. With ``scale``
    (dynamic loss scaling) the score is cast to f32 and scaled before
    the backward, so small f16 gradients stay representable; the score
    and gradients come back scaled, and ``finish_step`` unscales."""
    leaves = {ln: {pn: t.detach().requires_grad_(True)
                   for pn, t in lp.items()}
              for ln, lp in params.items()}
    with torch.enable_grad():
        score, new_state = score_fn(leaves, state, x, labels, mask, fmask,
                                    rng)
        if scale is not None:
            score = score.float() * scale
        flat = [t for lp in leaves.values() for t in lp.values()]
        got = torch.autograd.grad(score, flat, allow_unused=True)
    it = iter(got)
    grads = {}
    for ln, lp in leaves.items():
        grads[ln] = {}
        for pn, t in lp.items():
            g = next(it)
            grads[ln][pn] = torch.zeros_like(t) if g is None else g
    return (score.detach(), new_state), grads


class StepOut(NamedTuple):
    """One train step's outputs: the new trees and score, then the new
    loss-scale state, the new statistical-guard state, the guard's ok
    flag (a 0-d bool tensor on the device) and the gradient's global L2
    norm (step telemetry; f32 on the device), each None where that
    flavour is off."""
    params: dict
    upd_state: dict
    state: dict
    score: torch.Tensor
    loss_scale: Optional[dict] = None
    stat_guard: Optional[dict] = None
    ok: Optional[torch.Tensor] = None
    grad_norm: Optional[torch.Tensor] = None


def finish_step(updater, grads, score, new_state, params, upd_state,
                state, lrs: Dict[str, float], t: int, *,
                guarded: bool = False, ls=None, sg=None, sg_cfg=None,
                update: Optional[Callable] = None,
                telemetry: bool = False,
                norm_sq: Optional[Callable] = None) -> StepOut:
    """The post-gradient half shared by the engine steps and the
    distributed trainer's (JAX ``finish_step``): with ``ls`` (the
    incoming loss-scale state; the caller scaled the loss through
    ``grad_step``'s ``scale``) unscale the score and gradients, probe
    the gradients' finiteness, keep the old trees on an overflow,
    halve the scale on an overflow (at least 1) and double it after
    LOSS_SCALE_GROWTH_INTERVAL clean steps (at most MAX_LOSS_SCALE);
    then the updater rule (``update(grads) -> (params, upd_state)``, by
    default ``updater.update``), and with ``guarded`` the divergence
    guard's select, the statistical guard's too with ``sg`` / ``sg_cfg``
    (the incoming EWMA state and its ``StatGuardConfig``). Every branch
    is a select on the device: nothing is read back on the host. With
    ``telemetry`` the step also returns the (unscaled) gradients' global
    L2 norm, one more output of the same computation. ``norm_sq(grads)``
    replaces the squared global norm's sum (the distributed trainer's,
    over row-sharded tables)."""
    from deeplearning4j_tpu_torch.resilience.guard import (
        divergence_ok,
        grad_global_norm_sq,
        select_updates,
        stat_guard_update,
    )

    if update is None:
        def update(g):
            return updater.update(g, upd_state, params, lrs, t)
    new_ls = nsq = None
    if ls is not None:
        scale = ls["scale"]
        inv = 1.0 / scale
        grads = _scale_tree(grads, inv)
        score = score * inv
    if ls is not None or guarded or telemetry:
        # the squared global norm of the (unscaled) gradients, taken
        # once: the overflow probe, the divergence guard's, the
        # statistical guard's and the telemetry's gradient norm read it
        nsq = (norm_sq or grad_global_norm_sq)(grads)
    gnorm = torch.sqrt(nsq) if telemetry else None
    if ls is not None:
        # the overflow probe: a non-finite gradient skips the update and
        # halves the scale; LOSS_SCALE_GROWTH_INTERVAL clean steps double
        # it back
        finite = torch.isfinite(nsq)
        new_params, new_upd = update(grads)
        new_params, new_upd, new_state = select_updates(
            finite, new_params, params, new_upd, upd_state, new_state,
            state)
        good = torch.where(finite, ls["good_steps"] + 1,
                           torch.zeros_like(ls["good_steps"]))
        grow = good >= LOSS_SCALE_GROWTH_INTERVAL
        new_ls = {
            "scale": torch.where(
                finite,
                torch.where(grow, torch.clamp(scale * 2.0,
                                              max=MAX_LOSS_SCALE), scale),
                torch.clamp(scale * 0.5, min=1.0)),
            "good_steps": torch.where(grow, torch.zeros_like(good), good),
            "overflows": ls["overflows"] + (~finite).to(torch.int32),
        }
    else:
        new_params, new_upd = update(grads)
    if not guarded:
        return StepOut(new_params, new_upd, new_state, score, new_ls,
                       grad_norm=gnorm)
    ok = divergence_ok(score, norm_sq=nsq)
    new_sg = None
    if sg is not None:
        sg_ok, new_sg = stat_guard_update(sg, sg_cfg, score,
                                          torch.sqrt(nsq), ok)
        ok = torch.logical_and(ok, sg_ok)
    new_params, new_upd, new_state = select_updates(
        ok, new_params, params, new_upd, upd_state, new_state, state)
    return StepOut(new_params, new_upd, new_state, score, new_ls, new_sg, ok,
                   gnorm)


def build_pretrain_step(layer, name: str, upd_def) -> Callable:
    """One pretrainable layer's update (JAX ``build_pretrain_step``):
    ``step(lparams, upd_state, xin, lrs, t, rng) -> (new params, new
    updater state, loss)``, the loss ``layer.pretrain_loss`` plus the
    layer's L1/L2 penalty, its gradient by autograd, then the layer's
    updater rule (``upd_def``, keyed by ``name``). ``xin`` is the
    layer's input, computed once a batch by the engine (the frozen
    stack below runs once a batch, not once an iteration)."""

    def step(lparams, upd_state, xin, lrs, t, rng):
        leaves = {pn: p.detach().requires_grad_(True)
                  for pn, p in lparams.items()}
        with torch.enable_grad():
            loss = layer.pretrain_loss(leaves, xin, rng) + reg_penalty(
                layer, leaves)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
        grads = {pn: torch.zeros_like(t) if g is None else g
                 for (pn, t), g in zip(leaves.items(), got)}
        new_p, new_upd = upd_def.update({name: grads}, upd_state,
                                        {name: lparams}, lrs, t)
        return new_p[name], new_upd, loss.detach()

    return step


def pretrain_layer(model, name: str, layer, layer_key, data, epochs: int,
                   layer_input: Callable) -> None:
    """Both engines' greedy pretraining of one layer (JAX ``pretrain``'s
    inner loop): a fresh updater state of the layer's own settings, then
    for each epoch and batch its input ``layer_input(ds)`` (the frozen
    stack below, once a batch) and ``conf.iterations`` updates, update
    ``it`` (counted from 0, as the learning-rate schedule) drawing from
    ``fold_in(layer_key, it)``; ``data`` is reset after each epoch where
    it can be."""
    from deeplearning4j_tpu_torch.nn.updaters import MultiLayerUpdaterDef

    upd_def = MultiLayerUpdaterDef({name: layer.updater_settings()})
    upd_state = upd_def.init({name: model.params[name]})
    step = build_pretrain_step(layer, name, upd_def)
    it = 0
    for _ in range(epochs):
        for ds in iter_unchunked(data):
            xin = layer_input(ds)
            for _ in range(model.conf.iterations):
                model.params[name], upd_state, loss = step(
                    model.params[name], upd_state, xin,
                    upd_def.scheduled_lrs(it), it + 1,
                    random.fold_in(layer_key, it))
                model._last_score = loss
                it += 1
        if hasattr(data, "reset"):
            data.reset()


def iter_unchunked(data):
    """The minibatches of ``data``, a ``ChunkedDataSet`` among them
    unstacked (JAX ``core.iter_unchunked``)."""
    from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet

    for d in data:
        if isinstance(d, ChunkedDataSet):
            yield from d.to_datasets()
        else:
            yield d


def pretrain_batches(data):
    """What an engine's ``pretrain`` iterates once a layer and an epoch:
    a list for one DataSet, a ``ChunkedDataSet`` or a one-shot
    generator (each layer needs its own pass), else ``data`` itself (a
    list, or an iterator with ``reset()``)."""
    from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet

    if isinstance(data, ChunkedDataSet):
        return data.to_datasets()
    if hasattr(data, "features"):
        return [data]
    if not isinstance(data, (list, tuple)) and not hasattr(data, "reset"):
        return list(data)
    return data


def check_sgd_step(model, who: str, pretrain: bool = True) -> None:
    """Refuse, naming what to use instead, a configuration whose training
    is not the SGD-family step that ``who`` runs: a line-search solver
    (it runs through the engines' ``fit_minibatch``), and with
    ``pretrain`` layer-wise pretraining (the engines' ``fit`` /
    ``pretrain``)."""
    conf = model.conf
    if conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT":
        raise ValueError(
            f"{who} runs the SGD-family step; the {conf.optimization_algo} "
            "solver runs on one device through the model's own fit / "
            "fit_minibatch (a solver here is deferred: ROADMAP)")
    if pretrain and conf.pretrain:
        raise ValueError(
            f"{who} runs no layer-wise pretraining; pretrain on one "
            "device with the model's own fit / pretrain first, then "
            "train a backprop=True configuration here (deferred: "
            "ROADMAP)")


def split_rows(tree, k: int) -> list:
    """``k`` contiguous row blocks of every tensor in ``tree`` (a
    tensor, a list of tensors or Nones, or None): block j holds rows
    ``[j*n/k, (j+1)*n/k)``."""
    if tree is None:
        return [None] * k
    if isinstance(tree, (list, tuple)):
        parts = [split_rows(t, k) for t in tree]
        return [[p[j] for p in parts] for j in range(k)]
    n = int(tree.shape[0])
    m = n // k
    return [tree[j * m:(j + 1) * m] for j in range(k)]


def accum_grad_step(micro_grads: Callable, k: int, state,
                    recurrent_names: Sequence[str] = ()):
    """Gradient accumulation (JAX ``core.accum_grad_step``): ``k``
    microbatches, ``micro_grads(j, state) -> ((score, new_state),
    grads)`` for microbatch j, their gradients and scores summed in f32
    and averaged. The layer state threads from microbatch to microbatch;
    recurrent carries are restored to the incoming ones after each.
    Returns ``((score, last_state), grads)``, the contract of
    ``grad_step``."""
    acc = ssum = None
    st = state
    for j in range(k):
        (score, new_st), grads = micro_grads(j, st)
        new_st = dict(new_st)
        for name in recurrent_names:
            if name in new_st:
                new_st[name] = st.get(name, {})
        st = new_st
        f32 = {ln: {pn: g.float() for pn, g in lg.items()}
               for ln, lg in grads.items()}
        if acc is None:
            acc, ssum = f32, score.float()
        else:
            acc = {ln: {pn: acc[ln][pn] + g for pn, g in lg.items()}
                   for ln, lg in f32.items()}
            ssum = ssum + score.float()
    inv = 1.0 / k
    out = {ln: {pn: (a * inv).to(grads[ln][pn].dtype)
                for pn, a in la.items()} for ln, la in acc.items()}
    return (ssum * inv, st), out


def check_grad_accum(layers, k) -> int:
    """A positive microbatch count, and no batch-statistics layer when
    it is above 1 (each microbatch would compute its own
    BatchNormalization statistics: other math than the whole batch's);
    JAX ``core.check_grad_accum``."""
    k = int(k)
    if k < 1:
        raise ValueError(f"grad_accum must be >= 1, got {k}")
    if k > 1 and any(layer.uses_batch_statistics() for layer in layers):
        raise ValueError(
            "grad_accum > 1 is incompatible with batch-statistics "
            "layers (BatchNormalization): each microbatch would "
            "compute its own batch stats, changing the math vs the "
            "single-big-batch step")
    return k


def set_grad_accum(model, k) -> None:
    """Each optimizer step of ``model`` (either engine) accumulates ``k``
    contiguous microbatches' gradients (JAX ``core.set_grad_accum``);
    persists until changed, and a change drops the cached step."""
    if int(k) > 1 and model.conf.backprop_type == "TruncatedBPTT":
        raise ValueError(
            "grad_accum > 1 is incompatible with TBPTT: the recurrent "
            "carry threads between chunks, so a chunk cannot split into "
            "independent microbatches")
    k = check_grad_accum(model.layer_confs(), k)
    if k != model.grad_accum:
        model.grad_accum = k
        model._step = None
        model._multi_step = None


def check_grad_accum_batch(k: int, batch_n: int) -> None:
    if k > 1 and batch_n % k != 0:
        raise ValueError(
            f"grad_accum={k} needs the batch to split into equal "
            f"microbatches; got batch size {batch_n}")


def build_step(score_fn: Callable, updater, grad_accum: int = 1,
               recurrent_names: Sequence[str] = (), *,
               guarded: bool = False, loss_scale: bool = False,
               stat_guard=None, telemetry: bool = False) -> Callable:
    """One eager SGD-family train step: ``step(params, upd_state, state,
    x, labels, mask, lrs, t, fmask=None, ls=None, sg=None, rng=None) ->
    StepOut``. ``lrs`` and ``t`` are host numbers (the per-step loop) or
    0-d device tensors holding the same values (a megastep chunk);
    ``rng`` is the step's key (``step_rng``). With ``grad_accum`` = K >
    1 the batch runs as K contiguous microbatches (``accum_grad_step``;
    microbatch j draws from ``fold_in(rng, j)``, as in JAX) before the
    one update. With ``loss_scale`` the step takes the loss-scale state
    ``ls``, scales the loss by it, and skips the update on a non-finite
    gradient; with ``guarded`` it returns the divergence guard's ok
    flag, and with ``stat_guard`` (a ``StatGuardConfig``; needs
    ``guarded``) it takes and returns the statistical guard's EWMA state
    ``sg``; with ``telemetry`` it returns the gradients' global norm
    (``StepOut.grad_norm``)."""
    if stat_guard is not None and not guarded:
        raise ValueError("stat_guard requires guarded=True (it shares the "
                         "divergence guard's select and ok flag)")

    def step(params, upd_state, state, x, labels, mask, lrs, t, fmask=None,
             ls=None, sg=None, rng=None):
        if loss_scale and ls is None:
            raise ValueError("a loss-scaled step needs its loss-scale state")
        if stat_guard is not None and sg is None:
            raise ValueError("a stat-guarded step needs its EWMA state")
        scale = ls["scale"] if loss_scale else None
        if grad_accum > 1:
            micro = list(zip(*(split_rows(a, grad_accum)
                               for a in (x, labels, mask, fmask))))

            def micro_grads(j, st):
                return grad_step(score_fn, params, st, *micro[j][:3],
                                 micro[j][3], scale=scale,
                                 rng=None if rng is None
                                 else random.fold_in(rng, j))

            (score, new_state), grads = accum_grad_step(
                micro_grads, grad_accum, state, recurrent_names)
        else:
            (score, new_state), grads = grad_step(score_fn, params, state,
                                                  x, labels, mask, fmask,
                                                  scale=scale, rng=rng)
        return finish_step(updater, grads, score, new_state, params,
                           upd_state, state, lrs, t, guarded=guarded,
                           ls=ls if loss_scale else None,
                           sg=sg if stat_guard is not None else None,
                           sg_cfg=stat_guard, telemetry=telemetry)

    return step


# --- the model's transform knobs and step flavours -------------------------


def init_transforms(model) -> None:
    """The whole-net transform knobs from the configuration's hints (JAX
    ``core.init_transforms``): ``scan_layers``, ``remat``, ``loss_scale``
    (True: DEFAULT_LOSS_SCALE), ``megastep`` 1, and no loss-scale or EWMA
    state and no captured chunk yet; and the runtime's: no listeners,
    no batch validator, the dispatch window's defaults, ``scan_chunk``
    16 and ``device_cache_bytes`` from ``util/device.py``, step
    telemetry off. Called from both engines' constructors."""
    conf = model.conf
    model.scan_layers = bool(getattr(conf, "scan_layers", False))
    model.remat = check_remat_policy(getattr(conf, "remat", None) or "none")
    ls = getattr(conf, "loss_scale", None)
    model.loss_scale = DEFAULT_LOSS_SCALE if ls is True else (ls or None)
    model.megastep = 1
    model._megastep_graphs = {}
    model._loss_scale_state = None
    model._stat_guard_state = None
    model.divergence_guard = None
    # the runtime around the step: listeners, the batch validator and
    # its quarantine, and the dispatch window's knobs (at most
    # max_in_flight steps enqueued; the guard's flags read guard_lag
    # steps late, None: max_in_flight)
    model.listeners = []
    model._batch_validator = None
    model._quarantine_store = None
    model.max_in_flight = 2
    model.guard_lag = None
    model._dispatch_window = None
    # the scan path (JAX ``scan_chunk``): minibatches a chunk, and the
    # bytes of a list that a multi-epoch fit keeps on the device
    from deeplearning4j_tpu_torch.util.device import (
        device_cache_budget_bytes,
    )

    model.scan_chunk = 16
    model.device_cache_bytes = device_cache_budget_bytes(model.device)
    model._multi_step = None
    model._tbptt_multi_step = None
    # step telemetry (``enable_step_telemetry``): the step also returns
    # the gradient's global norm, kept on the device
    model._telemetry_grad_norm = False
    model._last_grad_norm = None


def set_transforms(model, scan_layers=None, remat=None, loss_scale=None,
                   megastep=None) -> None:
    """Runtime (re)configuration of the whole-net transforms on either
    engine (JAX ``core.set_transforms``); None leaves a knob unchanged.
    ``scan_layers`` changes only the JAX package's compiled program
    (its layers under one ``lax.scan``); the port's eager layer loop is
    the same with it on or off. ``remat`` (``none | dots_saveable |
    full``) recomputes activations in the backward (``maybe_remat``).
    ``loss_scale`` arms dynamic loss scaling for f16 compute (True:
    DEFAULT_LOSS_SCALE; a number: the initial scale; 0 / False: off); a
    change drops the scale state. ``megastep=K`` runs K optimizer steps
    a chunk with one readback (``fit_epoch_megastep``; 1: per step). No
    transform changes the trajectory."""
    if megastep is not None:
        if int(megastep) < 1:
            raise ValueError(f"megastep must be >= 1, got {megastep}")
        model.megastep = int(megastep)
    if scan_layers is not None:
        model.scan_layers = bool(scan_layers)
    if remat is not None:
        model.remat = check_remat_policy(remat)
    if loss_scale is not None:
        ls = DEFAULT_LOSS_SCALE if loss_scale is True else (
            loss_scale or None)
        if ls != model.loss_scale:
            model.loss_scale = ls
            model._loss_scale_state = None
            model._step = None


def loss_scale_active(model) -> bool:
    """Dynamic loss scaling engages only for f16 compute: bf16 has f32's
    exponent range and needs none of it."""
    return (model.loss_scale is not None
            and compute_dtype_of(model.conf) == torch.float16)


def ensure_loss_scale_state(model) -> dict:
    if model._loss_scale_state is None:
        model._loss_scale_state = loss_scale_state(model.loss_scale,
                                                   model.device)
    return model._loss_scale_state


def stat_guard_config(model):
    """The ``StatGuardConfig`` of the model's installed guard, or
    None."""
    guard = getattr(model, "divergence_guard", None)
    return getattr(guard, "stats", None) if guard is not None else None


def ensure_stat_guard_state(model) -> dict:
    from deeplearning4j_tpu_torch.resilience.guard import stat_guard_state

    if model._stat_guard_state is None:
        model._stat_guard_state = stat_guard_state(model.device)
    return model._stat_guard_state


def set_divergence_guard(model, guard) -> None:
    """(Un)install a ``DivergenceGuard`` on an engine's step; the step
    is rebuilt (the guarded step returns its ok flag)."""
    model.divergence_guard = guard
    model._step = None


def enable_step_telemetry(model, enabled: bool = True) -> None:
    """(Un)install step telemetry on either engine (JAX
    ``enable_step_telemetry``): the step also returns the gradient's
    global L2 norm, one more output computed on the device (no second
    pass, no readback until something reads ``_last_grad_norm``). A
    change drops the cached steps; ``TelemetryListener`` turns it on."""
    if bool(enabled) != model._telemetry_grad_norm:
        model._telemetry_grad_norm = bool(enabled)
        model._step = None


def model_step(model, score_fn: Callable) -> Callable:
    """The engine's cached step with its flavours: the guard and the
    statistical guard as installed, loss scaling where it is active,
    the telemetry norm where it is on."""
    if model._step is None:
        guard = model.divergence_guard
        model._step = build_step(
            score_fn, model.updater_def, model.grad_accum,
            model.recurrent_names(), guarded=guard is not None,
            loss_scale=loss_scale_active(model),
            stat_guard=stat_guard_config(model),
            telemetry=model._telemetry_grad_norm)
    return model._step


def run_step(model, step, x, labels, mask, fmask):
    """One optimizer step of ``model`` (either engine) through ``step``:
    the scheduled learning rates, Adam's ``t``, the step's key, the
    loss-scale and EWMA state in, the new trees, states and score out
    onto the model; then the guard's host policy (through the fit
    loop's dispatch window where one is open: the flag read
    ``guard_lag`` steps late, else at once) and the listeners. Returns
    the score, a 0-d tensor on the device."""
    lrs = model.updater_def.scheduled_lrs(model.iteration_count)
    out = step(model.params, model.updater_state, model.state, x, labels,
               mask, lrs, model.iteration_count + 1, fmask,
               ls=(ensure_loss_scale_state(model)
                   if loss_scale_active(model) else None),
               sg=(ensure_stat_guard_state(model)
                   if stat_guard_config(model) is not None else None),
               rng=step_rng(model, model.iteration_count))
    apply_step_out(model, out)
    model.iteration_count += 1
    model._last_score = out.score
    after_step(model, model.divergence_guard, out.ok, model._dispatch_window)
    return out.score


def after_step(model, guard, ok, window) -> None:
    """The host side of one step: its completion event and ok flag into
    the fit loop's dispatch window, or with none open the guard's policy
    at once; then every listener's ``iteration_done`` (timed into the
    active profiler's step)."""
    from deeplearning4j_tpu_torch.parallel.dispatch import step_done_event

    if window is not None:
        window.push(step_done_event(model.device), ok)
    elif guard is not None:
        guard.consult(model, ok)
    if model.listeners:
        from deeplearning4j_tpu_torch.observability import profiler

        t0 = time.perf_counter()
        for listener in model.listeners:
            listener.iteration_done(model, model.iteration_count)
        prof = profiler.get_active_profiler()
        if prof is not None:
            prof.note_listener_ms((time.perf_counter() - t0) * 1e3)


def apply_step_out(model, out: StepOut) -> None:
    """The step's trees and flavour states onto the model (the telemetry
    norm into ``_last_grad_norm``, a device scalar)."""
    model.params, model.updater_state, model.state = out[:3]
    if out.loss_scale is not None:
        model._loss_scale_state = out.loss_scale
    if out.stat_guard is not None:
        model._stat_guard_state = out.stat_guard
    if out.grad_norm is not None:
        model._last_grad_norm = out.grad_norm


# --- megastep: K optimizer steps a chunk, one readback ----------------------
#
# JAX's megastep (``build_megastep``) runs K full train steps as one XLA
# dispatch and reads the chunk's metrics back once. Its counterpart here
# is ``chunk_steps``: K steps of the model's own step, with the learning
# rates, the step count and the keys read from tensors (an ``lr_table``,
# ``it0`` and the base key), so that the same function runs eagerly on
# the CPU and, on the card, is captured once per signature in a CUDA
# graph (``GraphedChunk``) and replayed a chunk. A step's values do not
# depend on whether its constants came from the host or from a tensor
# (the keys are integer arithmetic, ``t`` an exact integer, each
# learning rate one f32 multiply), so a chunk is bitwise the per-step
# loop on the same device.


def megastep_active(model) -> bool:
    """True when the ``megastep`` knob asks for K > 1 steps a chunk."""
    return int(getattr(model, "megastep", 1) or 1) > 1


def can_megastep(model) -> bool:
    """Megastep eligibility (JAX ``can_megastep``). A chunk runs the full
    step flavour: the divergence and statistical guards, loss scaling,
    gradient accumulation and dropout. Refused, and run per step as in
    JAX: truncated BPTT (its carry crosses chunks on the host), several
    iterations a minibatch, non-SGD solvers, recurrent models, a
    rollback guard (its restore would interrupt a chunk) and row-sharded
    embeddings."""
    from deeplearning4j_tpu_torch.resilience.guard import ROLLBACK

    if not megastep_active(model):
        return False
    conf = model.conf
    guard = model.divergence_guard
    return (conf.iterations == 1 and conf.backprop
            and conf.backprop_type != "TruncatedBPTT"
            and conf.optimization_algo == "STOCHASTIC_GRADIENT_DESCENT"
            and not model.recurrent_names()
            and (guard is None or guard.policy != ROLLBACK)
            and not has_row_sharded_embedding(model))


def named_layer_confs(model) -> list:
    """``(name, layer spec)`` of every layer of either engine: the
    sequential list's, or the layer-bearing vertices of a graph."""
    if hasattr(model.conf, "vertices"):
        return list(zip(model.layer_vertex_names, model.layer_confs()))
    return list(zip(model.layer_names, model.conf.layers))


def has_row_sharded_embedding(model) -> bool:
    """True when either engine's config carries a
    ``SparseEmbeddingLayer`` with ``row_sharded=True`` (JAX
    ``has_row_sharded_embedding``): the marker the gates key on.
    ``DistributedTrainer`` shards that layer's ``W`` rows over its ranks,
    megastep refuses the model, and the step kind carries ``+semb``."""
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        SparseEmbeddingLayer,
    )

    return any(isinstance(lc, SparseEmbeddingLayer)
               and getattr(lc, "row_sharded", False)
               for lc in model.layer_confs())


class Chunk(NamedTuple):
    """K minibatches stacked on a new leading axis (JAX ``_stack_chunk``):
    features, labels, labels masks and features masks (tensors for
    ``MultiLayerNetwork``, lists of tensors for ``ComputationGraph``;
    masks may be None), the step count and the rows of a minibatch;
    ``weights``: a [k, w] f32 table handed to step i as ``weights=``
    row i (the distributed trainer's loss weights), or None;
    ``resets``: a [k] f32 vector handed to step i as ``reset=`` (the
    fused truncated-BPTT scan: 1 where a minibatch's first segment
    zeroes the recurrent carry), or None."""
    xs: object
    ys: object
    lmasks: object
    fmasks: object
    k: int
    rows: int
    weights: object = None
    resets: object = None

    @property
    def fields(self) -> tuple:
        return (self.xs, self.ys, self.lmasks, self.fmasks, self.weights,
                self.resets)


def stack_fields(arrays, dtype) -> torch.Tensor:
    """``k`` same-shaped minibatch arrays (numpy or tensors) stacked into
    one tensor, where they lie (host arrays on the host). uint8 / int8 /
    int16 keep their width and are cast on the device, as in
    ``to_device``; everything else is cast to ``dtype`` first."""
    if all(torch.is_tensor(a) for a in arrays):
        t = torch.stack(list(arrays))
    else:
        t = torch.from_numpy(np.stack([np.asarray(a) for a in arrays]))
    return t if t.dtype in NARROW_INTS else t.to(dtype)


def _map_tree(fn, tree):
    """``fn`` over the tensors of a tree of dicts, lists and tuples (None
    stays None), into a tree of the same structure."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return type(tree)(_map_tree(fn, e) for e in tree)


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    out = []
    _map_tree(out.append, tree)
    return out


def _fresh_dicts(tree):
    """``tree`` with new dicts at every level and the same tensors: what
    the model holds of a captured chunk's static trees, so that a later
    edit of the model's dictionaries never drops a tensor the graph
    writes."""
    if isinstance(tree, dict):
        return {k: _fresh_dicts(v) for k, v in tree.items()}
    return tree


def nbytes(a) -> int:
    """Bytes of a host array or tensor (None: 0)."""
    if a is None:
        return 0
    if torch.is_tensor(a):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def chunk_steps(model, step, trees, fields, lr_names, lr_stack, it0,
                base_key, steps: int):
    """``steps`` train steps of ``model`` through ``step`` (the engine's
    cached step, any flavour, its bare scan step, or the distributed
    trainer's): step i takes slot i of ``fields`` (features, labels,
    labels masks, features masks, narrow integers cast here; a weights
    table, row i handed on as ``weights=``, and a resets vector, entry
    i handed on as ``reset=``, where they are not None), the learning
    rates of row i of ``lr_stack`` (keys ``lr_names``,
    ``MultiLayerUpdaterDef.lr_table``), ``t = it0 + 1 + i`` and the key
    ``fold_in(base_key, it0 + i)`` (``it0`` a 0-d int64 tensor,
    ``base_key`` ``random.key(conf.seed)``). ``trees`` = (params,
    updater state, layer state, loss-scale state or None, EWMA state or
    None). Returns the new trees and the metrics vector ``[scores (k),
    their f32 sum, with the guard its ok flags (k) and trips, with
    telemetry the gradient norms (k)]``. Nothing is read back: a CUDA
    graph captures this function whole."""
    params, upd_state, state, ls, sg = trees
    dtype = dtype_of(model.conf)
    draws = draws_masks(model)

    def slot(tree, i):
        return _map_tree(lambda a: a[i].to(dtype) if a.dtype in NARROW_INTS
                           else a[i], tree)

    weights = fields[4] if len(fields) > 4 else None
    resets = fields[5] if len(fields) > 5 else None
    scores, oks, norms = [], [], []
    for i in range(steps):
        it = it0 + i
        extra = {} if weights is None else {"weights": weights[i]}
        if resets is not None:
            extra["reset"] = resets[i]
        out = step(params, upd_state, state, *(slot(f, i) for f in fields[:3]),
                   {n: lr_stack[i, j] for j, n in enumerate(lr_names)},
                   (it + 1).to(torch.float32), slot(fields[3], i), ls=ls,
                   sg=sg, rng=random.fold_in(base_key, it) if draws else None,
                   **extra)
        params, upd_state, state = out[:3]
        ls = ls if out.loss_scale is None else out.loss_scale
        sg = sg if out.stat_guard is None else out.stat_guard
        scores.append(out.score.float().reshape(()))
        if out.ok is not None:
            oks.append(out.ok.reshape(()))
        if out.grad_norm is not None:
            norms.append(out.grad_norm.float().reshape(()))
    sc = torch.stack(scores)
    parts = [sc, sc.sum().reshape(1)]
    if oks:
        ok = torch.stack(oks).float()
        parts += [ok, (steps - ok.sum()).reshape(1)]
    if norms:
        parts.append(torch.stack(norms))
    return (params, upd_state, state, ls, sg), torch.cat(parts)


def _tree_pairs(dst, src):
    """The (static, new) tensor pairs of two trees of the same structure
    (nested dicts and tuples of tensors, or None), matched by key."""
    if dst is None:
        return
    if torch.is_tensor(dst):
        yield dst, src
    elif isinstance(dst, dict):
        for k in dst:
            yield from _tree_pairs(dst[k], src[k])
    else:
        for d, t in zip(dst, src, strict=True):
            yield from _tree_pairs(d, t)


def _copy_into(dst, src) -> None:
    """Each tensor of ``src`` into its static counterpart in ``dst``
    (none where they are the same tensor)."""
    for d, t in _tree_pairs(dst, src):
        if d is not t:
            d.copy_(t)


class GraphedChunk:
    """One signature's chunk captured in a CUDA graph: the static trees
    it reads at its start and ``copy_``-s its results into at its end,
    the static input buffers (minibatches, the learning-rate table,
    ``it0``) filled by non-blocking copies before each replay (JAX's
    ``scan_consts`` stage the same values; a device-cached chunk's
    minibatches are copied on the card), the pinned host staging of
    those copies, and the graph (``replays`` counts its replays). The
    capture follows one eager warm-up step on a side stream (whose
    results are dropped): it loads the built kernel libraries and
    caches the conv kernels' tap tables. A capture that fails raises;
    nothing falls back to the eager chunk.
    ``hint`` names the knob that runs the path per step."""

    def __init__(self, model, step, chunk: Chunk, lr_names, trees,
                 hint: str = "megastep=1"):
        dev = model.device
        self.step = step
        self.k = chunk.k
        self.hint = hint
        self.lr_names = list(lr_names)
        self.trees = _map_tree(lambda t: t.detach().clone(), trees)
        fields = chunk.fields
        self.inputs = _map_tree(
            lambda a: torch.empty(a.shape, dtype=a.dtype, device=dev), fields)
        # a pinned staging buffer for each host leaf of the fields
        self.staging = [None if a.is_cuda else
                        torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                        for a in _leaves(fields)]
        self.lr = torch.empty((self.k, len(self.lr_names)),
                              dtype=torch.float32, device=dev)
        self.lr_host = torch.empty(self.lr.shape, dtype=torch.float32,
                                   pin_memory=True)
        self.lr_rows = None  # the table last staged
        self.it0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.key = random.key(model.conf.seed, dev)
        self.graph = torch.cuda.CUDAGraph()
        self.metrics = None
        self.staged = None
        self.replays = 0

    def _body(self, model, steps: int):
        return chunk_steps(model, self.step, self.trees, self.inputs,
                           self.lr_names, self.lr, self.it0, self.key, steps)

    def fill(self, chunk: Chunk, lr_rows: np.ndarray, it0: int) -> None:
        """This chunk's minibatches, learning rates and ``it0`` into the
        static buffers, on the stream after the previous replay: a
        minibatch already on the card (a device-cached chunk) by a
        device copy, a host one through its pinned staging. As JAX's
        ``scan_consts`` / ``note_it0`` keep a constant schedule and the
        step count on the device, the learning-rate table is staged only
        when it changed and ``it0`` is written on the device, so a
        device-cached chunk under a constant schedule stages nothing on
        the host. Pinned staging is rewritten only once the previous
        fill's copies from it are done (``staged``)."""
        fields = chunk.fields
        pairs = list(zip(_leaves(fields), self.staging, _leaves(self.inputs),
                         strict=True))
        lr_changed = self.lr_rows is None or not np.array_equal(
            lr_rows, self.lr_rows)
        staging = lr_changed or any(h is not None and not a.is_cuda
                                    for a, h, _ in pairs)
        if staging and self.staged is not None:
            self.staged.synchronize()
        for a, h, d in pairs:
            if h is None or a.is_cuda:
                d.copy_(a, non_blocking=True)
            else:
                h.copy_(a)
                d.copy_(h, non_blocking=True)
        if lr_changed:
            self.lr_host.copy_(torch.from_numpy(lr_rows))
            self.lr.copy_(self.lr_host, non_blocking=True)
            self.lr_rows = np.array(lr_rows, copy=True)
        self.it0.fill_(int(it0))
        if staging:
            self.staged = torch.cuda.Event()
            self.staged.record()

    def capture(self, model) -> None:
        dev = model.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body(model, 1)
        torch.cuda.current_stream(dev).wait_stream(side)
        # a model and its captured chunks form a reference cycle (the
        # chunk's step closes over the model), so a dropped model's graphs
        # are freed by the cyclic collector: never inside a capture, where
        # destroying a graph is not permitted and breaks the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread-local capture: another thread's CUDA calls (an input
            # pipeline's copies, the process group's watchdog) do not
            # invalidate it
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                new_trees, self.metrics = self._body(model, self.k)
                _copy_into(self.trees, new_trees)
        except Exception as e:
            self.graph = torch.cuda.CUDAGraph()  # the next chunk recaptures
            raise RuntimeError(
                f"capturing the {self.k}-step chunk in a CUDA graph failed "
                f"({type(e).__name__}: {e}); a step that reads the device "
                f"back on the host cannot be captured: run it with "
                f"{self.hint}") from e
        finally:
            if collecting:
                gc.enable()

    def replay(self, trees):
        """One replay from ``trees`` (the model's; leaves that are not
        already the static ones are copied in first); returns the static
        trees, now holding the chunk's results, and its metrics."""
        _copy_into(self.trees, trees)
        self.graph.replay()
        self.replays += 1
        return self.trees, self.metrics


def _graphed_chunk(model, step, chunk: Chunk, lr_names, trees,
                   hint: str) -> GraphedChunk:
    """The model's captured chunk for this signature (the step count,
    the minibatches' shapes and dtypes, the learning-rate keys, the
    remat policy and the step flavour: the engine's cached step or its
    scan step), made and captured on its first use."""
    fields = chunk.fields
    sig = (chunk.k, tuple(str(f) if f is None else
                          tuple((tuple(a.shape), a.dtype)
                                for a in _leaves(f)) for f in fields),
           tuple(lr_names), model.remat)
    g = model._megastep_graphs.get(sig)
    if g is None or g.step is not step:
        g = model._megastep_graphs[sig] = GraphedChunk(
            model, step, chunk, lr_names, trees, hint)
    return g


class Launched(NamedTuple):
    """A chunk launched: its metrics vector (with a readback on the
    card a pinned host copy in flight, ``done`` recorded after it;
    without one a tensor on the device), its step count and rows, and
    its first iteration."""
    metrics: torch.Tensor
    done: Optional[object]
    k: int
    rows: int
    it0: int


def megastep_readback(chunk: Launched, guarded: bool) -> dict:
    """The megastep path's one host readback a chunk (JAX
    ``megastep_readback``), its one wait for the card: the metrics
    vector of ``chunk_steps`` to ``scores`` [k], ``loss_sum`` and, with
    the guard, ``oks`` [k] and ``guard_trips``; with step telemetry
    ``grad_norms`` [k]."""
    if chunk.done is not None:
        chunk.done.synchronize()
    host, k = chunk.metrics.numpy(), chunk.k
    out = {"scores": host[:k], "loss_sum": float(host[k])}
    at = k + 1
    if guarded:
        out["oks"] = host[k + 1:2 * k + 1] > 0.5
        out["guard_trips"] = int(host[2 * k + 1])
        at = 2 * k + 2
    if host.shape[0] >= at + k:
        out["grad_norms"] = host[at:at + k]
    return out


def launch_chunk(model, chunk: Chunk, step, *, state=None,
                 stat_guard: Optional[bool] = None, readback: bool = True,
                 hint: str = "megastep=1") -> Launched:
    """One K-step chunk of ``model`` (either engine) through ``step``:
    eagerly on the CPU; on the card the chunk's minibatches staged and
    one replay of its CUDA graph (captured at the signature's first
    chunk), with ``readback`` the metrics copied to the host behind it,
    without one a device copy of them (no wait at all). The model holds
    the chunk's trees and iteration count at once (on the card, tensors
    the replay is still writing: the stream orders every later use
    after it). ``state``: the layer state the chunk starts from
    (default the model's; the fused TBPTT scan primes its carries).
    ``stat_guard``: whether the step threads the EWMA state (default:
    the engine's guard has a ``StatGuardConfig``)."""
    check_sgd_step(model, "a chunk of steps", pretrain=False)
    it0 = model.iteration_count
    lr_names, lr_rows = model.updater_def.lr_table(it0, chunk.k)
    trees = (model.params, model.updater_state,
             model.state if state is None else state,
             ensure_loss_scale_state(model) if loss_scale_active(model)
             else None,
             ensure_stat_guard_state(model)
             if (stat_guard_config(model) is not None if stat_guard is None
                 else stat_guard) else None)
    done = None
    if model.device.type == "cuda":
        g = _graphed_chunk(model, step, chunk, lr_names, trees, hint)
        g.fill(chunk, lr_rows, it0)
        if g.metrics is None:
            g.capture(model)
        new_trees, metrics = g.replay(trees)
        new_trees = tuple(_fresh_dicts(t) for t in new_trees)
        if readback:
            host = torch.empty(metrics.shape, dtype=metrics.dtype,
                               pin_memory=True)
            host.copy_(metrics, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            # the next replay rewrites the static metrics
            host = metrics.clone()
    else:
        fields = tuple(_map_tree(lambda a: a.to(model.device), f)
                       for f in chunk.fields)
        new_trees, host = chunk_steps(
            model, step, trees, fields, lr_names,
            torch.from_numpy(lr_rows), torch.tensor(it0),
            random.key(model.conf.seed), chunk.k)
    model.params, model.updater_state, model.state = new_trees[:3]
    if new_trees[3] is not None:
        model._loss_scale_state = new_trees[3]
    if new_trees[4] is not None:
        model._stat_guard_state = new_trees[4]
    model.iteration_count += chunk.k
    model._last_batch_rows = chunk.rows
    return Launched(host, done, chunk.k, chunk.rows, it0)


def launch_megastep_chunk(model, chunk: Chunk, step=None,
                          stat_guard: Optional[bool] = None) -> Launched:
    """One K-step megastep chunk of ``model`` (either engine; JAX
    ``run_megastep_chunk``'s dispatch) through ``step`` (default the
    engine's cached step; the distributed trainer passes its own), its
    metrics read back behind it (``launch_chunk``). The active
    profiler's record of the chunk starts here."""
    from deeplearning4j_tpu_torch.observability import profiler

    if step is None:
        canonicalize_updater_state(model)
        check_grad_accum_batch(model.grad_accum, chunk.rows)
        step = model._train_step()
    prof = profiler.get_active_profiler()
    if prof is not None:
        prof.begin_step(model.iteration_count + chunk.k,
                        device=model.device)
    return launch_chunk(model, chunk, step, stat_guard=stat_guard)


def finish_megastep_chunk(model, chunk: Launched, guard=None) -> dict:
    """The readback of a launched chunk (``megastep_readback``) and the
    host fan-out of what the per-step loop does each step, once a
    chunk: the guard's ``good_step`` / ``bad_step`` for each step's ok
    flag (``guard``: default the engine's; the update of a bad step was
    already suppressed on the device), then each listener's
    ``chunk_done(model, it0, k, host)`` where it has one, else its
    ``iteration_done`` for each step, ``score_value`` that step's score;
    then the active profiler's record of the chunk. Returns the
    read-back metrics, with ``examples``."""
    from deeplearning4j_tpu_torch.observability import profiler

    if guard is None:
        guard = model.divergence_guard
    host = megastep_readback(chunk, guard is not None)
    host["examples"] = chunk.k * chunk.rows
    model._last_score = float(host["scores"][-1])
    if "grad_norms" in host:
        model._last_grad_norm = float(host["grad_norms"][-1])
    if guard is not None:
        for j in range(chunk.k):
            if host["oks"][j]:
                guard.good_step()
            else:
                guard.bad_step(model, step_index=chunk.it0 + j)
    prof = profiler.get_active_profiler()
    if model.listeners:
        t0 = time.perf_counter()
        per_step = []
        for listener in model.listeners:
            done = getattr(listener, "chunk_done", None)
            if done is not None:
                done(model, chunk.it0, chunk.k, host)
            else:
                per_step.append(listener)
        for j in range(chunk.k):
            model._last_score = float(host["scores"][j])
            for listener in per_step:
                listener.iteration_done(model, chunk.it0 + j + 1)
        model._last_score = float(host["scores"][-1])
        if prof is not None:
            prof.note_listener_ms((time.perf_counter() - t0) * 1e3)
    if prof is not None:
        prof.end_step(score=model._last_score, rows=chunk.k * chunk.rows,
                      chunk=chunk.k)
    return host


def run_megastep_chunk(model, chunk: Chunk) -> dict:
    """One chunk launched and read back (JAX ``run_megastep_chunk``)."""
    return finish_megastep_chunk(model, launch_megastep_chunk(model, chunk))


class MegastepFeed:
    """The megastep executor's launch-and-readback order: at most one
    chunk in flight, read back after the next is launched, so the host
    stages a chunk while the card runs the one before. With listeners
    or an active profiler each chunk is read back as soon as it is
    launched, as in JAX: a listener sees the model at its chunk's end,
    and what it does (a checkpoint, a preemption notice) lands before
    the next chunk; a profiler's record covers its chunk alone.
    ``drain()`` reads the chunk in flight back (an epoch's end, a
    preemption's quiesce)."""

    def __init__(self, model, guard=None, scores: Optional[list] = None):
        self.model = model
        self.guard = guard
        self.scores = scores
        self.launched = None

    def drain(self) -> None:
        launched, self.launched = self.launched, None
        if launched is not None:
            host = finish_megastep_chunk(self.model, launched, self.guard)
            if self.scores is not None:
                self.scores.append(float(host["scores"][-1]))

    def run(self, chunk: Chunk, step=None, stat_guard=None) -> None:
        """Launch ``chunk`` (through ``step``, default the engine's),
        then read the chunk before it back."""
        from deeplearning4j_tpu_torch.observability import profiler

        if profiler.get_active_profiler() is not None:
            self.drain()
        launched = launch_megastep_chunk(self.model, chunk, step,
                                         stat_guard)
        self.drain()
        self.launched = launched
        if (self.model.listeners
                or profiler.get_active_profiler() is not None):
            self.drain()


def prestacked_chunk(model, ds) -> Chunk:
    """A ``ChunkedDataSet`` (host arrays) or ``PlacedChunk`` (tensors
    already on the device, waited on here) as a ``Chunk`` for
    ``model``: each field one tensor (a list of one for a
    ``ComputationGraph``), narrow integers kept at their width."""
    wait = getattr(ds, "wait", None)
    if wait is not None:
        wait()
    dtype = dtype_of(model.conf)
    graph = hasattr(model.conf, "vertices")

    def one(a):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return t if t.dtype in NARROW_INTS else t.to(dtype)

    def field(a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return [None if e is None else one(e) for e in a]
        return [one(a)] if graph else one(a)

    k = ds.k
    rows = (ds.num_examples() // k)
    return Chunk(field(ds.features), field(ds.labels),
                 field(ds.labels_mask), field(ds.features_mask), k, rows,
                 getattr(ds, "weights", None))


def fit_epoch_megastep(model, batches, prefetch=None) -> int:
    """One epoch of ``batches`` (JAX ``fit_epoch_megastep``): same-shaped
    minibatches buffered into blocks of ``model.megastep`` (the engines'
    ``_ds_scan_sig``), each block one chunk (``MegastepFeed``); a
    pre-stacked block (``ChunkedDataSet`` / ``PlacedChunk``, from a
    chunk-mode ``PrefetchIterator``) is one chunk as it comes. A shorter
    block (the tail, or one cut by a change of shapes) runs per step, as
    in JAX: the trajectory is the same. The preemption check runs before
    each item; the chunk boundaries are the emergency checkpoint's
    (staleness at most K - 1 steps). Returns the minibatch count."""
    from deeplearning4j_tpu_torch.datasets.api import (
        ChunkedDataSet,
        PlacedChunk,
    )
    from deeplearning4j_tpu_torch.parallel import control_plane
    from deeplearning4j_tpu_torch.resilience import preemption

    k = int(model.megastep)
    feed = MegastepFeed(model)
    state = {"buf": [], "sig": None}

    def flush_megastep():
        buf, state["buf"] = state["buf"], []
        if len(buf) < k:
            feed.drain()
            for ds in buf:
                model.fit_minibatch(ds)
            return
        chunk = model._stack_chunk(buf)  # waits on placed minibatches
        note_last_features(model, buf[-1].features)
        feed.run(chunk)

    n = 0
    try:
        for ds in batches:
            preemption.check_fit(model, window=feed, prefetch=prefetch)
            control_plane.check_fit(model)
            if isinstance(ds, (ChunkedDataSet, PlacedChunk)):
                if state["buf"]:
                    flush_megastep()
                state["sig"] = None
                if ds.k >= 2:
                    chunk = prestacked_chunk(model, ds)  # waits on copies
                    note_last_features(model, ds.features[-1])
                    feed.run(chunk)
                else:
                    feed.drain()
                    for b in ds.to_datasets():
                        model.fit_minibatch(b)
                n += ds.k
                continue
            s = model._ds_scan_sig(ds)
            if state["buf"] and s != state["sig"]:
                flush_megastep()
            state["sig"] = s
            state["buf"].append(ds)
            n += 1
            if len(state["buf"]) >= k:
                flush_megastep()
        if state["buf"]:
            flush_megastep()
        feed.drain()
    finally:
        feed.launched = None
    return n


# --- the scan path: scan_chunk minibatches a chunk, no readback -------------
#
# JAX's default fit (``scan_chunk = 16``) runs up to 16 minibatches of
# the bare step flavour (no guard, no loss scaling) as one ``lax.scan``
# dispatch and reads nothing back; ``fit_epochs_device_cached`` keeps a
# list's stacked chunks on the device and replays them every epoch, and
# the fused truncated-BPTT scan runs many minibatches' TBPTT segments in
# one dispatch, the recurrent carry threaded through it and zeroed at
# each minibatch's first segment. Here each such chunk is
# ``chunk_steps`` over ``build_multi_step``'s step: eagerly on the CPU,
# one CUDA-graph replay on the card (``launch_chunk`` without a
# readback). The chunk's trajectory is bitwise the per-step loop's.


def build_multi_step(score_fn: Callable, updater, *,
                     recurrent_names: Sequence[str] = (),
                     tbptt: bool = False, grad_accum: int = 1) -> Callable:
    """The scan path's step (JAX ``build_multi_step``'s scanned body), in
    ``build_step``'s signature plus ``reset=``: the bare flavour (the
    gradients, accumulated over ``grad_accum`` microbatches, and the
    updater). Standard mode restores each recurrent layer's incoming
    state entry after the step (the carry resets each minibatch).
    ``tbptt=True`` threads the carry instead and multiplies it by ``1 -
    reset`` first (a 0-d f32 tensor, 1 at a minibatch's first segment;
    ``v * 0`` is bitwise the zeros of a primed carry), as JAX's ``v *
    keep``. TBPTT refuses ``grad_accum`` > 1: the carry threads between
    segments."""
    if tbptt and int(grad_accum) > 1:
        raise ValueError(
            "grad_accum > 1 is incompatible with the fused TBPTT path: "
            "the recurrent carry threads between chunks")
    inner = build_step(score_fn, updater, int(grad_accum), recurrent_names)
    names = tuple(recurrent_names)

    def step(params, upd_state, state, x, labels, mask, lrs, t, fmask=None,
             ls=None, sg=None, rng=None, reset=None):
        if tbptt:
            keep = 1.0 - reset
            state = dict(state)
            for name in names:
                state[name] = {k: v * keep.to(v.dtype)
                               for k, v in state[name].items()}
        out = inner(params, upd_state, state, x, labels, mask, lrs, t,
                    fmask, rng=rng)
        if not tbptt and names:
            new_state = dict(out.state)
            for name in names:
                new_state[name] = state[name]
            out = out._replace(state=new_state)
        return out

    return step


def scan_step(model, score_fn: Callable, tbptt: bool = False) -> Callable:
    """The engine's cached scan step (``build_multi_step``; TBPTT mode
    with ``tbptt``), dropped by ``set_grad_accum``."""
    attr = "_tbptt_multi_step" if tbptt else "_multi_step"
    step = getattr(model, attr)
    if step is None:
        step = build_multi_step(
            score_fn, model.updater_def,
            recurrent_names=model.recurrent_names(), tbptt=tbptt,
            grad_accum=1 if tbptt else model.grad_accum)
        setattr(model, attr, step)
    return step


def scan_active(model) -> bool:
    """The scan epoch applies (JAX ``_can_scan_steps() and scan_chunk >
    1``)."""
    return model._can_scan_steps() and int(model.scan_chunk) > 1


def batched_listeners(model) -> bool:
    """Every listener takes a chunk's callbacks after the chunk (JAX
    ``supports_batched_iterations``); one that does not forces the
    per-step path."""
    return all(getattr(listener, "supports_batched_iterations", False)
               for listener in model.listeners)


def finish_scan_chunk(model, launched: Launched, prof=None) -> None:
    """The host side of a scan chunk (JAX ``run_scan_chunk`` after its
    dispatch): ``score_value`` the chunk's last score (a device scalar:
    nothing is read back), each listener's ``iteration_done`` for each
    step with that step's score, then the active profiler's record of
    the chunk."""
    k, scores = launched.k, launched.metrics
    model._last_score = scores[k - 1]
    if model.listeners:
        t0 = time.perf_counter()
        for i in range(k):
            model._last_score = scores[i]
            for listener in model.listeners:
                listener.iteration_done(model, launched.it0 + i + 1)
        model._last_score = scores[k - 1]
        if prof is not None:
            prof.note_listener_ms((time.perf_counter() - t0) * 1e3)
    if prof is not None:
        prof.end_step(score=model._last_score, rows=k * launched.rows)


def run_scan_chunk(model, chunk: Chunk) -> None:
    """One scan chunk of ``model`` (JAX ``run_scan_chunk``): the bare
    scan step over the chunk's k minibatches, one replay on the card,
    no readback; one profiler record covers it."""
    from deeplearning4j_tpu_torch.observability import profiler

    prof = profiler.get_active_profiler()
    if prof is not None:
        prof.begin_step(model.iteration_count + chunk.k, device=model.device)
    canonicalize_updater_state(model)
    check_grad_accum_batch(model.grad_accum, chunk.rows)
    launched = launch_chunk(model, chunk, model._scan_step(),
                            readback=False, hint="scan_chunk=1")
    finish_scan_chunk(model, launched, prof)


def note_last_features(model, features) -> None:
    """Where a listener asks for it (JAX ``_wants_last_features``: the
    graph engine has no such method and takes no snapshot, as JAX's
    takes none), ``model._last_features`` is ``features``, the caller's
    features of a chunk's last minibatch: a host array as it came, a
    tensor (a placed chunk's last rows) cloned, so neither a chunk's
    static input buffer nor a pipeline's reused one backs it. The caller
    has waited on a placed payload's copies first (``prestacked_chunk``,
    ``_stack_chunk``): the clone runs on the current stream and must
    not read a buffer the prefetch worker's copy stream still fills."""
    wants = getattr(model, "_wants_last_features", None)
    if wants is not None and wants():
        model._last_features = (features.clone() if torch.is_tensor(features)
                                else features)


def flush_scan_chunk(model, batches: list) -> None:
    if len(batches) == 1:
        model.fit_minibatch(batches[0])
        return
    chunk = model._stack_chunk(batches)  # waits on placed minibatches
    note_last_features(model, batches[-1].features)
    run_scan_chunk(model, chunk)


def run_prestacked_scan(model, ds) -> None:
    """A ``ChunkedDataSet`` / ``PlacedChunk`` on the scan path: one chunk
    (JAX ``_run_prestacked_chunk``; one minibatch runs per step)."""
    if ds.k == 1:
        model.fit_minibatch(ds)  # it unstacks a ChunkedDataSet
        return
    chunk = prestacked_chunk(model, ds)  # waits on a placed chunk's copies
    note_last_features(model, ds.features[-1])
    run_scan_chunk(model, chunk)


def fit_epoch_scan(model, batches, prefetch=None) -> int:
    """One epoch on the scan path (JAX ``fit_epoch_scan``): consecutive
    same-shaped minibatches buffered into chunks of ``model.scan_chunk``
    (a change of shapes cuts one), each chunk one ``run_scan_chunk``; a
    chunk of one runs per step; a pre-stacked block is a chunk as it
    comes. The preemption check runs before each item: an unflushed
    buffer holds no launched work, so the emergency checkpoint is the
    last flushed step's. Returns the minibatch count."""
    from deeplearning4j_tpu_torch.datasets.api import (
        ChunkedDataSet,
        PlacedChunk,
    )
    from deeplearning4j_tpu_torch.parallel import control_plane
    from deeplearning4j_tpu_torch.resilience import preemption

    model._reset_recurrent_state()  # the scan carries empty entries
    buf: list = []
    sig = None
    n = 0
    for ds in batches:
        preemption.check_fit(model, prefetch=prefetch)
        control_plane.check_fit(model)
        if isinstance(ds, (ChunkedDataSet, PlacedChunk)):
            if buf:
                flush_scan_chunk(model, buf)
                buf, sig = [], None
            run_prestacked_scan(model, ds)
            n += ds.k
            continue
        s = model._ds_scan_sig(ds)
        if buf and s != sig:
            flush_scan_chunk(model, buf)
            buf = []
        sig = s
        buf.append(ds)
        n += 1
        if len(buf) >= model.scan_chunk:
            flush_scan_chunk(model, buf)
            buf = []
    if buf:
        flush_scan_chunk(model, buf)
    return n


def build_scan_plan(seq, sig_fn: Callable, stack_fn: Callable,
                    scan_chunk: int) -> list:
    """A device-cached plan (JAX ``build_scan_plan``): each run of n
    consecutive same-signature items split into ``ceil(n / scan_chunk)``
    groups of near-equal size, ``("chunk", stack_fn(group), last item)``
    or ``("single", item, item)`` entries. JAX fills chunks and leaves a
    shorter tail, as ``fit_epoch_scan`` does on a stream; a plan knows
    its whole list, so it balances: 24 minibatches at 16 make two chunks
    of 12, one CUDA graph to capture instead of two. The trajectory is
    the same either way."""
    plan: list = []

    def flush(group):
        if len(group) == 1:
            plan.append(("single", group[0], group[0]))
        elif group:
            plan.append(("chunk", stack_fn(group), group[-1]))

    def flush_run(run):
        n_groups = -(-len(run) // scan_chunk)
        size, extra = divmod(len(run), n_groups)
        at = 0
        for g in range(n_groups):
            n = size + (1 if g < extra else 0)
            flush(run[at:at + n])
            at += n

    run: list = []
    sig = None
    for item in seq:
        s = sig_fn(item)
        if run and s != sig:
            flush_run(run)
            run = []
        sig = s
        run.append(item)
    flush_run(run)
    return plan


def chunk_to(chunk: Chunk, device) -> Chunk:
    """``chunk`` with every field on ``device`` (narrow integers keep
    their width)."""
    def move(f):
        return _map_tree(lambda a: a.to(device), f)

    return chunk._replace(xs=move(chunk.xs), ys=move(chunk.ys),
                          lmasks=move(chunk.lmasks),
                          fmasks=move(chunk.fmasks),
                          weights=move(chunk.weights),
                          resets=move(chunk.resets))


def cached_epoch_plan(model, batches, epochs: int, arrays_of: Callable):
    """The device-cached plan of a multi-epoch fit (JAX
    ``cached_epoch_plan``): None (the caller streams) for one epoch, an
    input that is not a non-empty list of datasets, a configuration the
    scan refuses, ``scan_chunk`` 1, or data larger than
    ``model.device_cache_bytes`` (``arrays_of(ds)`` yields every array a
    chunk holds); else the scan plan, its chunks stacked and placed on
    the device once, its groups balanced (``build_scan_plan``)."""
    if (epochs <= 1 or not isinstance(batches, (list, tuple))
            or len(batches) == 0 or not scan_active(model)):
        return None
    total = 0
    for ds in batches:
        if not hasattr(ds, "features"):
            return None
        total += sum(nbytes(a) for a in arrays_of(ds))
    if total > model.device_cache_bytes:
        return None
    return build_scan_plan(
        batches, model._ds_scan_sig,
        lambda group: chunk_to(model._stack_chunk(group), model.device),
        model.scan_chunk)


def fit_epochs_device_cached(model, batches, epochs: int,
                             arrays_of: Callable,
                             extra_plan_fn: Optional[Callable] = None
                             ) -> bool:
    """A multi-epoch fit of a list with its chunks kept on the device
    (JAX ``fit_epochs_device_cached``): each chunk crosses to the device
    once and is replayed every epoch (``run_scan_chunk``; a TBPTT plan's
    items through the engine's ``_run_tbptt_stacked``; a single
    minibatch per step). The learning rates and step counts are those of
    the streamed epochs. Returns False, having done nothing, where no
    plan applies (``extra_plan_fn(batches, epochs)`` first, then
    ``cached_epoch_plan``)."""
    from deeplearning4j_tpu_torch.parallel import control_plane
    from deeplearning4j_tpu_torch.resilience import preemption

    plan = extra_plan_fn(batches, epochs) if extra_plan_fn else None
    if plan is None:
        plan = cached_epoch_plan(model, batches, epochs, arrays_of)
    if plan is None:
        return False
    for _ in range(epochs):
        for listener in model.listeners:
            if hasattr(listener, "on_epoch_start"):
                listener.on_epoch_start(model)
        model._reset_recurrent_state()
        for kind, item, last in plan:
            preemption.check_fit(model)
            control_plane.check_fit(model)
            if kind == "chunk":
                note_last_features(model, last.features)
                run_scan_chunk(model, item)
            elif kind == "tbptt":
                note_last_features(model, last.features)
                model._run_tbptt_stacked(item)
            else:
                model.fit_minibatch(item)
        for listener in model.listeners:
            if hasattr(listener, "on_epoch_end"):
                listener.on_epoch_end(model)
        model.epoch_count += 1
    return True


def set_batch_validator(model, validator, quarantine=None) -> None:
    """(Un)install the data-plane defense on a model's fit loop (JAX
    ``core.set_batch_validator``): ``fit_batches`` wraps its iterator in
    a ``ValidatingIterator`` that quarantines rejects to
    ``quarantine``."""
    model._batch_validator = validator
    model._quarantine_store = quarantine


def _batches_of(data, labels, graph: bool):
    """What the engines' ``fit`` iterates: one (x, y) pair, one DataSet,
    or the iterable itself."""
    from deeplearning4j_tpu_torch.datasets.api import DataSet

    if labels is not None:
        if graph:
            def as_list(v):
                return list(v) if isinstance(v, (list, tuple)) else [v]
            return [DataSet(features=as_list(data), labels=as_list(labels))]
        return [DataSet(features=data, labels=labels)]
    if hasattr(data, "features"):
        return [data]
    return data


def fit_batches(model, data, labels=None, epochs: int = 1) -> None:
    """Both engines' epoch loop (JAX ``core.fit_batches``): the batch
    validator (``set_batch_validator``) wraps the stream; then the first
    path that applies: the megastep executor where ``can_megastep``
    allows it, the device-cached replay of a list over several epochs
    (the engine's ``_fit_epochs_device_cached``), the scan epoch
    (``scan_active``), else the per-step loop through an
    ``AsyncDispatchWindow`` (the preemption check before each step; the
    window drained at the epoch's end, where a guard abort surfaces).
    Each epoch runs the listeners' ``on_epoch_start`` / ``on_epoch_end``
    and resets an iterator with ``reset()`` after it. An exception drops
    the window's outstanding work and the profiler's open step, and
    dumps the flight recorder (a preemption has attached it to its
    checkpoint already)."""
    from deeplearning4j_tpu_torch.observability import flightrec, profiler
    from deeplearning4j_tpu_torch.parallel.dispatch import (
        AsyncDispatchWindow,
    )
    from deeplearning4j_tpu_torch.parallel import control_plane
    from deeplearning4j_tpu_torch.resilience import preemption

    if model.params is None:
        model.init()
    iterator = _batches_of(data, labels, hasattr(model.conf, "vertices"))
    validator = model._batch_validator
    if validator is not None:
        from deeplearning4j_tpu_torch.datasets.validate import (
            ValidatingIterator,
        )

        if not isinstance(iterator, ValidatingIterator):
            iterator = ValidatingIterator(
                iterator, validator, quarantine=model._quarantine_store)
    if model.conf.pretrain and not model._pretrain_done:
        # reference fit():1064: layer-wise pretraining before backprop
        if not hasattr(iterator, "reset") and not isinstance(
                iterator, (list, tuple)):
            iterator = list(iterator)
        model.pretrain(iterator)
    if not model.conf.backprop:
        return
    prefetch = iterator if hasattr(iterator, "shutdown") else None
    window = AsyncDispatchWindow(
        model=model, guard_fn=lambda: model.divergence_guard,
        max_in_flight=model.max_in_flight, guard_lag=model.guard_lag)
    try:
        # megastep=K outranks the device-cached replay: the caller asked
        # for the K-step executor and its one readback a chunk
        if not can_megastep(model) and model._fit_epochs_device_cached(
                iterator, epochs):
            return
        for epoch in range(epochs):
            for listener in model.listeners:
                if hasattr(listener, "on_epoch_start"):
                    listener.on_epoch_start(model)
            if can_megastep(model):
                n_batches = fit_epoch_megastep(model, iter(iterator),
                                               prefetch=prefetch)
            elif scan_active(model):
                n_batches = fit_epoch_scan(model, iter(iterator),
                                           prefetch=prefetch)
            else:
                n_batches = 0
                model._dispatch_window = window
                try:
                    for ds in iterator:
                        preemption.check_fit(model, window=window,
                                             prefetch=prefetch)
                        control_plane.check_fit(model)
                        model.fit_minibatch(ds)
                        n_batches += 1
                finally:
                    model._dispatch_window = None
                window.drain()
            if epoch > 0 and n_batches == 0:
                raise ValueError(
                    "Iterator yielded no batches after the first epoch — "
                    "a plain generator cannot be re-iterated; pass a list, "
                    "a DataSetIterator with reset(), or epochs=1")
            if hasattr(iterator, "reset"):
                iterator.reset()
            for listener in model.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(model)
            model.epoch_count += 1
    except BaseException as e:
        window.abandon()
        prof = profiler.get_active_profiler()
        if prof is not None:
            prof.abandon_step()
        if not isinstance(e, preemption.PreemptedException):
            flightrec.dump_on_crash("fit_exception")
        raise


def field_sig(a):
    """A minibatch field's shape and dtype without reading it (None stays
    None)."""
    if a is None:
        return None
    return tuple(np.shape(a)), str(a.dtype)


# --- streaming (rnn_time_step) bookkeeping ----------------------------------


def stream_guard_and_prime(named_layers, rnn_state, stream_steps: int,
                           t_new: int, batch: int, dtype, device) -> None:
    """``rnn_time_step`` bookkeeping: raise before a finite streaming
    cache would wrap, and prime the missing streaming state (zero
    carries on ``device``). ``named_layers``: (name, layer) pairs."""
    caps = [lc.stream_capacity() for _, lc in named_layers
            if lc.streams_state() and lc.stream_capacity()]
    if caps and stream_steps + t_new > min(caps):
        raise ValueError(
            f"rnn_time_step overflow: {stream_steps} + {t_new} timesteps "
            f"exceeds the smallest streaming cache ({min(caps)}); call "
            "rnn_clear_previous_state()")
    for name, lc in named_layers:
        if (lc.streams_state() and name not in rnn_state
                and getattr(lc, "init_stream_state", None) is not None):
            rnn_state[name] = lc.init_stream_state(batch, dtype, device)


def refuse_unstreamable(named_layers, what: str) -> None:
    """Raise for a layer that needs the whole sequence (a bidirectional
    RNN): ``rnn_time_step`` cannot feed it a timestep at a time."""
    for name, lc in named_layers:
        if not lc.can_stream():
            raise ValueError(
                f"{what} '{name}' ({type(lc).__name__}) cannot be used "
                "with rnn_time_step: it needs the full sequence "
                "(reference throws UnsupportedOperationException)")


def stream_forward(model, named_layers, t_new: int, batch: int, forward):
    """One ``rnn_time_step`` call of either engine: prime the carries
    (``stream_guard_and_prime``), run ``forward(state)`` on the layer
    state merged with them, keep the new carries and count the
    timesteps. ``forward`` returns ``(out, new_state)``; returns
    ``out``."""
    stream_guard_and_prime(named_layers, model._rnn_state,
                           model._stream_steps, t_new, batch,
                           dtype_of(model.conf), model.device)
    merged = dict(model.state)
    for name, carry in model._rnn_state.items():
        merged[name] = {**merged.get(name, {}), **carry}
    out, new_state = forward(merged)
    extract_stream_state(named_layers, new_state, model._rnn_state)
    model._stream_steps += t_new
    return out


def extract_stream_state(named_layers, new_state, rnn_state) -> None:
    """Pull each streaming layer's carry out of a forward's state into
    the held ``rnn_state`` (the reference's stateMap)."""
    for name, lc in named_layers:
        if lc.streams_state():
            rnn_state[name] = {k: new_state[name][k]
                               for k in lc.stream_state_keys()
                               if k in new_state[name]}


def zero_gather_updater_state(upd_state, params, shards: int):
    """ZeRO-1's flat layout back to the canonical one (JAX
    ``zero_gather_updater_state``): each rank holds the ``ceil(n /
    shards)`` slice of every flattened, zero-padded moment; the slices
    are all-gathered over the default group (every rank must call this,
    in lockstep), the padding dropped and the parameter's shape
    restored."""
    shards = int(shards)
    if shards > 1 and not (torch.distributed.is_available()
                           and torch.distributed.is_initialized()):
        raise RuntimeError(
            f"the updater state is sharded over {shards} ranks and "
            "torch.distributed is not initialized: gather it (write_model, "
            "fit) before leaving the world")

    def gather(s, p):
        if shards > 1:
            parts = [torch.empty_like(s) for _ in range(shards)]
            torch.distributed.all_gather(parts, s.contiguous())
            s = torch.cat(parts)
        return s[:p.numel()].view_as(p).clone()

    return {ln: {pn: tuple(gather(s, params[ln][pn]) for s in tup)
                 for pn, tup in lp.items()}
            for ln, lp in upd_state.items()}


def row_gather_trees(params, upd_state, layout):
    """The row-sharded layout back to the whole tables
    (``layout = {"shards": n, "rank": r, "layers": [names]}``, set by
    the distributed trainer): each named layer's ``W`` and its updater
    rows gathered from every rank through the all_reduce-only exchange
    (``parallel/row_exchange.py``, bit for bit; every rank must call
    this, in lockstep). Returns new ``(params, updater state)``; the
    other leaves are the same tensors."""
    from deeplearning4j_tpu_torch.parallel import row_exchange

    n, rank = int(layout["shards"]), int(layout["rank"])
    if n > 1 and not (torch.distributed.is_available()
                      and torch.distributed.is_initialized()):
        raise RuntimeError(
            f"an embedding table is row-sharded over {n} ranks and "
            "torch.distributed is not initialized: gather it (write_model, "
            "fit) before leaving the world")
    params = {ln: dict(lp) for ln, lp in params.items()}
    upd = (None if upd_state is None else
           {ln: dict(lp) for ln, lp in upd_state.items()})
    for ln in layout["layers"]:
        params[ln]["W"] = row_exchange.gather_table(params[ln]["W"], n,
                                                    rank)
        if upd is not None and "W" in upd.get(ln, {}):
            upd[ln]["W"] = tuple(row_exchange.gather_table(a, n, rank)
                                 for a in upd[ln]["W"])
    return params, upd


def tp_gather_trees(params, upd_state, layout):
    """Tensor-parallel shards back to whole parameters and moments
    (``layout = {"mesh": mesh, "params": {layer: {param: (axis, shard
    shape)}}}``, set by the distributed trainer), gathered over the
    model ranks (every rank must call this, in lockstep). Returns new
    ``(params, updater state)``; the other leaves are the same tensors."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        gather_whole,
    )

    mesh = layout["mesh"]
    params = {ln: dict(lp) for ln, lp in params.items()}
    upd = (None if upd_state is None else
           {ln: dict(lp) for ln, lp in upd_state.items()})
    for ln, entries in layout["params"].items():
        for pn, (axis, _) in entries.items():
            params[ln][pn] = gather_whole(params[ln][pn], axis, mesh)
            if upd is not None and pn in upd.get(ln, {}):
                upd[ln][pn] = tuple(gather_whole(a, axis, mesh)
                                    for a in upd[ln][pn])
    return params, upd


def canonical_trees(model):
    """``(params, updater state)`` of ``model`` in the canonical,
    replicated layout, without changing the model: a ZeRO-1 flat layout,
    row-sharded tables and tensor-parallel shards gathered (collectives
    every rank joins). What a checkpoint holds."""
    params, upd = model.params, model.updater_state
    tp = getattr(model, "_tp_layout", None)
    if tp:
        params, upd = tp_gather_trees(params, upd, tp)
    rows = getattr(model, "_row_layout", None)
    if rows:
        params, upd = row_gather_trees(params, upd, rows)
    layout = getattr(model, "_zero_layout", None)
    if upd is not None and layout:
        upd = zero_gather_updater_state(upd, params, layout["shards"])
    return params, upd


def canonicalize_updater_state(model) -> None:
    """Bring a model whose updater state is in ZeRO-1's flat layout
    (``model._zero_layout = {"shards": n}``) or whose embedding tables
    are row-sharded (``model._row_layout``), both set by the distributed
    trainer, back to parameter-shaped, whole trees, in place. A
    collective on more than one rank: the engines' ``fit`` and a new
    trainer call it on every rank."""
    if (getattr(model, "_zero_layout", None)
            or getattr(model, "_row_layout", None)
            or getattr(model, "_tp_layout", None)):
        model.params, model.updater_state = canonical_trees(model)
    model._zero_layout = None
    model._row_layout = None
    model._tp_layout = None

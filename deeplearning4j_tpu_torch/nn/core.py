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
the chunk captured in a CUDA graph (``GraphedChunk``).
"""

from __future__ import annotations

import functools
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


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array or tensor as a contiguous tensor on ``device`` in
    ``dtype`` (JAX ``core.to_device``): uint8 / int8 / int16 data moves
    at its own width and is cast on the device, everything else is
    cast first."""
    t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    if dtype is not None and t.dtype in NARROW_INTS:
        t = t.to(device=device)
    return t.to(device=device, dtype=dtype).contiguous()


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


def reg_penalty(layer, layer_params):
    """L1/L2 penalty for one layer (reference calcL1/calcL2)."""
    reg = 0.0
    if layer.l1 > 0.0 or layer.l2 > 0.0:
        for pn in layer.regularizable_params():
            if pn in layer_params:
                w = layer_params[pn]
                if layer.l2 > 0.0:
                    reg = reg + 0.5 * layer.l2 * torch.sum(w * w)
                if layer.l1 > 0.0:
                    reg = reg + layer.l1 * torch.sum(torch.abs(w))
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
                       remat: str = "none", collect: bool = False):
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
    (``maybe_remat``; the recompute draws the same masks)."""
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import ShapeContext

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
                layer, conf.layers[i + 1], params.get(name, {}),
                params.get(nxt, {}), state.get(nxt, {}), x)
            if fused is not None:
                x = fused
                i += 2
                continue
        lrng = layer_rng(rng, i, layer, train)
        if preout and i == n - 1 and layer.has_loss():
            xin = layer.maybe_dropout(x, train=train, rng=lrng)
            pw = layer.maybe_drop_connect(params[name], train=train,
                                          rng=lrng)
            return layer.pre_output(pw, xin), new_state
        apply_one = maybe_remat(functools.partial(
            layer.apply, train=train, rng=lrng, mask=fmask),
            remat if train and not layer.has_loss() else "none")
        x, new_state[name] = apply_one(params[name], x, state.get(name, {}))
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
                     weights=None, remat: str = "none"):
    """Loss score plus the L1/L2 penalty (the reference's
    computeGradientAndScore adds calcL1/calcL2 to the loss); returns
    ``(score, new_state)``. ``mask`` is the labels mask; for 3-d labels
    without one the features mask ``fmask`` masks the loss (the
    reference's output-layer masking). ``weights`` = ``([loss weight],
    penalty weight)`` scales the two terms (a data-parallel rank's share
    of the global score); None: both 1. ``rng``: the step's key."""
    from deeplearning4j_tpu_torch.nn import losses

    last = conf.layers[-1]
    if not last.has_loss():
        raise ValueError(
            "Last layer has no loss function; use an OutputLayer/LossLayer")
    preout, new_state = sequential_forward(
        conf, layer_names, params, state, x, train=train, rng=rng,
        preout=True, fmask=fmask, remat=remat)
    if mask is None and labels.dim() == 3:
        mask = fmask
    score = losses.score(last.loss, labels, preout, last.activation, mask,
                         True)
    reg = 0.0
    for lname, layer in zip(layer_names, conf.layers):
        reg = reg + reg_penalty(layer, params[lname])
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
    loss-scale state, the new statistical-guard state and the guard's
    ok flag (a 0-d bool tensor on the device), each None where that
    flavour is off."""
    params: dict
    upd_state: dict
    state: dict
    score: torch.Tensor
    loss_scale: Optional[dict] = None
    stat_guard: Optional[dict] = None
    ok: Optional[torch.Tensor] = None


def finish_step(updater, grads, score, new_state, params, upd_state,
                state, lrs: Dict[str, float], t: int, *,
                guarded: bool = False, ls=None, sg=None, sg_cfg=None,
                update: Optional[Callable] = None) -> StepOut:
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
    is a select on the device: nothing is read back on the host."""
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
    if ls is not None or guarded:
        # the squared global norm of the (unscaled) gradients, taken
        # once: the overflow probe, the divergence guard's and the
        # statistical guard's gradient norm all read it
        nsq = grad_global_norm_sq(grads)
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
        return StepOut(new_params, new_upd, new_state, score, new_ls)
    ok = divergence_ok(score, norm_sq=nsq)
    new_sg = None
    if sg is not None:
        sg_ok, new_sg = stat_guard_update(sg, sg_cfg, score,
                                          torch.sqrt(nsq), ok)
        ok = torch.logical_and(ok, sg_ok)
    new_params, new_upd, new_state = select_updates(
        ok, new_params, params, new_upd, upd_state, new_state, state)
    return StepOut(new_params, new_upd, new_state, score, new_ls, new_sg, ok)


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


def check_grad_accum_batch(k: int, batch_n: int) -> None:
    if k > 1 and batch_n % k != 0:
        raise ValueError(
            f"grad_accum={k} needs the batch to split into equal "
            f"microbatches; got batch size {batch_n}")


def build_step(score_fn: Callable, updater, grad_accum: int = 1,
               recurrent_names: Sequence[str] = (), *,
               guarded: bool = False, loss_scale: bool = False,
               stat_guard=None) -> Callable:
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
    ``sg``."""
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
                           sg_cfg=stat_guard)

    return step


# --- the model's transform knobs and step flavours -------------------------


def init_transforms(model) -> None:
    """The whole-net transform knobs from the configuration's hints (JAX
    ``core.init_transforms``): ``scan_layers``, ``remat``, ``loss_scale``
    (True: DEFAULT_LOSS_SCALE), ``megastep`` 1, and no loss-scale or EWMA
    state and no captured chunk yet. Called from both engines'
    constructors."""
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


def model_step(model, score_fn: Callable) -> Callable:
    """The engine's cached step with its flavours: the guard and the
    statistical guard as installed, loss scaling where it is active."""
    if model._step is None:
        guard = model.divergence_guard
        model._step = build_step(
            score_fn, model.updater_def, model.grad_accum,
            model.recurrent_names(), guarded=guard is not None,
            loss_scale=loss_scale_active(model),
            stat_guard=stat_guard_config(model))
    return model._step


def run_step(model, step, x, labels, mask, fmask):
    """One optimizer step of ``model`` (either engine) through ``step``:
    the scheduled learning rates, Adam's ``t``, the step's key, the
    loss-scale and EWMA state in, the new trees, states and score out onto the model, then
    the guard's host policy (one read of its ok flag). Returns the
    score, a 0-d tensor on the device."""
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
    if model.divergence_guard is not None:
        model.divergence_guard.consult(model, out.ok)
    return out.score


def apply_step_out(model, out: StepOut) -> None:
    """The step's trees and flavour states onto the model."""
    model.params, model.updater_state, model.state = out[:3]
    if out.loss_scale is not None:
        model._loss_scale_state = out.loss_scale
    if out.stat_guard is not None:
        model._stat_guard_state = out.stat_guard


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
            and not any(getattr(layer, "row_sharded", False)
                        for layer in model.layer_confs()))


class Chunk(NamedTuple):
    """K minibatches stacked on a new leading axis (JAX ``_stack_chunk``):
    features, labels, labels masks and features masks (tensors for
    ``MultiLayerNetwork``, lists of tensors for ``ComputationGraph``;
    masks may be None), the step count and the rows of a minibatch."""
    xs: object
    ys: object
    lmasks: object
    fmasks: object
    k: int
    rows: int


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


def chunk_steps(model, step, trees, fields, lr_names, lr_stack, it0,
                base_key, steps: int):
    """``steps`` train steps of ``model`` through ``step`` (the engine's
    cached step, any flavour): step i takes slot i of ``fields``
    (features, labels, labels masks, features masks; narrow integers
    cast here), the learning rates of row i of ``lr_stack`` (keys
    ``lr_names``, ``MultiLayerUpdaterDef.lr_table``), ``t = it0 + 1 +
    i`` and the key ``fold_in(base_key, it0 + i)`` (``it0`` a 0-d int64
    tensor, ``base_key`` ``random.key(conf.seed)``). ``trees`` = (params,
    updater state, layer state, loss-scale state or None, EWMA state or
    None). Returns the new trees and the metrics vector ``[scores (k),
    their f32 sum, and with the guard its ok flags (k) and trips]``.
    Nothing is read back: a CUDA graph captures this function whole."""
    params, upd_state, state, ls, sg = trees
    dtype = dtype_of(model.conf)
    draws = draws_masks(model)

    def slot(tree, i):
        return _map_tree(lambda a: a[i].to(dtype) if a.dtype in NARROW_INTS
                           else a[i], tree)

    scores, oks = [], []
    for i in range(steps):
        it = it0 + i
        out = step(params, upd_state, state, *(slot(f, i) for f in fields[:3]),
                   {n: lr_stack[i, j] for j, n in enumerate(lr_names)},
                   (it + 1).to(torch.float32), slot(fields[3], i), ls=ls,
                   sg=sg, rng=random.fold_in(base_key, it) if draws else None)
        params, upd_state, state = out[:3]
        ls = ls if out.loss_scale is None else out.loss_scale
        sg = sg if out.stat_guard is None else out.stat_guard
        scores.append(out.score.float().reshape(()))
        if out.ok is not None:
            oks.append(out.ok.reshape(()))
    sc = torch.stack(scores)
    parts = [sc, sc.sum().reshape(1)]
    if oks:
        ok = torch.stack(oks).float()
        parts += [ok, (steps - ok.sum()).reshape(1)]
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
    ``scan_consts`` stage the same values), the pinned host staging of
    those copies, and the graph. The capture follows one eager warm-up
    step on a side stream (whose results are dropped): it loads the
    built kernel libraries and caches the conv kernels' tap tables. A
    capture that fails raises; nothing falls back to the eager chunk."""

    def __init__(self, model, step, chunk: Chunk, lr_names, trees):
        dev = model.device
        self.step = step
        self.k = chunk.k
        self.lr_names = list(lr_names)
        self.trees = _map_tree(lambda t: t.detach().clone(), trees)
        fields = (chunk.xs, chunk.ys, chunk.lmasks, chunk.fmasks)
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
        self.it0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.key = random.key(model.conf.seed, dev)
        self.graph = torch.cuda.CUDAGraph()
        self.metrics = None
        self.staged = None

    def _body(self, model, steps: int):
        return chunk_steps(model, self.step, self.trees, self.inputs,
                           self.lr_names, self.lr, self.it0, self.key, steps)

    def fill(self, chunk: Chunk, lr_rows: np.ndarray, it0: int) -> None:
        """This chunk's minibatches, learning rates and ``it0`` into the
        static buffers: non-blocking copies from the pinned staging,
        which is rewritten only once the previous fill's copies are
        done (``staged``); on the stream they follow the previous
        replay."""
        if self.staged is not None:
            self.staged.synchronize()
        fields = (chunk.xs, chunk.ys, chunk.lmasks, chunk.fmasks)
        for a, h, d in zip(_leaves(fields), self.staging,
                           _leaves(self.inputs), strict=True):
            if h is None:
                d.copy_(a, non_blocking=True)
            else:
                h.copy_(a)
                d.copy_(h, non_blocking=True)
        self.lr_host.copy_(torch.from_numpy(lr_rows))
        self.lr.copy_(self.lr_host, non_blocking=True)
        self.it0.fill_(int(it0))
        self.staged = torch.cuda.Event()
        self.staged.record()

    def capture(self, model) -> None:
        dev = model.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body(model, 1)
        torch.cuda.current_stream(dev).wait_stream(side)
        try:
            with torch.cuda.graph(self.graph):
                new_trees, self.metrics = self._body(model, self.k)
                _copy_into(self.trees, new_trees)
        except Exception as e:
            self.graph = torch.cuda.CUDAGraph()  # the next chunk recaptures
            raise RuntimeError(
                f"megastep: capturing the {self.k}-step chunk in a CUDA graph "
                f"failed ({type(e).__name__}: {e}); a step that reads the "
                "device back on the host cannot be captured: run it with "
                "megastep=1") from e

    def replay(self, trees):
        """One replay from ``trees`` (the model's; leaves that are not
        already the static ones are copied in first); returns the static
        trees, now holding the chunk's results, and its metrics."""
        _copy_into(self.trees, trees)
        self.graph.replay()
        return self.trees, self.metrics


def _graphed_chunk(model, step, chunk: Chunk, lr_names, trees) -> GraphedChunk:
    """The model's captured chunk for this signature (the step count,
    the minibatches' shapes and dtypes, the learning-rate keys, the
    remat policy and the step flavour: the engine's cached step), made
    and captured on its first use."""
    fields = (chunk.xs, chunk.ys, chunk.lmasks, chunk.fmasks)
    sig = (chunk.k, tuple(str(f) if f is None else
                          tuple((tuple(a.shape), a.dtype)
                                for a in _leaves(f)) for f in fields),
           tuple(lr_names), model.remat)
    g = model._megastep_graphs.get(sig)
    if g is None or g.step is not step:
        g = model._megastep_graphs[sig] = GraphedChunk(model, step, chunk,
                                                        lr_names, trees)
    return g


class Launched(NamedTuple):
    """A chunk launched and not yet read back: its metrics vector (on
    the card, a pinned host copy in flight, ``done`` recorded after it),
    its step count and rows, and its first iteration."""
    metrics: torch.Tensor
    done: Optional[object]
    k: int
    rows: int
    it0: int


def megastep_readback(chunk: Launched, guarded: bool) -> dict:
    """The megastep path's one host readback a chunk (JAX
    ``megastep_readback``), its one wait for the card: the metrics
    vector of ``chunk_steps`` to ``scores`` [k], ``loss_sum`` and, with
    the guard, ``oks`` [k] and ``guard_trips``."""
    if chunk.done is not None:
        chunk.done.synchronize()
    host, k = chunk.metrics.numpy(), chunk.k
    out = {"scores": host[:k], "loss_sum": float(host[k])}
    if guarded:
        out["oks"] = host[k + 1:2 * k + 1] > 0.5
        out["guard_trips"] = int(host[2 * k + 1])
    return out


def launch_megastep_chunk(model, chunk: Chunk) -> Launched:
    """One K-step chunk of ``model`` (either engine; JAX
    ``run_megastep_chunk``'s dispatch): eagerly on the CPU; on the card
    the chunk's minibatches staged and one replay of its CUDA graph
    (captured at the signature's first chunk), the metrics copied to the
    host behind it. The model holds the chunk's trees and iteration
    count at once (on the card, tensors the replay is still writing:
    the stream orders every later use after it)."""
    model._check_trainable()
    canonicalize_updater_state(model)
    check_grad_accum_batch(model.grad_accum, chunk.rows)
    step = model._train_step()
    it0 = model.iteration_count
    lr_names, lr_rows = model.updater_def.lr_table(it0, chunk.k)
    trees = (model.params, model.updater_state, model.state,
             ensure_loss_scale_state(model) if loss_scale_active(model)
             else None,
             ensure_stat_guard_state(model)
             if stat_guard_config(model) is not None else None)
    done = None
    if model.device.type == "cuda":
        g = _graphed_chunk(model, step, chunk, lr_names, trees)
        g.fill(chunk, lr_rows, it0)
        if g.metrics is None:
            g.capture(model)
        new_trees, metrics = g.replay(trees)
        host = torch.empty(metrics.shape, dtype=metrics.dtype,
                           pin_memory=True)
        host.copy_(metrics, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        fields = tuple(_map_tree(lambda a: a.to(model.device), f)
                       for f in (chunk.xs, chunk.ys, chunk.lmasks,
                                 chunk.fmasks))
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


def finish_megastep_chunk(model, chunk: Launched) -> dict:
    """The readback of a launched chunk (``megastep_readback``) and the
    host fan-out of the guard's policy, once a chunk: ``good_step`` /
    ``bad_step`` for each step's ok flag (the update of a bad step was
    already suppressed on the device). Returns the read-back metrics,
    with ``examples``."""
    guard = model.divergence_guard
    host = megastep_readback(chunk, guard is not None)
    host["examples"] = chunk.k * chunk.rows
    model._last_score = float(host["scores"][-1])
    if guard is not None:
        for j in range(chunk.k):
            if host["oks"][j]:
                guard.good_step()
            else:
                guard.bad_step(model, step_index=chunk.it0 + j)
    return host


def run_megastep_chunk(model, chunk: Chunk) -> dict:
    """One chunk launched and read back (JAX ``run_megastep_chunk``)."""
    return finish_megastep_chunk(model, launch_megastep_chunk(model, chunk))


def fit_epoch_megastep(model, batches) -> int:
    """One epoch of ``batches`` (JAX ``fit_epoch_megastep``): same-shaped
    minibatches buffered into blocks of ``model.megastep`` (the engines'
    ``_ds_scan_sig``), each block one chunk. A shorter block (the tail,
    or one cut by a change of shapes) runs per step, as in JAX: the
    trajectory is the same. One chunk stays in flight: the previous
    one is read back after the next is launched, so the host stages a
    chunk while the card runs the one before. Returns the minibatch
    count."""
    k = int(model.megastep)
    state = {"buf": [], "sig": None, "launched": None}

    def drain():
        if state["launched"] is not None:
            finish_megastep_chunk(model, state["launched"])
            state["launched"] = None

    def flush_megastep():
        buf, state["buf"] = state["buf"], []
        if len(buf) < k:
            drain()
            for ds in buf:
                model.fit_minibatch(ds)
            return
        launched = launch_megastep_chunk(model, model._stack_chunk(buf))
        drain()
        state["launched"] = launched

    n = 0
    try:
        for ds in batches:
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
    finally:
        drain()
    return n


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


def canonicalize_updater_state(model) -> None:
    """Bring a model whose updater state is in ZeRO-1's flat layout
    (``model._zero_layout = {"shards": n}``, set by the distributed
    trainer) back to parameter-shaped moments, in place. A collective
    on more than one rank: the engines' ``fit`` and a new trainer call
    it on every rank."""
    layout = getattr(model, "_zero_layout", None)
    if layout:
        model.updater_state = zero_gather_updater_state(
            model.updater_state, model.params, layout["shards"])
    model._zero_layout = None

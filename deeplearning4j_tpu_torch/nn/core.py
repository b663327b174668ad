"""The sequential forward, the score and the train step shared by the
network engines.

Counterpart of ``deeplearning4j_tpu/nn/core.py`` for the sequential
forward (inference and training), ``sequential_score`` with the L1/L2
penalty, and the plain train step (``grad_step`` + ``finish_step``,
assembled by ``build_step``). PyTorch runs eagerly, so the step is an
ordinary function that returns new parameters and updater state; the
JAX package's whole-net transforms (scan over layers, remat), its
guarded / loss-scaled / accumulated / megastep step flavours and the
conv->BatchNorm peephole have no counterpart yet (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

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


def sequential_forward(conf, layer_names: Sequence[str],
                       params: Dict[str, dict], state: Dict[str, dict],
                       x: torch.Tensor, *, train: bool = False,
                       gen: Optional[torch.Generator] = None,
                       preout: bool = False):
    """Forward through every layer of ``conf``; returns ``(y,
    new_state)``. ``y`` is the last layer's activation, or with
    ``preout`` its pre-activation when it carries a loss (what the
    score reads: the loss applies the activation in its stable form).
    With a ``compute_dtype`` the floating params and the input are cast
    to it first (mixed precision; gradients flow back through the cast
    to the stored params)."""
    cdt = compute_dtype_of(conf)
    if cdt != dtype_of(conf):
        params = {ln: {pn: (t.to(cdt) if t.is_floating_point() else t)
                       for pn, t in lp.items()}
                  for ln, lp in params.items()}
        x = x.to(cdt)
    new_state = dict(state)
    last = len(conf.layers) - 1
    for i, (name, layer) in enumerate(zip(layer_names, conf.layers)):
        if i in conf.preprocessors:
            x = conf.preprocessors[i].preprocess(x)
        x = x.contiguous()
        if preout and i == last and layer.has_loss():
            layer.check_train(train)
            return layer.pre_output(params[name], x), new_state
        x, new_state[name] = layer.apply(params[name], x,
                                         state.get(name, {}), train=train,
                                         gen=gen)
    return x, new_state


def sequential_score(conf, layer_names: Sequence[str],
                     params: Dict[str, dict], state: Dict[str, dict],
                     x: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     train: bool, gen: Optional[torch.Generator] = None):
    """Loss score plus the L1/L2 penalty (the reference's
    computeGradientAndScore adds calcL1/calcL2 to the loss); returns
    ``(score, new_state)``."""
    from deeplearning4j_tpu_torch.nn import losses

    last = conf.layers[-1]
    if not last.has_loss():
        raise ValueError(
            "Last layer has no loss function; use an OutputLayer/LossLayer")
    preout, new_state = sequential_forward(
        conf, layer_names, params, state, x, train=train, gen=gen,
        preout=True)
    score = losses.score(last.loss, labels, preout, last.activation, mask,
                         True)
    reg = 0.0
    for lname, layer in zip(layer_names, conf.layers):
        reg = reg + reg_penalty(layer, params[lname])
    return score + reg, new_state


def grad_step(score_fn: Callable, params, state, x, labels, mask):
    """The forward and backward of one step: ``((score, new_state),
    grads)`` of ``score_fn(params, state, x, labels, mask)``, with
    ``grads`` shaped like ``params``. The parameters are taken as fresh
    leaves, so the caller's tensors gain no graph."""
    leaves = {ln: {pn: t.detach().requires_grad_(True)
                   for pn, t in lp.items()}
              for ln, lp in params.items()}
    with torch.enable_grad():
        score, new_state = score_fn(leaves, state, x, labels, mask)
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


def finish_step(updater, grads, score, new_state, params, upd_state,
                lrs: Dict[str, float], t: int):
    """The post-gradient half: the updater rule on every parameter.
    Returns ``(params, upd_state, state, score)``. Unguarded and
    without loss scaling (those step flavours are not ported yet)."""
    new_params, new_upd = updater.update(grads, upd_state, params, lrs, t)
    return new_params, new_upd, new_state, score


def build_step(score_fn: Callable, updater) -> Callable:
    """One eager SGD-family train step: ``step(params, upd_state, state,
    x, labels, mask, lrs, t) -> (params, upd_state, state, score)``."""

    def step(params, upd_state, state, x, labels, mask, lrs, t):
        (score, new_state), grads = grad_step(score_fn, params, state, x,
                                              labels, mask)
        return finish_step(updater, grads, score, new_state, params,
                           upd_state, lrs, t)

    return step


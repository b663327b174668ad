"""Numeric gradient checking in float64 (reference
``GradientCheckUtil.java``, the backbone of its correctness suite).

Counterpart of ``deeplearning4j_tpu/nn/gradient_check.py``: central
differences of the network's score over its parameters, element by
element, against autograd's gradient of the same score, with the
reference's tolerances (``GradientCheckTests``: eps 1e-6, maxRelError
1e-3, minAbsError 1e-8). The analytic side is autograd through the
layers as they run, so the check holds the hand-written backwards of the
kernels' plain versions (``_ConvBlockFn``, ``_MatmulBlockFn``, the LSTM
cell's), the preprocessors, the losses and the masks together.

The check runs on an f64 copy of the model's parameters, state and
data on ``device`` ("cpu" by default). The JAX package pins its f64
check to the CPU where the TPU has no f64; here the reason is the
kernels': the hand-written CUDA kernels take f32, bf16 and f16, never
f64, while their plain versions sum f64 operands in f64. So the check
runs the plain versions on the CPU. Asked for ``"cuda"`` it builds the
copy on the card, and the first kernel it reaches raises (f64 is no
kernel dtype); it never moves to another device on its own.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.dispatch import resolve_device


@contextmanager
def f64_mode(device="cpu"):
    """The scope of an f64 computation on ``device`` (JAX ``f64_mode``):
    inside it torch's default floating dtype is f64, so a tensor a layer
    makes without a dtype is f64 too; the previous default is restored
    on exit. Yields the resolved ``torch.device``."""
    dev = resolve_device(device)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield dev
    finally:
        torch.set_default_dtype(prev)


def _to_f64(tree, dev):
    """Every floating tensor of a nested dict as an f64 copy on ``dev``
    (other tensors moved, anything else kept)."""
    if isinstance(tree, dict):
        return {k: _to_f64(v, dev) for k, v in tree.items()}
    if torch.is_tensor(tree):
        t = tree.detach().to(dev)
        return t.double() if t.is_floating_point() else t
    return tree


def _array_f64(a, dev):
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().to(dev, torch.float64)
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)


def check_gradients(model, x, labels, mask: Optional[np.ndarray] = None, *,
                    eps: float = 1e-6, max_rel_error: float = 1e-3,
                    min_abs_error: float = 1e-8,
                    max_per_param: Optional[int] = None,
                    print_results: bool = False, seed: int = 0,
                    train: bool = False,
                    features_mask: Optional[np.ndarray] = None,
                    rng_key=None, device="cpu") -> bool:
    """True when every checked element passes: its relative error at
    most ``max_rel_error`` or its absolute error at most
    ``min_abs_error``. ``max_per_param`` checks that many elements of a
    larger parameter, drawn with ``np.random.RandomState(seed)`` (None:
    every element). ``train`` scores the training-mode forward; a fixed
    ``rng_key`` then presents one frozen dropout / drop-connect mask to
    every evaluation. A ``MultiLayerNetwork`` (the JAX check's
    engine)."""
    if model.params is None:
        model.init()
    with f64_mode(device) as dev:
        params = _to_f64(model.params, dev)
        state = _to_f64(model.state, dev)
        x64, y64 = _array_f64(x, dev), _array_f64(labels, dev)
        m64, fm64 = _array_f64(mask, dev), _array_f64(features_mask, dev)

        def score(p) -> torch.Tensor:
            s, _ = model._score_pure(p, state, x64, y64, m64, train=train,
                                     fmask=fm64, rng=rng_key)
            return s

        leaves = {ln: {pn: t.clone().requires_grad_(t.is_floating_point())
                       for pn, t in lp.items()} for ln, lp in params.items()}
        order = model._flat_order()
        with torch.enable_grad():
            got = torch.autograd.grad(
                score(leaves), [leaves[ln][pn] for ln, pn in order],
                allow_unused=True)
        analytic = {
            key: (np.zeros(params[key[0]][key[1]].numel()) if g is None
                  else g.detach().cpu().numpy().ravel())
            for key, g in zip(order, got)}

        rng = np.random.RandomState(seed)
        checked = failed = 0
        with torch.no_grad():
            for ln, pn in order:
                base = params[ln][pn]
                n = base.numel()
                idxs = np.arange(n)
                if max_per_param is not None and n > max_per_param:
                    idxs = rng.choice(n, size=max_per_param, replace=False)
                flat = base.reshape(-1).cpu().numpy()
                for i in idxs:
                    side = []
                    for value in (flat[i] + eps, flat[i] - eps):
                        w = base.clone()
                        w.view(-1)[int(i)] = float(value)
                        lp = dict(params[ln])
                        lp[pn] = w
                        side.append(float(score({**params, ln: lp})))
                    numeric = (side[0] - side[1]) / (2.0 * eps)
                    a = float(analytic[(ln, pn)][i])
                    abs_err = abs(numeric - a)
                    denom = max(abs(numeric), abs(a))
                    rel_err = abs_err / denom if denom > 0 else 0.0
                    checked += 1
                    if rel_err > max_rel_error and abs_err > min_abs_error:
                        failed += 1
                        if print_results:
                            print(f"FAIL {ln}.{pn}[{i}]: analytic={a:.8g} "
                                  f"numeric={numeric:.8g} "
                                  f"relErr={rel_err:.4g}")
    if print_results:
        print(f"Gradient check: {checked - failed}/{checked} passed")
    return failed == 0

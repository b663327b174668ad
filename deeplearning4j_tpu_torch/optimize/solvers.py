"""The line-search solvers: LineGradientDescent, ConjugateGradient and
LBFGS with backtracking (Armijo) line search.

Counterpart of ``deeplearning4j_tpu/optimize/solvers.py`` (reference
``optimize/solvers/``: ``BackTrackLineSearch``, ``LBFGS``,
``ConjugateGradient``, ``LineGradientDescent``), selected by the
configuration's ``optimization_algo``. The parameters are one flat
vector in ``jax.flatten_util.ravel_pytree``'s order (the layer names
sorted, then each layer's parameter names sorted), so the LBFGS memory
and the CG direction are JAX's element for element. The score is the
engine's ``_score_pure(..., train=False)``; its gradient is autograd's,
through the layers' kernels on the card.

JAX runs each step as one XLA program, its Armijo loop a
``lax.while_loop``. Here the step's vector algebra stays on the device
and the loop is a host loop: each trial is one forward at ``p + alpha
d`` and one read of its 0-d Armijo flag, so a step makes as many host
syncs as the trials whose test it reads (at most
``max_num_line_search_iterations``; the last trial's test is not read,
the accepted ``alpha`` is a device select), and evaluates the trial
sequence JAX evaluates, stopping at the same ``alpha``. A step runs one
gradient (two for LBFGS: the new point's for the curvature pair) and
``1 + trials`` forwards; ``Solver.last_steps`` records each step's
backtracks and accepted ``alpha``.

As in the JAX package, the SGD-family updater and its learning-rate
schedule do not wrap these algorithms: the line search owns the step
size, with the first layer's ``learning_rate`` as the initial trial.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# LBFGS memory depth (the reference's LBFGS.java keeps 4)
LBFGS_MEMORY = 10

_ALGOS = ("LINE_GRADIENT_DESCENT", "CONJUGATE_GRADIENT", "LBFGS")


def is_solver_algo(algo: str) -> bool:
    return algo in _ALGOS


def backtrack_line_search(f, p, score0, grad, direction, initial_step,
                          max_iters: int = 5, c1: float = 1e-4,
                          rho: float = 0.5):
    """Armijo backtracking (reference ``BackTrackLineSearch``): shrink
    ``alpha`` by ``rho`` until ``f(p + alpha d) <= f(p) + c1 alpha
    (g·d)``, at most ``max_iters`` times. Returns ``(alpha, score,
    trials)``: ``alpha`` and ``score`` 0-d tensors (``alpha`` 0 and the
    score ``score0`` where no trial decreased enough), ``trials`` the
    backtracks taken (the forwards are ``1 + trials``)."""
    gd = torch.dot(grad, direction)
    alpha = torch.full((), float(initial_step), dtype=p.dtype,
                       device=p.device)

    def armijo_ok(alpha, score):
        return score <= score0 + c1 * alpha * gd

    score = f(p + alpha * direction)
    trials = 0
    while trials < max_iters and not bool(armijo_ok(alpha, score)):
        alpha = alpha * rho
        trials += 1
        score = f(p + alpha * direction)
    ok = armijo_ok(alpha, score)
    return (torch.where(ok, alpha, torch.zeros_like(alpha)),
            torch.where(ok, score, score0), trials)


class Solver:
    """Runs ``conf.iterations`` (or ``iterations``) steps of the
    configured algorithm on one batch (reference ``Solver`` +
    ``BaseOptimizer.optimize``). The LBFGS memory and the CG direction
    persist across ``optimize`` calls until ``reset_state()``."""

    def __init__(self, net):
        self.net = net
        algo = net.conf.optimization_algo
        if not is_solver_algo(algo):
            raise ValueError(
                f"Solver handles {_ALGOS}; '{algo}' uses the SGD path")
        self.algo = algo
        self.max_ls = int(getattr(net.conf, "max_num_line_search_iterations",
                                  5))
        if net.params is None:
            net.init()
        self._order = [(ln, pn) for ln in sorted(net.params)
                       for pn in sorted(net.params[ln])]
        self._shapes = [tuple(net.params[ln][pn].shape)
                        for ln, pn in self._order]
        first = net.params[self._order[0][0]][self._order[0][1]]
        self._n = sum(int(np.prod(s)) for s in self._shapes)
        self._dtype, self._device = first.dtype, first.device
        # ComputationGraph's _score_pure takes input/label/mask lists
        self._is_graph = hasattr(net.conf, "vertex_inputs")
        self.last_steps: List[dict] = []
        self.reset_state()

    # -- the flat view ------------------------------------------------------

    def ravel(self, params) -> torch.Tensor:
        return torch.cat([params[ln][pn].reshape(-1)
                          for ln, pn in self._order])

    def unravel(self, flat: torch.Tensor) -> dict:
        """``{layer: {param: tensor}}`` of a flat vector, each its own
        allocation (aligned for the kernels' vector loads), taken
        through autograd when ``flat`` requires it."""
        out = {ln: {} for ln in self.net.params}
        off = 0
        for (ln, pn), shape in zip(self._order, self._shapes):
            n = int(np.prod(shape))
            out[ln][pn] = flat[off:off + n].reshape(shape).clone()
            off += n
        return out

    def _score(self, flat, state, x, y, mask, fmask) -> torch.Tensor:
        params = self.unravel(flat)
        if self._is_graph:
            s, _ = self.net._score_pure(params, state, x, y, mask,
                                        train=False, fmasks=fmask)
        else:
            s, _ = self.net._score_pure(params, state, x, y, mask,
                                        train=False, fmask=fmask)
        return s

    def _value_and_grad(self, f, p) -> Tuple[torch.Tensor, torch.Tensor]:
        leaf = p.detach().requires_grad_(True)
        with torch.enable_grad():
            s = f(leaf)
            (g,) = torch.autograd.grad(s, leaf)
        return s.detach(), g

    # -- state --------------------------------------------------------------

    def reset_state(self) -> None:
        """Forget the LBFGS memory and the CG direction. The memory (two
        ``[LBFGS_MEMORY, n]`` buffers) is held only under LBFGS."""
        m, dev = LBFGS_MEMORY, self._device
        n = self._n if self.algo == "LBFGS" else 0
        self._s_mem = torch.zeros((m, n), dtype=self._dtype, device=dev)
        self._y_mem = torch.zeros((m, n), dtype=self._dtype, device=dev)
        self._rho_mem = torch.zeros((m,), dtype=self._dtype, device=dev)
        self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._prev_g = None
        self._prev_d = None

    def _initial_step(self) -> float:
        for s in self.net.updater_def.settings.values():
            return float(s.learning_rate)
        return 1.0

    # -- the steps ----------------------------------------------------------

    def _search(self, f, p, s, g, d, step0):
        alpha, new_s, trials = backtrack_line_search(
            f, p, s, g, d, step0, max_iters=self.max_ls)
        self.last_steps.append({"alpha": alpha, "trials": trials})
        return alpha, new_s

    def _lgd_step(self, f, p, step0):
        s, g = self._value_and_grad(f, p)
        alpha, new_s = self._search(f, p, s, g, -g, step0)
        return p - alpha * g, new_s

    def _cg_step(self, f, p, prev_g, prev_d, step0):
        """Polak-Ribière nonlinear CG with its restart (reference
        ``ConjugateGradient``'s beta)."""
        s, g = self._value_and_grad(f, p)
        beta = torch.dot(g, g - prev_g) / torch.clamp_min(
            torch.dot(prev_g, prev_g), 1e-30)
        beta = torch.clamp_min(beta, 0.0)  # restart where beta < 0
        d = -g + beta * prev_d
        # steepest descent where d is no descent direction
        d = torch.where(torch.dot(d, g) < 0, d, -g)
        alpha, new_s = self._search(f, p, s, g, d, step0)
        return p + alpha * d, g, d, new_s

    def _lbfgs_step(self, f, p, step0):
        """The two-loop recursion over a rolling memory of
        ``LBFGS_MEMORY`` pairs, slot i holding a pair where ``i >= m -
        min(count, m)`` (``valid``), as JAX's fixed-shape scan."""
        s, g = self._value_and_grad(f, p)
        s_mem, y_mem, rho_mem, count = (self._s_mem, self._y_mem,
                                        self._rho_mem, self._count)
        m = LBFGS_MEMORY
        filled = torch.clamp_max(count, m)

        def valid(i):
            return (i >= m - filled).to(p.dtype)

        q = g
        alphas = [None] * m
        for i in range(m - 1, -1, -1):
            a = valid(i) * rho_mem[i] * torch.dot(s_mem[i], q)
            q = q - a * y_mem[i]
            alphas[i] = a
        last = m - 1
        gamma = torch.where(
            count > 0,
            torch.dot(s_mem[last], y_mem[last])
            / torch.clamp_min(torch.dot(y_mem[last], y_mem[last]), 1e-30),
            torch.ones((), dtype=p.dtype, device=p.device))
        r = gamma * q
        for i in range(m):
            b = valid(i) * rho_mem[i] * torch.dot(y_mem[i], r)
            r = r + valid(i) * (alphas[i] - b) * s_mem[i]
        d = -r
        d = torch.where(torch.dot(d, g) < 0, d, -g)
        alpha, new_s = self._search(f, p, s, g, d, step0)
        new_p = p + alpha * d
        # roll the memory and append the new (s, y) pair where the
        # curvature condition holds
        s_vec = new_p - p
        y_vec = self._value_and_grad(f, new_p)[1] - g
        sy = torch.dot(s_vec, y_vec)
        ok = sy > 1e-10
        self._s_mem = torch.where(ok, torch.cat([s_mem[1:], s_vec[None]]),
                                  s_mem)
        self._y_mem = torch.where(ok, torch.cat([y_mem[1:], y_vec[None]]),
                                  y_mem)
        self._rho_mem = torch.where(
            ok, torch.cat([rho_mem[1:],
                           (1.0 / torch.clamp_min(sy, 1e-30))[None]]),
            rho_mem)
        self._count = count + ok.to(torch.int32)
        return new_p, new_s

    # -- the facade ---------------------------------------------------------

    def _as_tensors(self, x, y, mask, fmask):
        net = self.net

        def conv(v):
            return None if v is None else net._to_device(v, self._dtype)

        if not self._is_graph:
            return conv(x), conv(y), conv(mask), conv(fmask)

        def as_list(v):
            if v is None:
                return None
            return [conv(e) for e in
                    (v if isinstance(v, (list, tuple)) else [v])]
        return as_list(x), as_list(y), as_list(mask), as_list(fmask)

    def optimize(self, x, y, mask=None, fmask=None,
                 iterations: Optional[int] = None) -> torch.Tensor:
        """``iterations`` steps on one batch; returns the last accepted
        score (a 0-d tensor on the device). For a ComputationGraph
        ``x`` / ``y`` / ``mask`` / ``fmask`` may be lists (one entry an
        input or output); a single array is wrapped."""
        net = self.net
        x, y, mask, fmask = self._as_tensors(x, y, mask, fmask)
        state = net.state

        def f(q):
            return self._score(q, state, x, y, mask, fmask)

        p = self.ravel(net.params).detach()
        step0 = self._initial_step()
        iters = iterations or net.conf.iterations
        self.last_steps = []
        score = None
        with torch.no_grad():
            if self.algo == "LINE_GRADIENT_DESCENT":
                for _ in range(iters):
                    p, score = self._lgd_step(f, p, step0)
            elif self.algo == "CONJUGATE_GRADIENT":
                if self._prev_g is None:
                    self._prev_g = self._value_and_grad(f, p)[1]
                    self._prev_d = -self._prev_g
                for _ in range(iters):
                    p, self._prev_g, self._prev_d, score = self._cg_step(
                        f, p, self._prev_g, self._prev_d, step0)
            else:
                for _ in range(iters):
                    p, score = self._lbfgs_step(f, p, step0)
        net.params = self.unravel(p)
        net.iteration_count += iters
        net._last_score = score
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration_count)
        return score

"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe``
axis of ranks.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``, with one
stage a rank (one process a device). Each rank holds its own stage's
parameters; the schedule has ``n_micro + n_stages - 1`` ticks (fill,
steady state, drain): at each, stage 0 reads microbatch ``t`` (zeros
after the last), every stage applies ``stage_fn`` to what it holds and
hands its output to the next rank around the ring (the wrap link
carries what stage 0 never reads), and the last stage keeps microbatch
``t - (n_stages - 1)``. Its outputs are then summed over the ranks with
the others' masked to zero (JAX's masked ``psum``), so every rank gets
the pipeline's output. Every stage computes at every tick, as in JAX's
``lax.scan``.

Differentiable: each hop is ``sequence.RingHop`` (the backward hops
back, the transpose of ``ppermute``) and the masked sum's backward is
the identity (every rank's loss is the one replicated loss), so a
backward of a loss on the output leaves each rank its own stage's
gradient. ``train_step`` is that backward and a plain SGD update.

Constraint (JAX's): every stage maps ``[mb, d] -> [mb, d]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.sequence import RingHop
from deeplearning4j_tpu_torch.parallel.tensor_parallel import sum_group


@dataclass(frozen=True)
class PipeMesh:
    """The first ``n_stages`` ranks of the world as one pipeline: this
    rank's ``stage`` (None off the pipeline) and the pipe group (None in
    a world of one process)."""

    n_stages: int
    stage: Any
    group: Any = None
    axis_name: str = "pipe"

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.n_stages}


def build_pipe_mesh(n_stages: int, devices=None) -> PipeMesh:
    """A pipeline of ``n_stages`` ranks over the initialised world (JAX
    ``build_pipe_mesh``); every rank must call it. ``devices`` (a rank
    count) stands in for the world size."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    n = int(devices) if devices is not None else world
    if n < n_stages:
        raise ValueError(f"{n_stages} stages need >= {n_stages} devices, "
                         f"have {n}")
    rank = dist.get_rank() if initialised else 0
    group = (dist.new_group(list(range(n_stages)))
             if initialised and world > 1 else None)
    return PipeMesh(n_stages=int(n_stages),
                    stage=rank if rank < n_stages else None, group=group)


class _Tie(torch.autograd.Function):
    """``y`` unchanged, with what this rank computed and no stage reads
    kept in its graph (stage 0's received blocks: it reads the
    microbatches; a stage before the last's final output): the backward
    of every hop of the rank then runs, in the same order on every rank
    (reverse tick order), so the collectives meet, and the gradients
    from the stages after it reach its parameters."""

    @staticmethod
    def forward(ctx, y, *unread):
        ctx.shapes = [(u.shape, u.dtype, u.device) for u in unread]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.shapes))


class GPipe:
    """Stage-partitioned applier and trainer (the PP runtime):
    ``stage_fn(params, x) -> y`` applied by each rank to its stage's
    ``params`` (a dict of tensors)."""

    def __init__(self, mesh: PipeMesh, stage_fn: Callable,
                 n_micro: int = 4, axis_name: str = "pipe"):
        if axis_name != mesh.axis_name:
            raise ValueError(f"mesh has no axis {axis_name!r}")
        if mesh.stage is None:
            raise ValueError("this rank is off the pipeline")
        self.mesh = mesh
        self.stage_fn = stage_fn
        self.axis_name = axis_name
        self.n_stages = mesh.n_stages
        self.n_micro = int(n_micro)

    def shard_params(self, stage_params, device=None) -> dict:
        """This rank's stage of the ``[n_stages, ...]`` parameter dict
        (arrays or tensors), as tensors on ``device`` (default: the
        leaves' own, or the CPU for arrays)."""
        out = {}
        for k, a in stage_params.items():
            t = torch.as_tensor(a)
            out[k] = t[self.mesh.stage].clone().to(device or t.device)
        return out

    def _microbatch(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % self.n_micro:
            raise ValueError(
                f"batch {b} not divisible by n_micro={self.n_micro}")
        return x.reshape(self.n_micro, b // self.n_micro, *x.shape[1:])

    def apply(self, stage_params: dict, x) -> torch.Tensor:
        """Forward through the pipeline: ``x [batch, d] -> [batch, d]`` on
        every rank (every rank passes the same ``x``)."""
        dev = next(iter(stage_params.values())).device
        x = torch.as_tensor(x).to(dev)
        xs = self._microbatch(x)
        n, me, g = self.n_stages, self.mesh.stage, self.mesh.group
        total = self.n_micro + n - 1
        recv = torch.zeros_like(xs[0])
        outs, unread = [None] * self.n_micro, []
        for t in range(total):
            inp = ((xs[t] if t < self.n_micro else torch.zeros_like(xs[0]))
                   if me == 0 else recv)
            out = self.stage_fn(stage_params, inp)
            k = t - (n - 1)
            if me == n - 1 and 0 <= k < self.n_micro:
                outs[k] = out
            if n > 1 and t + 1 < total:
                recv = RingHop.apply(out, g, n, me)
                if me == 0:
                    unread.append(recv)
        if me == n - 1:
            y = torch.stack(outs)
        else:
            y = torch.zeros((self.n_micro, *xs.shape[1:-1], out.shape[-1]),
                            dtype=out.dtype, device=out.device)
            unread.append(out)  # the last tick's, which no stage reads
        if n > 1:
            if unread and torch.is_grad_enabled():
                y = _Tie.apply(y, *unread)
            y = sum_group(y, g)
        return y.reshape(x.shape[0], -1)

    def train_step(self, stage_params: dict, x, y, loss_fn: Callable,
                   lr: float = 0.01):
        """One SGD step of ``loss_fn(pipeline(x), y)``: returns the new
        stage parameters of this rank and the loss (the same on every
        rank)."""
        params = {k: p.detach().requires_grad_() for k, p in
                  stage_params.items()}
        out = self.apply(params, x)
        loss = loss_fn(out, torch.as_tensor(y).to(out.device))
        grads = torch.autograd.grad(loss, list(params.values()))
        new = {k: (p - lr * gr).detach()
               for (k, p), gr in zip(params.items(), grads)}
        return new, loss.detach()

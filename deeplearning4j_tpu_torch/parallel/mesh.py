"""The data-parallel world: process group bring-up and the mesh.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py`` for
``init_distributed``, ``init_distributed_elastic``, ``build_mesh``,
``shutdown_distributed``, ``reform_distributed`` and
``process_local_batch``. The JAX package drives every device of a host
from one process and lays them out as a ``jax.sharding.Mesh``; PyTorch's
idiom is one process a device, so here a mesh is the data-parallel group
of the initialised ``torch.distributed`` world: one rank a process, one
card (or the CPU) a rank. ``init_distributed`` forms the world, NCCL
for a CUDA device and gloo for the CPU, through the rendezvous the
caller names (``file://`` or ``tcp://host:port``); a CUDA world whose
NCCL group cannot be formed raises, it never goes on over gloo. The
one exception is named by the caller: ``backend="gloo"`` with
``device="cuda"`` forms a gloo group over CUDA tensors (several ranks
on one card, which NCCL refuses; gloo all-reduces and broadcasts CUDA
tensors but has no all-gather or reduce-scatter on them, so such a
world trains without ZeRO). Nothing picks it by itself.

With a budget (``timeout_s``, ``DL4J_TPU_INIT_TIMEOUT_S`` or a
``policy``) the bring-up is bounded and retried (the JAX package's
``init_distributed``): a ``tcp://`` rendezvous splits the budget over
the attempts, each a fresh store; a ``file://`` rendezvous gets one
attempt with the whole budget, because a failed attempt leaves its
counters in the file and a second one over it would not meet its
peers. The host-loss cycle is ``shutdown_distributed`` (the group is
aborted, never waited on: a dead peer cannot block it) and
``reform_distributed(plan)`` over the control plane's fresh rendezvous.

``build_mesh(data, model)`` lays the world out as the JAX package's
row-major ``reshape(data, model)``: rank ``r`` sits at ``(r // model, r
% model)``. Its ``data_group`` is the ranks that share its model index
(the gradient all-reduce's group), its ``model_group`` the ranks that
share its data index (tensor parallelism's gathers and sums,
``parallel/tensor_parallel.py``). Every rank forms every group, in one
order. On a gloo group of CUDA tensors a gather is the all-reduce of
zero-filled buffers (``row_exchange.stack_ranks``); on NCCL it is
``all_gather_into_tensor``: the choice follows the group's backend.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.exceptions import DL4JFaultException

logger = logging.getLogger(__name__)

# the device this process's world was formed for, whether the caller
# named its backend (the gloo-on-card exception), and its rendezvous
_world = {"device": None, "named_backend": False, "init_method": None}


@dataclass(frozen=True)
class Mesh:
    """The ``(data, model)`` layout of the world: ``data`` x ``model``
    ranks, this process's ``rank`` and ``device``, the collective
    ``backend`` (None for a world of one process that never formed a
    group: its collectives are the identity), and this rank's
    ``data_group`` / ``model_group`` (None: the default group, which is
    the axis's whole group where the other axis is 1)."""

    data: int
    rank: int
    device: torch.device
    backend: Optional[str]
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        """This rank's position on the data axis (its row shard)."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's position on the model axis (its weight shard)."""
        return self.rank % self.model


def _world_backend(dev: torch.device, backend: Optional[str]) -> str:
    """The collective backend of a world on ``dev``: NCCL on a card,
    gloo on the CPU, or the one the caller names (gloo on a card)."""
    if backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    backend = str(backend).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed: unsupported backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("init_distributed: NCCL needs device='cuda'")
    return backend


def init_distributed(init_method: str, world_size: int, rank: int, *,
                     device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None,
                     policy=None) -> torch.device:
    """Join the data-parallel world (the reference's Spark master /
    executor bring-up) through the rendezvous ``init_method``
    (``file:///path`` or ``tcp://host:port``). ``device="cuda"`` binds
    this rank to card ``rank % cards`` and forms an NCCL group (or a
    gloo one where ``backend="gloo"`` names it); ``"cpu"`` forms a gloo
    group. Returns the rank's device.

    ``timeout_s`` (or ``DL4J_TPU_INIT_TIMEOUT_S``) or a ``policy`` (a
    ``resilience.RetryPolicy``) bounds the bring-up with retries and a
    deadline (module docstring): a rank whose peers never come fails
    with a chained ``DL4JFaultException`` naming the rendezvous. Without
    a budget one attempt waits up to 300 s. A world already formed in
    this process raises at once, never retried."""
    if dist.is_initialized():
        raise DL4JFaultException(
            "init_distributed: torch.distributed is already initialized "
            "in this process; call shutdown_distributed() first")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is "
                               "available; pass device='cpu' for gloo")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"init_distributed: unsupported device {dev}")
    named = backend is not None
    backend = _world_backend(dev, backend)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    if timeout_s is None:
        env = os.environ.get("DL4J_TPU_INIT_TIMEOUT_S")
        timeout_s = float(env) if env else None

    def attempt(seconds: float) -> None:
        try:
            dist.init_process_group(
                backend, init_method=init_method,
                world_size=int(world_size), rank=int(rank),
                timeout=datetime.timedelta(seconds=seconds), **kwargs)
        except RuntimeError as e:
            if "twice" in str(e) or "already initialized" in str(e):
                raise DL4JFaultException(
                    "init_distributed: torch.distributed is already "
                    "initialized in this process; call "
                    "shutdown_distributed() before re-forming") from e
            # drop a half-built group so a retry starts clean
            shutdown_distributed()
            raise

    if timeout_s is None and policy is None:
        attempt(300.0)
    else:
        from deeplearning4j_tpu_torch.exceptions import (
            DeadlineExceededException,
            RetryExhaustedException,
        )
        from deeplearning4j_tpu_torch.resilience.retry import (
            RetryPolicy,
            retry_call,
        )

        if policy is None:
            policy = RetryPolicy(
                max_attempts=4, base_delay=0.5, multiplier=2.0,
                max_delay=5.0, retry_on=(OSError, TimeoutError, RuntimeError),
                total_timeout=timeout_s)
        budget = timeout_s if timeout_s is not None else 300.0
        if str(init_method).startswith("file://"):
            # a failed attempt leaves its counters in the file
            policy = RetryPolicy(
                max_attempts=1, retry_on=(OSError, TimeoutError,
                                          RuntimeError),
                total_timeout=budget)
            seconds = budget
        else:
            # split the budget so the LAST attempt still gets a slice
            seconds = max(1, int(math.ceil(budget / policy.max_attempts)))
        try:
            retry_call(attempt, seconds, policy=policy)
        except (RetryExhaustedException, DeadlineExceededException) as e:
            raise DL4JFaultException(
                f"init_distributed: rendezvous {init_method} did not form "
                f"a {int(world_size)}-process world within {budget}s: "
                "start every rank, or raise timeout_s / "
                "DL4J_TPU_INIT_TIMEOUT_S") from e
    _world.update(device=dev, named_backend=named,
                  init_method=str(init_method))
    return dev


def init_distributed_elastic(rendezvous: str, num_processes: int,
                             process_id: int, *,
                             device: Union[str, torch.device] = "cuda",
                             backend: Optional[str] = None,
                             timeout_s: float = 30.0,
                             policy=None) -> torch.device:
    """Survivor-safe bring-up for the cross-host control plane (JAX
    ``init_distributed_elastic``): a bounded, retried
    ``init_distributed`` over a control-plane rendezvous
    (``tcp://host:port``, a fresh port each term), three attempts by
    default. A world still formed in this process raises: call
    ``shutdown_distributed`` first. Pair with ``reform_distributed``
    for the teardown / re-formation cycle."""
    from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy

    policy = policy or RetryPolicy(
        max_attempts=3, base_delay=0.5, max_delay=3.0,
        retry_on=(OSError, TimeoutError, RuntimeError),
        total_timeout=timeout_s)
    return init_distributed(rendezvous, num_processes, process_id,
                            device=device, backend=backend,
                            timeout_s=timeout_s, policy=policy)


def _axis_groups(data: int, model: int):
    """``(data group, model group)`` of this rank: every rank forms every
    group of both axes, in one order (``dist.new_group`` is a collective
    of the whole world)."""
    rank = dist.get_rank()
    data_group = model_group = None
    for j in range(model):
        g = dist.new_group([i * model + j for i in range(data)])
        if rank % model == j:
            data_group = g
    for i in range(data):
        g = dist.new_group([i * model + j for j in range(model)])
        if rank // model == i:
            model_group = g
    return data_group, model_group


def build_mesh(data: Optional[int] = None, model: int = 1,
               device: Union[str, torch.device, None] = None) -> Mesh:
    """The ``(data, model)`` mesh over the initialised world (JAX
    ``build_mesh``: by default every rank on the ``data`` axis, the
    reference's only mode). Without an initialised world it is a mesh of
    this one process (``device``: the model's). ``data * model`` must
    equal the world size; rank ``r`` sits at ``(r // model, r %
    model)``. With ``model > 1`` every rank must call this (it forms the
    axes' groups)."""
    model = int(model)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        dev = _world["device"]
        if dev is None:
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if backend == "nccl" else torch.device("cpu"))
    else:
        world, rank, backend = 1, 0, None
        dev = torch.device("cpu" if device is None else device)
    if data is None:
        if world % model != 0:
            raise ValueError(f"{world} devices not divisible by "
                             f"model={model}")
        data = world // model
    data = int(data)
    if data * model != world:
        raise ValueError(f"data({data}) x model({model}) != world size "
                         f"({world}): one rank drives one device")
    groups = (_axis_groups(data, model) if model > 1 and backend
              else (None, None))
    return Mesh(data=data, rank=rank, device=dev, backend=backend,
                model=model, data_group=groups[0], model_group=groups[1])


def backend_named() -> bool:
    """True when the caller of ``init_distributed`` named the backend
    of this process's world (the gloo-on-card exception)."""
    return bool(_world["named_backend"]) and dist.is_initialized()


def world_rendezvous() -> Optional[str]:
    """The rendezvous this process's world was formed through (None
    without one)."""
    return _world["init_method"] if dist.is_initialized() else None


def shutdown_distributed() -> None:
    """Leave the world so this process can join another (host-loss
    re-formation). The group is aborted, not destroyed: a destroy may
    wait on a peer that died, an abort returns. Never raises."""
    _world.update(device=None, named_backend=False, init_method=None)
    if not (dist.is_available() and dist.is_initialized()):
        return
    from torch.distributed import distributed_c10d

    abort = getattr(distributed_c10d, "_abort_process_group", None)
    try:
        if abort is not None:
            abort()
        else:
            dist.destroy_process_group()
    except (RuntimeError, ValueError) as e:
        logger.warning("process group shutdown abandoned: %r", e)


def reform_distributed(plan, *, device: Union[str, torch.device] = "cuda",
                       backend: Optional[str] = None,
                       timeout_s: float = 30.0) -> Mesh:
    """One call from recovery plan to fresh mesh (JAX
    ``reform_distributed``): leave the old world, join the survivor set
    that ``plan`` names (a ``control_plane.RecoveryPlan`` or any object
    or dict with ``rendezvous`` / ``num`` / ``rank``) over its fresh
    rendezvous, and return the mesh of the new world."""
    if isinstance(plan, dict):
        get = plan.get
    else:
        def get(k, d=None):
            return getattr(plan, k, d)

    addr = get("rendezvous")
    if addr is None:
        raise DL4JFaultException(
            "reform_distributed: plan has no rendezvous address")
    num, rank = int(get("num")), int(get("rank"))
    shutdown_distributed()
    init_distributed_elastic(addr, num, rank, device=device,
                             backend=backend, timeout_s=timeout_s)
    return build_mesh(data=num)


def process_local_batch(global_batch: int, mesh: Mesh) -> int:
    """This process's share of a global batch: one rank drives one
    device, so ``global_batch // data``."""
    return int(global_batch) // mesh.data

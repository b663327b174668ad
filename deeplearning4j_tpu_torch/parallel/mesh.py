"""The data-parallel world: process group bring-up and the mesh.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py`` for
``init_distributed``, ``build_mesh``, ``shutdown_distributed`` and
``process_local_batch``. The JAX package drives every device of a host
from one process and lays them out as a ``jax.sharding.Mesh``; PyTorch's
idiom is one process a device, so here a mesh is the data-parallel group
of the initialised ``torch.distributed`` world: one rank a process, one
card (or the CPU) a rank. ``init_distributed`` forms the world, NCCL
for a CUDA device and gloo for the CPU, through the rendezvous the
caller names (``file://`` or ``tcp://host:port``); a CUDA world whose
NCCL group cannot be formed raises, it never goes on over gloo. Tensor
parallelism (a ``model`` axis above 1) is not in this slice.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.exceptions import DL4JFaultException


@dataclass(frozen=True)
class Mesh:
    """The data-parallel group: ``data`` ranks (the ``model`` axis is
    always 1), this process's ``rank`` and ``device``, and the collective
    ``backend`` (None for a world of one process that never formed a
    group: its collectives are the identity)."""

    data: int
    rank: int
    device: torch.device
    backend: Optional[str]

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": 1}


def init_distributed(init_method: str, world_size: int, rank: int, *,
                     device: Union[str, torch.device] = "cuda",
                     timeout_s: Optional[float] = None) -> torch.device:
    """Join the data-parallel world (the reference's Spark master /
    executor bring-up) through the rendezvous ``init_method``
    (``file:///path`` or ``tcp://host:port``). ``device="cuda"`` binds
    this rank to card ``rank % cards`` and forms an NCCL group; ``"cpu"``
    forms a gloo group. Returns the rank's device. Raises when the
    group cannot be formed within ``timeout_s`` (default 300 s) or is
    already formed."""
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
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: unsupported device {dev}")
    timeout = datetime.timedelta(seconds=300 if timeout_s is None
                                 else float(timeout_s))
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            timeout=timeout, **kwargs)
    return dev


def build_mesh(data: Optional[int] = None, model: int = 1,
               device: Union[str, torch.device, None] = None) -> Mesh:
    """The data-parallel mesh over the initialised world (all ranks on
    the ``data`` axis, the reference's only mode). Without an
    initialised world it is a mesh of this one process (``device``:
    the model's). ``data`` must equal the world size where given;
    ``model > 1`` raises (tensor parallelism is not in this slice)."""
    if int(model) != 1:
        raise NotImplementedError(
            "build_mesh: a model axis (tensor parallelism) is not ported "
            "yet (ROADMAP queue 1: the distribution slice's tensor "
            "parallelism)")
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if backend == "nccl" else torch.device("cpu"))
    else:
        world, rank, backend = 1, 0, None
        dev = torch.device("cpu" if device is None else device)
    if data is not None and int(data) != world:
        raise ValueError(f"data({data}) x model({model}) != world size "
                         f"({world}): one rank drives one device")
    return Mesh(data=world, rank=rank, device=dev, backend=backend)


def shutdown_distributed() -> None:
    """Leave the world so this process can join another. Never
    raises."""
    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except (RuntimeError, ValueError):
            pass


def process_local_batch(global_batch: int, mesh: Mesh) -> int:
    """This process's share of a global batch: one rank drives one
    device, so ``global_batch // data``."""
    return int(global_batch) // mesh.data

"""Parallel and distributed training (replaces the reference's
``parallelism/ParallelWrapper`` and ``deeplearning4j-scaleout/spark``
with ``torch.distributed``: one process a device, NCCL on the card,
gloo on the CPU), and sequence parallelism's materialized reference
attention (``sequence.attention``; ring attention arrives with a later
distribution slice, ROADMAP)."""

from deeplearning4j_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    init_distributed,
    process_local_batch,
    shutdown_distributed,
)
from deeplearning4j_tpu_torch.parallel.sequence import attention
from deeplearning4j_tpu_torch.parallel.trainer import DistributedTrainer
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

__all__ = ["DistributedTrainer", "Mesh", "ParallelWrapper", "attention",
           "build_mesh", "init_distributed", "process_local_batch",
           "shutdown_distributed"]

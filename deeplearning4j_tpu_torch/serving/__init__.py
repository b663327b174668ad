"""Model serving: ``ModelServer`` with admission control, deadlines and
micro-batching onto padded row buckets."""

from deeplearning4j_tpu_torch.serving.batcher import (
    BucketLadder,
    MicroBatcher,
    fill_chunks,
    pad_rows,
)
from deeplearning4j_tpu_torch.serving.server import ModelServer

__all__ = ["BucketLadder", "MicroBatcher", "ModelServer", "fill_chunks",
           "pad_rows"]

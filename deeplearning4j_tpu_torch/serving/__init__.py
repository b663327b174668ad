"""Model serving: ``ModelServer`` (admission control, deadlines,
micro-batching onto padded row buckets, named tenants with weight
paging, hot reload, the breaker, the AOT bundle) and the
``ServingRouter`` in front of several servers."""

from deeplearning4j_tpu_torch.serving.batcher import (
    BucketLadder,
    MicroBatcher,
    fill_chunks,
    pad_rows,
)
from deeplearning4j_tpu_torch.serving.compile_cache import (
    CompileCache,
    ModelShapes,
    jit_cache_size,
)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelEntry,
    ModelRegistry,
    ModelVersion,
    page_in_model,
    page_out_model,
)
from deeplearning4j_tpu_torch.serving.router import ServingRouter
from deeplearning4j_tpu_torch.serving.server import ModelServer

__all__ = ["BucketLadder", "CompileCache", "MicroBatcher", "ModelEntry",
           "ModelRegistry", "ModelServer", "ModelShapes", "ModelVersion",
           "ServingRouter", "fill_chunks", "jit_cache_size", "pad_rows",
           "page_in_model", "page_out_model"]

"""Parallel and distributed training (replaces the reference's
``parallelism/ParallelWrapper`` and ``deeplearning4j-scaleout/spark``
with ``torch.distributed``: one process a device, NCCL on the card,
gloo on the CPU), the elastic control plane (``control_plane.py``:
lease coordinator, worker agents) and elastic training
(``elastic.py``: the snapshot ring, survivor-world recovery), the
cluster NLP trainers (``cluster_nlp.py``: a batch split over the
ranks, its row gradients folded whole on every rank), the cluster
training SPI (``cluster.py``: the parameter-averaging master over
``ParallelWrapper``), tensor parallelism (``tensor_parallel.py``, under
``DistributedTrainer(tensor_parallel=True)``), sequence parallelism
(``sequence.py``: ring attention over a ``seq`` axis) and the GPipe
pipeline (``pipeline.py``)."""

from deeplearning4j_tpu_torch.parallel import tensor_parallel
from deeplearning4j_tpu_torch.parallel.cluster import (
    ClusterComputationGraph,
    ClusterDl4jMultiLayer,
    ParameterAveragingTrainingMaster,
    ParameterAveragingTrainingMasterStats,
    PathDataSetIterator,
    TrainingHook,
    TrainingMaster,
    TrainingWorker,
    batch_and_export_datasets,
)
from deeplearning4j_tpu_torch.parallel.control_plane import (
    ControlPlaneException,
    CoordinatorLostException,
    HostFencedException,
    LeaseCoordinator,
    LeaseState,
    LocalTransport,
    RecoveryPlan,
    TcpTransport,
    WorkerAgent,
)
from deeplearning4j_tpu_torch.parallel.dispatch import AsyncDispatchWindow
from deeplearning4j_tpu_torch.parallel.elastic import (
    DeviceLostException,
    ElasticTrainer,
    HeartbeatMonitor,
    HostElasticTrainer,
    SnapshotRing,
    StragglerDetector,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    init_distributed,
    init_distributed_elastic,
    process_local_batch,
    reform_distributed,
    shutdown_distributed,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    GPipe,
    build_pipe_mesh,
)
from deeplearning4j_tpu_torch.parallel.sequence import (
    attention,
    build_seq_mesh,
    ring_attention,
    ring_self_attention_sharded,
)
from deeplearning4j_tpu_torch.parallel.trainer import DistributedTrainer
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

__all__ = ["AsyncDispatchWindow", "ClusterComputationGraph",
           "ClusterDl4jMultiLayer", "ClusterGlove", "ClusterSequenceVectors",
           "ClusterWord2Vec", "ControlPlaneException",
           "CoordinatorLostException", "DeviceLostException",
           "DistributedTrainer", "ElasticTrainer", "GPipe",
           "HeartbeatMonitor", "HostElasticTrainer", "HostFencedException",
           "LeaseCoordinator", "LeaseState", "LocalTransport", "Mesh",
           "ParallelWrapper", "ParameterAveragingTrainingMaster",
           "ParameterAveragingTrainingMasterStats", "PathDataSetIterator",
           "RecoveryPlan", "SnapshotRing", "StragglerDetector",
           "TcpTransport", "TrainingHook", "TrainingMaster",
           "TrainingWorker", "WorkerAgent", "attention",
           "batch_and_export_datasets", "build_mesh", "build_pipe_mesh",
           "build_seq_mesh", "init_distributed", "init_distributed_elastic",
           "process_local_batch", "reform_distributed", "ring_attention",
           "ring_self_attention_sharded", "shutdown_distributed",
           "tensor_parallel", "TextPipeline"]

# the cluster NLP trainers import nlp/, which imports the kernels, whose
# attention imports this package: resolved at first use
_CLUSTER_NLP = ("ClusterGlove", "ClusterSequenceVectors", "ClusterWord2Vec",
                "TextPipeline")


def __getattr__(name):
    if name in _CLUSTER_NLP:
        from deeplearning4j_tpu_torch.parallel import cluster_nlp

        return getattr(cluster_nlp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

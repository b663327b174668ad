"""Cluster-scale training SPI (reference ``dl4j-spark``:
``SparkDl4jMultiLayer.java:77``, ``TrainingMaster`` SPI
``spark/api/TrainingMaster.java:29``, ``TrainingWorker``
``spark/api/TrainingWorker.java:21``,
``ParameterAveragingTrainingMaster.java:74`` and its split sizing
``:319-330``, export-based training
``spark/data/BatchAndExportDataSetsFunction.java``, distributed eval
``spark/impl/multilayer/evaluation/EvaluateFlatMapFunction.java:41``,
phase stats ``ParameterAveragingTrainingMasterStats.java``).

Counterpart of ``deeplearning4j_tpu/parallel/cluster.py`` on the port's
``ParallelWrapper``: the replicas are copies of the model's trees on
its device (or the master's ``mesh``'s), stepped one after another by the model's own train step and averaged on
the model's device every ``averaging_frequency`` rounds. The Spark-side
SPI shape (master/worker split, averaging frequency, splits over the
dataset, per-phase stats) is the JAX package's, and so are the exported
``.npz`` minibatch files (``DataSet.save_npz``): each package reads the
other's. Multi-process scale-out is ``parallel.mesh.init_distributed``
with ``DistributedTrainer``.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


# ---------------------------------------------------------------------------
# SPI
# ---------------------------------------------------------------------------


class TrainingWorker:
    """Worker-side SPI (reference ``TrainingWorker.java:21``): how one
    executor steps a model replica. ``ParallelWrapper``'s replica step
    plays this role; the class exists as the extension seam for custom
    worker logic (hooks, stats)."""

    def get_initial_model(self, master: "TrainingMaster"):
        return master.model

    def process_minibatch(self, ds: DataSet, model, is_last: bool):
        raise NotImplementedError

    def get_final_result(self, model):
        raise NotImplementedError


class TrainingHook:
    """Pre/post-update hook SPI (reference
    ``spark/api/TrainingHook.java`` — the parameter-server module stubs
    this; kept for the same extension point)."""

    def pre_update(self, ds: DataSet, model) -> None:
        pass

    def post_update(self, ds: DataSet, model) -> None:
        pass


class TrainingMaster:
    """Master-side SPI (reference ``TrainingMaster.java:29``)."""

    def execute_training(self, net, data) -> None:
        raise NotImplementedError

    def get_training_stats(self):
        return None


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------


class ParameterAveragingTrainingMasterStats:
    """Per-phase wall-clock timing (reference
    ``ParameterAveragingTrainingMasterStats.java`` — logFitStart/
    logSplitStart/logAggregateStartTime bracketing)."""

    def __init__(self):
        self.fit_times_ms: List[float] = []
        self.split_times_ms: List[float] = []
        self.aggregate_times_ms: List[float] = []

    def as_dict(self) -> dict:
        def stats(v):
            return {
                "count": len(v),
                "total_ms": float(np.sum(v)) if v else 0.0,
                "mean_ms": float(np.mean(v)) if v else 0.0,
            }
        return {
            "fit": stats(self.fit_times_ms),
            "split": stats(self.split_times_ms),
            "aggregate": stats(self.aggregate_times_ms),
        }


class _Timer:
    def __init__(self, sink: List[float]):
        self.sink = sink

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.sink.append((time.perf_counter() - self.t0) * 1000.0)


# ---------------------------------------------------------------------------
# ParameterAveragingTrainingMaster
# ---------------------------------------------------------------------------


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous periodic parameter averaging (reference
    ``ParameterAveragingTrainingMaster.java``). Splits the dataset
    into splits of ``workers * batch_size * averaging_frequency``
    examples (``getNumDataSetObjectsPerSplit`` math ``:319-330``),
    each split trains ``averaging_frequency`` minibatches per worker
    and averages params (+ updater state per ``saveUpdater``).
    The replicas live on the model's device, or on ``mesh``'s (a
    ``parallel.Mesh``)."""

    def __init__(self, workers: int = 2, batch_size_per_worker: int = 16,
                 averaging_frequency: int = 1, save_updater: bool = True,
                 prefetch_num_batches: int = 2,
                 collect_training_stats: bool = False,
                 mesh=None):
        self.workers = workers
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = max(int(averaging_frequency), 1)
        self.save_updater = save_updater
        self.prefetch_num_batches = prefetch_num_batches
        self.collect_training_stats = collect_training_stats
        self.mesh = mesh
        self.stats = (
            ParameterAveragingTrainingMasterStats()
            if collect_training_stats else None
        )
        self.model = None

    class Builder:
        """Reference ``ParameterAveragingTrainingMaster.Builder``."""

        def __init__(self, workers_or_examples: int = 2):
            self._workers = workers_or_examples
            self._batch = 16
            self._avg = 1
            self._save_updater = True
            self._prefetch = 2
            self._stats = False
            self._mesh = None

        def batch_size_per_worker(self, n):
            self._batch = n; return self

        def averaging_frequency(self, n): self._avg = n; return self
        def save_updater(self, b): self._save_updater = b; return self
        def worker_prefetch_num_batches(self, n):
            self._prefetch = n; return self

        def collect_training_stats(self, b): self._stats = b; return self
        def mesh(self, m): self._mesh = m; return self

        def build(self) -> "ParameterAveragingTrainingMaster":
            return ParameterAveragingTrainingMaster(
                workers=self._workers, batch_size_per_worker=self._batch,
                averaging_frequency=self._avg,
                save_updater=self._save_updater,
                prefetch_num_batches=self._prefetch,
                collect_training_stats=self._stats, mesh=self._mesh,
            )

    # -- split plumbing --------------------------------------------------

    def num_examples_per_split(self) -> int:
        """Reference ``getNumDataSetObjectsPerSplit``: one split feeds
        every worker ``averaging_frequency`` batches."""
        return (
            self.workers * self.batch_size_per_worker
            * self.averaging_frequency
        )

    def _batches_of(self, ds: DataSet):
        """Slice one big DataSet into worker minibatches, masks
        included; the tail remainder becomes a final smaller batch
        (nothing is silently dropped)."""
        b = self.batch_size_per_worker
        n = ds.num_examples()

        def cut(a, i):
            return None if a is None else np.asarray(a)[i:i + b]

        return [
            DataSet(
                features=cut(ds.features, i), labels=cut(ds.labels, i),
                features_mask=cut(ds.features_mask, i),
                labels_mask=cut(ds.labels_mask, i),
            )
            for i in range(0, n, b)
        ]

    def _batches_of_multi(self, mds):
        """Slice one big MultiDataSet into worker minibatches, every
        input/label/mask slot included."""
        from deeplearning4j_tpu_torch.datasets.api import MultiDataSet

        b = self.batch_size_per_worker
        n = mds.num_examples()

        def cuts(group, i):
            if group is None:
                return None
            return [
                None if a is None else np.asarray(a)[i:i + b]
                for a in group
            ]

        return [
            MultiDataSet(
                features=cuts(mds.features, i),
                labels=cuts(mds.labels, i),
                features_masks=cuts(mds.features_masks, i),
                labels_masks=cuts(mds.labels_masks, i),
            )
            for i in range(0, n, b)
        ]

    # -- TrainingMaster --------------------------------------------------

    def execute_training(self, net, data) -> None:
        """``data``: a DataSetIterator, an iterable of DataSets, or one
        big DataSet (the RDD analog). Batches are dealt round-robin to
        workers (the balanced-repartition step,
        ``SparkUtils.repartition``), each averaging round consumes
        ``workers × averaging_frequency`` of them."""
        self.model = net
        wrapper = ParallelWrapper(
            net, workers=self.workers,
            averaging_frequency=self.averaging_frequency,
            average_updaters=self.save_updater,
            prefetch_buffer=self.prefetch_num_batches,
            devices=None if self.mesh is None else [self.mesh.device],
        )
        batches = self._as_batches(data)
        timer = (
            _Timer(self.stats.fit_times_ms) if self.stats
            else _nulltimer
        )
        # every batch in a round must share a shape AND mask presence (as
        # in the JAX master): group by (size, which
        # masks exist) — iterator input can carry several distinct
        # off-sizes plus masked/unmasked mixes — and fit once per
        # uniform group, full-size groups first.
        def mask_sig(b):
            def sig_of(group, single):
                g = getattr(b, group, None)
                if g is not None:
                    return tuple(m is not None for m in g)  # per slot
                return (getattr(b, single, None) is not None,)

            return (
                sig_of("features_masks", "features_mask"),
                sig_of("labels_masks", "labels_mask"),
            )

        by_size: dict = {}
        for b in batches:
            by_size.setdefault(
                (b.num_examples(), mask_sig(b)), []
            ).append(b)
        ordered = sorted(
            by_size.items(),
            key=lambda kv: (kv[0][0] != self.batch_size_per_worker,
                            kv[0]),
        )
        with timer:
            for _, group in ordered:
                wrapper.fit(_ListIterator(group))

    def _as_batches(self, data) -> List[DataSet]:
        timer = (
            _Timer(self.stats.split_times_ms) if self.stats
            else _nulltimer
        )
        from deeplearning4j_tpu_torch.datasets.api import MultiDataSet

        with timer:
            if isinstance(data, DataSet):
                return self._batches_of(data)
            if isinstance(data, MultiDataSet):
                return self._batches_of_multi(data)
            return list(iter(data))

    def get_training_stats(self):
        return self.stats


class _NullTimer:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_nulltimer = _NullTimer()


class _ListIterator(DataSetIterator):
    def __init__(self, batches: List[DataSet]):
        self._batches = batches
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._batches)

    def next(self) -> DataSet:
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def reset(self) -> None:
        self._pos = 0


# ---------------------------------------------------------------------------
# SparkDl4jMultiLayer analog
# ---------------------------------------------------------------------------


class _ClusterModelFacade:
    """Shared driver-side facade plumbing: fit over in-memory data
    (``fit(JavaRDD)`` analog), fit over exported batch files
    (``fitPaths``), sharded evaluation (per-shard delegation to the
    engine's own ``evaluate`` + ``Evaluation.merge`` — reference
    ``EvaluateFlatMapFunction.java:41`` + ``EvaluationReduceFunction``),
    scoring."""

    def __init__(self, net, training_master: TrainingMaster):
        self.net = net
        self.training_master = training_master

    def fit(self, data) -> None:
        self.training_master.execute_training(self.net, data)

    def fit_paths(self, paths: Iterable[str]) -> None:
        """Train from exported minibatch files (reference export-based
        path ``fitPaths:265``)."""
        self.training_master.execute_training(
            self.net, PathDataSetIterator(list(paths))
        )

    def evaluate(self, data, num_shards: Optional[int] = None):
        from deeplearning4j_tpu_torch.eval import Evaluation

        batches = (
            data if isinstance(data, list) else list(iter(data))
        )
        n = num_shards or getattr(self.training_master, "workers", 1)
        shards: List[list] = [[] for _ in range(max(n, 1))]
        for i, b in enumerate(batches):
            shards[i % len(shards)].append(b)
        merged: Optional[Evaluation] = None
        for shard in shards:
            if not shard:
                continue
            e = self.net.evaluate(iter(shard))
            merged = e if merged is None else merged.merge(e)
        return merged if merged is not None else Evaluation()

    def get_score(self, ds) -> float:
        return float(self.net.score(ds))


class ClusterDl4jMultiLayer(_ClusterModelFacade):
    """MultiLayerNetwork + TrainingMaster (reference
    ``SparkDl4jMultiLayer.java:77``)."""


class ClusterComputationGraph(_ClusterModelFacade):
    """ComputationGraph + TrainingMaster (reference
    ``SparkComputationGraph.java:156-182``). Data is DataSets or
    MultiDataSets — the replica step maps over the input/label list
    pytree."""


# ---------------------------------------------------------------------------
# Export-based data path
# ---------------------------------------------------------------------------


def batch_and_export_datasets(iterator, export_dir: str,
                              prefix: str = "dataset") -> List[str]:
    """Save every minibatch as an .npz file; returns paths (reference
    ``BatchAndExportDataSetsFunction`` — saves minibatch files so
    training can stream from storage instead of RAM)."""
    os.makedirs(export_dir, exist_ok=True)
    paths = []
    for i, ds in enumerate(iter(iterator)):
        path = os.path.join(export_dir, f"{prefix}_{i:06d}.npz")
        ds.save_npz(path)
        paths.append(path)
    return paths


class PathDataSetIterator(DataSetIterator):
    """Stream DataSets from exported .npz paths (reference
    ``spark/iterator/PathSparkDataSetIterator``)."""

    def __init__(self, paths: List[str]):
        if isinstance(paths, str):
            paths = sorted(glob.glob(os.path.join(paths, "*.npz")))
        self.paths = list(paths)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.paths)

    def next(self) -> DataSet:
        ds = DataSet.load_npz(self.paths[self._pos])
        self._pos += 1
        return ds

    def reset(self) -> None:
        self._pos = 0

"""Early stopping engine (reference: ``earlystopping/*`` — 20 files;
the trainer loop mirrors ``earlystopping/trainer/
BaseEarlyStoppingTrainer.java``: per-epoch fit, score on a holdout,
track best model, stop on epoch/iteration termination conditions,
persist via a model saver).

Counterpart of ``deeplearning4j_tpu/earlystopping/core.py``: the same
conditions, calculator, savers and loop over the port's engines, its
``ParallelWrapper`` and preemption check. ``LocalFileModelSaver``
restores onto the device of the model it saved. The cluster flavour
runs each epoch through a ``parallel/cluster.py`` training master."""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np


# -- termination conditions (reference earlystopping/termination/*) -----


class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no improvement (reference class of the
    same name)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = math.inf
        self.since = 0

    def initialize(self) -> None:
        self.best = math.inf
        self.since = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if score < self.best - self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        # Reference terminates once exactly `patience` evaluations pass
        # with no improvement (ScoreImprovementEpochTerminationCondition
        # .java:66: epochNum >= bestEpoch + maxEpochsWithNoImprovement)
        return self.since >= self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at/below a target."""

    def __init__(self, best_expected_score: float):
        self.target = best_expected_score

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.target


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self) -> None:
        self._start = time.time()

    def terminate(self, last_score: float) -> bool:
        return (time.time() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the score explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score: float) -> bool:
        return last_score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score: float) -> bool:
        return math.isnan(last_score) or math.isinf(last_score)


# -- score calculators (reference earlystopping/scorecalc) --------------


class DataSetLossCalculator:
    """Average loss over a DataSetIterator (reference
    ``DataSetLossCalculator``). Works for both model types."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        from deeplearning4j_tpu_torch.datasets.api import ChunkedDataSet

        total, n = 0.0, 0
        for ds in self.iterator:
            if isinstance(ds, ChunkedDataSet):
                # score() consumes single minibatches; unstack
                batches = ds.to_datasets()
            else:
                batches = [ds]
            for b in batches:
                # weight each batch by its example count (reference
                # DataSetLossCalculator.java:36-41: lossSum += score*nEx)
                if hasattr(b, "num_examples"):
                    n_ex = b.num_examples()
                else:
                    n_ex = int(np.shape(b.features)[0])
                total += model.score(b) * n_ex
                n += n_ex
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        if n == 0:
            return float("nan")
        return total / n if self.average else total


# -- model savers (reference earlystopping/saver) -----------------------


class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score: float) -> None:
        self._best = model.copy() if hasattr(model, "copy") else model

    def save_latest_model(self, model, score: float) -> None:
        self._latest = model.copy() if hasattr(model, "copy") else model

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """Zip checkpoints in a directory (reference ``LocalFileModelSaver``
    writes bestModel.bin / latestModel.bin).

    Saves are atomic: ``write_model`` stages to a temp file in the
    same directory and ``os.replace``s it over bestModel.zip /
    latestModel.zip, so a crash mid-save never clobbers the last good
    checkpoint with a truncated zip."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # where get_*_model restores: the device of the model saved
        self._device = None

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "bestModel.zip")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latestModel.zip")

    def _write(self, model, path: str) -> None:
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_model,
        )

        self._device = model.device
        write_model(model, path)

    def _read(self, path: str):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model,
        )

        return restore_model(path, device=self._device)

    def save_best_model(self, model, score: float) -> None:
        self._write(model, self.best_path)

    def save_latest_model(self, model, score: float) -> None:
        self._write(model, self.latest_path)

    def get_best_model(self):
        return self._read(self.best_path)

    def get_latest_model(self):
        return self._read(self.latest_path)


# -- configuration + result (reference EarlyStoppingConfiguration) ------


@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any
    epoch_terminations: List[EpochTerminationCondition] = field(
        default_factory=list
    )
    iteration_terminations: List[IterationTerminationCondition] = field(
        default_factory=list
    )
    model_saver: Any = None
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False
    # resilience.CheckpointManager: when set, every trained epoch is
    # checkpointed (atomic + versioned + CRC-manifested), so an
    # early-stopping run survives preemption and resumes via
    # model.resume(manager) — best/latest saver semantics unchanged.
    checkpoint_manager: Any = None

    def __post_init__(self):
        if self.model_saver is None:
            self.model_saver = InMemoryModelSaver()


@dataclass
class EarlyStoppingResult:
    termination_reason: str  # EpochTerminationCondition name etc.
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: Any


# -- trainer (reference earlystopping/trainer) --------------------------


class EarlyStoppingTrainer:
    """Reference ``EarlyStoppingTrainer`` (MultiLayerNetwork flavor);
    ``EarlyStoppingGraphTrainer`` below for graphs — the loop is
    identical."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator

    def _train_epoch(self):
        """One epoch; returns the tripped iteration-termination
        condition or None. Subclasses replace the training mechanics
        (parallel wrapper / cluster master) but share the loop."""
        from deeplearning4j_tpu_torch.resilience import preemption

        cfg = self.config
        for ds in self.train_iterator:
            # preemption notice -> emergency checkpoint (the per-epoch
            # manager if configured, else the handler's) + raise
            preemption.check_fit(self.model,
                                 manager=cfg.checkpoint_manager)
            self.model.fit_minibatch(ds)
            for c in cfg.iteration_terminations:
                if c.terminate(self.model.score_value):
                    return c
        return None

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_terminations:
            c.initialize()
        for c in cfg.iteration_terminations:
            c.initialize()
        best_score = math.inf
        best_epoch = -1
        scores: dict = {}
        epoch = 0
        reason, details = "MaxEpochs", "exhausted"
        from deeplearning4j_tpu_torch.resilience import preemption

        while True:
            # epoch boundary check covers subclasses whose
            # _train_epoch replaces the minibatch loop
            preemption.check_fit(self.model,
                                 manager=cfg.checkpoint_manager)
            stop_iter = self._train_epoch()
            if hasattr(self.train_iterator, "reset"):
                self.train_iterator.reset()
            if cfg.checkpoint_manager is not None:
                # per-epoch preemption point: versioned checkpoint of
                # the in-training model (distinct from best/latest,
                # which track the evaluation winner)
                cfg.checkpoint_manager.save(self.model)
            if stop_iter is not None:
                reason = "IterationTerminationCondition"
                details = type(stop_iter).__name__
                break
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
                scores[epoch] = score
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best_model(self.model, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.model, score)
                stop_epoch = None
                for c in cfg.epoch_terminations:
                    if c.terminate(epoch, score):
                        stop_epoch = c
                        break
                if stop_epoch is not None:
                    reason = "EpochTerminationCondition"
                    details = type(stop_epoch).__name__
                    epoch += 1
                    break
            epoch += 1
        # best_epoch == -1 means no evaluation ever saved a best model
        # (e.g. NaN on the first minibatch) — don't ask the saver for a
        # file that was never written.
        best = (
            cfg.model_saver.get_best_model() if best_epoch >= 0 else None
        )
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            score_vs_epoch=scores,
            best_model=best if best is not None else self.model,
        )


class EarlyStoppingGraphTrainer(EarlyStoppingTrainer):
    """Reference ``EarlyStoppingGraphTrainer`` — same loop over a
    ComputationGraph."""


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over data-parallel replica training (reference
    ``parallelism/EarlyStoppingParallelTrainer.java`` — wraps
    ParallelWrapper instead of the single-model fit). Each epoch the
    wrapper deals the iterator's batches to replicas and averages;
    evaluation/termination runs on the synchronized model."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator, workers: int = 2,
                 averaging_frequency: int = 1):
        super().__init__(config, model, train_iterator)
        from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

        self.wrapper = ParallelWrapper(
            model, workers=workers,
            averaging_frequency=averaging_frequency,
        )

    def _train_epoch(self):
        self.wrapper.fit(self.train_iterator)
        for c in self.config.iteration_terminations:
            if c.terminate(self.model.score_value):
                return c
        return None


class ClusterEarlyStoppingTrainer(EarlyStoppingTrainer):
    """Early stopping over cluster training (reference
    ``spark/earlystopping/SparkEarlyStoppingTrainer.java``; JAX
    ``ClusterEarlyStoppingTrainer``): each epoch runs through the
    training master of ``parallel/cluster.py`` instead of per-batch
    fitting."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 training_master, train_data):
        super().__init__(config, net, train_data)
        self.training_master = training_master

    def _train_epoch(self):
        self.training_master.execute_training(
            self.model, self.train_iterator
        )
        for c in self.config.iteration_terminations:
            if c.terminate(self.model.score_value):
                return c
        return None

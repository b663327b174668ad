"""Early stopping (reference ``deeplearning4j-nn/.../earlystopping``:
``EarlyStoppingConfiguration`` + termination conditions + score
calculators + savers + ``EarlyStoppingTrainer``; counterpart of
``deeplearning4j_tpu/earlystopping/``)."""

from deeplearning4j_tpu_torch.earlystopping.core import (  # noqa: F401
    BestScoreEpochTerminationCondition,
    ClusterEarlyStoppingTrainer,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingGraphTrainer,
    EarlyStoppingParallelTrainer,
    EarlyStoppingResult,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    InvalidScoreIterationTerminationCondition,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)

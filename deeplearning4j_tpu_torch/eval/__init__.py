"""Evaluation (reference ``deeplearning4j-nn/.../eval``; counterpart of
``deeplearning4j_tpu/eval/``)."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
    Prediction,
    RegressionEvaluation,
)
from deeplearning4j_tpu_torch.eval.roc import (  # noqa: F401
    ROC,
    ROCMultiClass,
)

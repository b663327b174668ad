"""Training listeners (``optimize/listeners.py``)."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CollectScoresIterationListener,
    ComposableIterationListener,
    IterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ScoreIterationListener,
)

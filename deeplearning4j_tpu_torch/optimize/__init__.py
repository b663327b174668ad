"""Training listeners (``optimize/listeners.py``) and the profiler
listener (``optimize/profiler.py``)."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CollectScoresIterationListener,
    ComposableIterationListener,
    IterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.optimize.profiler import (  # noqa: F401
    ProfilerListener,
    annotate,
)

"""Training listeners (``optimize/listeners.py``), the profiler
listener (``optimize/profiler.py``) and the line-search solvers
(``optimize/solvers.py``)."""

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
from deeplearning4j_tpu_torch.optimize.solvers import (  # noqa: F401
    Solver,
    backtrack_line_search,
    is_solver_algo,
)

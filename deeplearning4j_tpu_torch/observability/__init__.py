"""The metrics registry (``metrics.py``) and the flight recorder
(``flightrec.py``) the training runtime publishes into."""

from deeplearning4j_tpu_torch.observability.flightrec import (  # noqa: F401
    FlightRecorder,
    get_flight_recorder,
    set_flight_recorder,
)
from deeplearning4j_tpu_torch.observability.metrics import (  # noqa: F401
    NULL_REGISTRY,
    Histogram,
    MetricsRegistry,
    Reservoir,
    array_histograms,
    default_registry,
    mean_magnitudes,
)

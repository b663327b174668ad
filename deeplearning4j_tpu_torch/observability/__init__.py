"""The observability subsystem of the training runtime and the server:
the metrics registry (``metrics.py``), structured tracing
(``trace.py``), the Prometheus and JSON exporters (``export.py``),
runtime telemetry (``runtime.py``: device memory, the
``TelemetryListener``), the step profiler (``profiler.py``: cost
model, MFU, the wall-time split) and the flight recorder
(``flightrec.py``)."""

from deeplearning4j_tpu_torch.observability.export import (  # noqa: F401
    prometheus_text,
    registry_snapshot,
)
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
    host_arrays,
    mean_magnitudes,
)
from deeplearning4j_tpu_torch.observability.profiler import (  # noqa: F401
    CostModel,
    CostModelCache,
    StepProfiler,
    get_active_profiler,
    set_active_profiler,
)
from deeplearning4j_tpu_torch.observability.runtime import (  # noqa: F401
    TelemetryListener,
    device_memory_stats,
    publish_device_memory,
)
from deeplearning4j_tpu_torch.observability.trace import (  # noqa: F401
    JsonlSink,
    Span,
    SpanContext,
    Tracer,
    get_tracer,
    set_global_tracer,
)

"""Observability / training UI (reference
``deeplearning4j-ui-parent``): StatsListener → StatsStorage → browser
UI, with a remote HTTP router.

Counterpart of ``deeplearning4j_tpu/ui``: the records and storage
(``model.py``, byte for byte the JAX package's encoding), the
component DSL (``components.py``), the stats and conv-activation
listeners (``stats_listener.py``, ``conv_listener.py``) and the server
with its remote router (``server.py``)."""

from deeplearning4j_tpu_torch.ui.model import (
    FileStatsStorage,
    InMemoryStatsStorage,
    StatsInitializationReport,
    StatsReport,
    StatsStorage,
    decode_record,
)
from deeplearning4j_tpu_torch.ui.server import (
    RemoteUIStatsStorageRouter,
    UIServer,
)
from deeplearning4j_tpu_torch.ui.stats_listener import (
    J7StatsListener,
    StatsListener,
)
from deeplearning4j_tpu_torch.ui.conv_listener import (
    ConvolutionalIterationListener,
)

__all__ = [
    "FileStatsStorage", "InMemoryStatsStorage",
    "StatsInitializationReport", "StatsReport", "StatsStorage",
    "decode_record", "RemoteUIStatsStorageRouter", "UIServer",
    "J7StatsListener", "StatsListener",
    "ConvolutionalIterationListener",
]

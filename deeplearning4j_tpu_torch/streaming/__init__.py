"""Streaming ingestion + model serving (reference ``dl4j-streaming``:
``streaming/kafka/NDArrayKafkaClient.java:1`` / ``NDArrayPublisher`` /
``NDArrayConsumer`` and the Camel model-serving route
``routes/DL4jServeRouteBuilder.java:1``).

Counterpart of ``deeplearning4j_tpu/streaming``."""

from deeplearning4j_tpu_torch.streaming.ndarray_stream import (  # noqa: F401
    NDArrayConsumer,
    NDArrayPublisher,
    StreamingDataSetIterator,
    decode_ndarray_message,
    encode_ndarray_message,
)
from deeplearning4j_tpu_torch.streaming.serve import (  # noqa: F401
    ModelServer,
)

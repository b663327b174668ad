"""Model-serving route (reference
``routes/DL4jServeRouteBuilder.java:1`` — a Camel route that loads a
``ModelSerializer`` checkpoint, transforms the incoming record and
predicts).

Counterpart of ``deeplearning4j_tpu/streaming/serve.py``: the route
grew into the serving tier (``deeplearning4j_tpu_torch/serving/``:
admission control, deadlines, circuit breaking, hot reload, graceful
drain, ``/readyz`` vs ``/healthz``, ``/metrics``), which this module
re-exports, so ``streaming.ModelServer`` is the serving tier's
``ModelServer`` with the same constructor surface (model-or-path,
host, port, transform, output_classes) and ``MAX_BODY`` its body cap.
"""

from deeplearning4j_tpu_torch.serving.server import (  # noqa: F401
    MAX_BODY,
    ModelServer,
)

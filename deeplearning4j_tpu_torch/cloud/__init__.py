"""Object storage (``storage.py``)."""

from deeplearning4j_tpu_torch.cloud.storage import (  # noqa: F401
    GcsObjectStore,
    LocalObjectStore,
    ObjectStore,
    S3ObjectStore,
    StorageDownloader,
    StorageUploader,
    object_store_for,
)

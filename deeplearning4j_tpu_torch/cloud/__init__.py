"""Cloud provisioning + object storage (reference:
``deeplearning4j-scaleout/deeplearning4j-aws`` — ``Ec2BoxCreator``,
``ClusterSetup``/``HostProvisioner``, ``S3Downloader``/``S3Uploader``,
``BaseS3DataSetIterator``).

Counterpart of ``deeplearning4j_tpu/cloud``: the provisioning plan
(``provision.py``, the JAX package's plan), the ObjectStore SPI with
its local-filesystem backend and the gated cloud-SDK ones
(``storage.py``), the dataset shards an object store holds
(``data.py``), and the resilience subsystem's ``RetryingObjectStore``,
re-exported as storage-facing API."""

from deeplearning4j_tpu_torch.cloud.provision import (  # noqa: F401
    ClusterSetup,
    HostProvisioner,
    TpuPodProvisioner,
)
from deeplearning4j_tpu_torch.cloud.storage import (  # noqa: F401
    GcsObjectStore,
    LocalObjectStore,
    ObjectStore,
    S3ObjectStore,
    StorageDownloader,
    StorageUploader,
    object_store_for,
)
from deeplearning4j_tpu_torch.cloud.data import (  # noqa: F401
    CloudDataSetIterator,
    save_dataset_shards,
)
# the retrying decorator lives in the resilience subsystem (it wraps the
# ObjectStore SPI, so it imports after .storage)
from deeplearning4j_tpu_torch.resilience.store import (  # noqa: F401
    RetryingObjectStore,
)

"""Object-store dataset iteration (reference:
``aws/s3/reader/BaseS3DataSetIterator.java`` — iterate serialized
DataSet objects straight out of a bucket — and the export-based
training path ``spark/data/BatchAndExportDataSetsFunction.java``,
which writes minibatch files a cluster later trains from).

Counterpart of ``deeplearning4j_tpu/cloud/data.py``. Shards use the
minibatch npz codec — ``DataSet.to_npz_bytes``/``from_npz_bytes``
(``datasets/api.py``), the JAX package's format — so shards written by
either package read back identically in the other.
``save_dataset_shards`` produces them, ``CloudDataSetIterator``
streams them back from any ``ObjectStore`` backend: export minibatches
once, train many times from storage."""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.cloud.storage import ObjectStore
from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator


def save_dataset_shards(batches, store: ObjectStore,
                        prefix: str = "dataset/") -> List[str]:
    """Export minibatches as numbered npz shards (the
    BatchAndExportDataSetsFunction analog). Returns the keys."""
    keys = []
    for i, ds in enumerate(batches):
        key = f"{prefix}shard-{i:06d}.npz"
        store.write(key, ds.to_npz_bytes())
        keys.append(key)
    return keys


class CloudDataSetIterator(DataSetIterator):
    """Stream DataSet shards from an object store
    (``BaseS3DataSetIterator`` analog). Keys are listed once at
    construction; ``reset()`` restarts the stream. Feed it to any
    ``fit(iterator)``, or wrap it in a ``datasets.PrefetchIterator`` to
    overlap the store reads with the device steps, as the reference
    wraps its S3 iterator."""

    def __init__(self, store: ObjectStore, prefix: str = "dataset/",
                 keys: Optional[List[str]] = None, retry=None):
        if retry is not None:
            # shard fetches run under bounded backoff (resilience
            # subsystem): a flaky read retries transparently instead of
            # killing the fit loop mid-epoch
            from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
            from deeplearning4j_tpu_torch.resilience.store import (
                RetryingObjectStore,
            )

            policy = RetryPolicy() if retry is True else retry
            if not isinstance(store, RetryingObjectStore):
                store = RetryingObjectStore(store, policy)
        self.store = store
        self._keys = list(keys) if keys is not None else store.keys(
            prefix
        )
        if not self._keys:
            raise ValueError(
                f"no dataset shards under prefix {prefix!r}"
            )
        self._pos = 0
        self._first: Optional[DataSet] = None

    def next(self) -> DataSet:
        ds = DataSet.from_npz_bytes(
            self.store.read(self._keys[self._pos])
        )
        self._pos += 1
        if self._first is None:
            self._first = ds
        return ds

    def has_next(self) -> bool:
        return self._pos < len(self._keys)

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        if self._first is None:
            self._first = DataSet.from_npz_bytes(
                self.store.read(self._keys[0])
            )
        return self._first.num_examples()

    def total_examples(self) -> int:
        return -1  # unknown without reading every shard

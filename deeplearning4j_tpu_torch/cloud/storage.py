"""Object storage SPI (reference ``aws/s3/reader/S3Downloader.java``,
``aws/s3/uploader/S3Uploader.java``).

Counterpart of ``deeplearning4j_tpu/cloud/storage.py``: one
``ObjectStore`` interface (list / open / read / write / download /
upload), ``LocalObjectStore`` over a directory, and the S3 and GCS
adapters, which import their SDK (boto3, google-cloud-storage) only
when constructed and raise an ``ImportError`` naming it where it is
missing. ``object_store_for(url)`` dispatches on ``s3://``, ``gs://``
or a local path; ``StorageDownloader`` / ``StorageUploader`` keep the
reference's call shape.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import IO, Iterator, List


class ObjectStore:
    """SPI: bucket-scoped object operations."""

    def keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def open(self, key: str) -> IO[bytes]:
        raise NotImplementedError

    def read(self, key: str) -> bytes:
        with self.open(key) as f:
            return f.read()

    def write(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def download(self, key: str, to_path) -> None:
        with self.open(key) as src, open(to_path, "wb") as dst:
            shutil.copyfileobj(src, dst)

    def upload(self, from_path, key: str) -> None:
        with open(from_path, "rb") as f:
            self.write(key, f.read())

    def iterate(self, prefix: str = "") -> Iterator[IO[bytes]]:
        """Stream every object under ``prefix`` (reference
        ``iterateBucket:84``)."""
        for key in self.keys(prefix):
            yield self.open(key)

    def paginate(self, listener, prefix: str = "") -> None:
        """Every key through ``listener(key)`` (reference
        ``paginate:118`` + BucketKeyListener — whose S3 pages are an
        API detail; the contract is per-key delivery in order)."""
        for key in self.keys(prefix):
            listener(key)


class LocalObjectStore(ObjectStore):
    """Filesystem-backed store: a 'bucket' is a directory, keys are
    relative paths. The backend every test and egress-less
    environment can run."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"key {key!r} escapes the store root")
        return p

    def keys(self, prefix: str = "") -> List[str]:
        out = []
        for p in sorted(self.root.rglob("*")):
            if p.is_file():
                rel = p.relative_to(self.root).as_posix()
                if rel.startswith(prefix):
                    out.append(rel)
        return out

    def open(self, key: str) -> IO[bytes]:
        return open(self._path(key), "rb")

    def write(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)


class S3ObjectStore(ObjectStore):
    """boto3-backed adapter (reference S3Downloader/S3Uploader).
    Gated: raises at construction when boto3 is absent."""

    def __init__(self, bucket: str, client=None):
        if client is None:
            try:
                import boto3
            except ImportError as e:
                raise ImportError(
                    "S3ObjectStore needs boto3 (pip install boto3) "
                    "or an injected client"
                ) from e
            client = boto3.client("s3")
        self.bucket = bucket
        self.client = client

    def keys(self, prefix: str = "") -> List[str]:
        out: List[str] = []
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": prefix}
            if token:
                kw["ContinuationToken"] = token
            resp = self.client.list_objects_v2(**kw)
            out.extend(
                o["Key"] for o in resp.get("Contents", [])
            )
            if not resp.get("IsTruncated"):
                return out
            token = resp.get("NextContinuationToken")

    def open(self, key: str) -> IO[bytes]:
        return self.client.get_object(
            Bucket=self.bucket, Key=key
        )["Body"]

    def write(self, key: str, data: bytes) -> None:
        self.client.put_object(Bucket=self.bucket, Key=key, Body=data)


class GcsObjectStore(ObjectStore):
    """google-cloud-storage adapter. Gated on the SDK like
    S3ObjectStore."""

    def __init__(self, bucket: str, client=None):
        if client is None:
            try:
                from google.cloud import storage
            except ImportError as e:
                raise ImportError(
                    "GcsObjectStore needs google-cloud-storage or an "
                    "injected client"
                ) from e
            client = storage.Client()
        self.bucket = client.bucket(bucket) if isinstance(
            bucket, str
        ) else bucket

    def keys(self, prefix: str = "") -> List[str]:
        return [b.name for b in self.bucket.list_blobs(prefix=prefix)]

    def open(self, key: str) -> IO[bytes]:
        import io

        return io.BytesIO(self.bucket.blob(key).download_as_bytes())

    def write(self, key: str, data: bytes) -> None:
        self.bucket.blob(key).upload_from_string(data)


def object_store_for(url: str, retry=None) -> ObjectStore:
    """URL-dispatching constructor: ``s3://bucket``, ``gs://bucket``,
    or a local path / ``file://`` directory. Bucket URLs must name
    ONLY the bucket — a key prefix would be silently ignored by the
    store, so it is rejected; pass prefixes to the key-taking APIs
    (``keys(prefix)``, ``CloudDataSetIterator(prefix=...)``).

    ``retry``: a ``resilience.RetryPolicy`` (or ``True`` for the
    defaults) wraps the store in a ``RetryingObjectStore`` so every
    read/write runs under bounded exponential backoff."""

    def _wrap(store: ObjectStore) -> ObjectStore:
        if retry is None:
            return store
        from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
        from deeplearning4j_tpu_torch.resilience.store import RetryingObjectStore

        policy = RetryPolicy() if retry is True else retry
        return RetryingObjectStore(store, policy)

    for scheme, cls in (("s3://", S3ObjectStore),
                        ("gs://", GcsObjectStore)):
        if url.startswith(scheme):
            rest = url[len(scheme):]
            bucket, _, suffix = rest.partition("/")
            if suffix:
                raise ValueError(
                    f"{url!r} names a key prefix; use "
                    f"{scheme}{bucket} and pass {suffix!r} as the "
                    "prefix argument"
                )
            return _wrap(cls(bucket))
    if url.startswith("file://"):
        url = url[7:]
    return _wrap(LocalObjectStore(url))


class StorageDownloader:
    """Reference-call-shape shim (``S3Downloader``): bucket-first
    methods over any ObjectStore backend."""

    def __init__(self, store: ObjectStore):
        self.store = store

    def keys_for_bucket(self, prefix: str = "") -> List[str]:
        return self.store.keys(prefix)

    def object_for_key(self, key: str) -> IO[bytes]:
        return self.store.open(key)

    def download(self, key: str, to_path) -> None:
        self.store.download(key, to_path)

    def iterate_bucket(self, prefix: str = "") -> Iterator[IO[bytes]]:
        return self.store.iterate(prefix)

    def paginate(self, listener, prefix: str = "") -> None:
        self.store.paginate(listener, prefix)


class StorageUploader:
    """Reference-call-shape shim (``S3Uploader``)."""

    def __init__(self, store: ObjectStore):
        self.store = store

    def upload(self, from_path, key: str = None) -> None:
        key = key or os.path.basename(str(from_path))
        self.store.upload(from_path, key)

    def upload_directory(self, directory, prefix: str = "") -> None:
        d = Path(directory)
        for p in sorted(d.rglob("*")):
            if p.is_file():
                rel = p.relative_to(d).as_posix()
                key = f"{prefix}{rel}" if prefix else rel
                self.store.upload(p, key)

"""NDArray streaming over sockets (reference
``streaming/kafka/NDArrayKafkaClient.java`` + ``NDArrayPublisher`` /
``NDArrayConsumer`` — Kafka is the reference's transport; the honest
zero-dependency equivalent here is a length-prefixed TCP stream, with
the same publisher/consumer surface so a Kafka transport can slot in
behind it).

Wire format per message: 8-byte big-endian length + JSON header
{"dtype", "shape", "label_shape"?} + raw array bytes (+ label bytes).
Host-side only; the training loop consumes the resulting DataSets and
feeds the device as usual.

Counterpart of ``deeplearning4j_tpu/streaming/ndarray_stream.py``: the
wire format is byte for byte the JAX package's, so a publisher of
either package feeds a consumer of the other. A publisher takes numpy
arrays or tensors (a tensor on a card is copied to the host first).
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

_MAX_MESSAGE = 256 * 1024 * 1024


def encode_ndarray_message(features: np.ndarray,
                           labels: Optional[np.ndarray] = None) -> bytes:
    """Serialize one (features[, labels]) record (reference
    ``NDArrayPublisher.publish`` payload)."""
    features = np.ascontiguousarray(features, np.float32)
    header = {
        "dtype": "float32",
        "shape": list(features.shape),
    }
    parts = [features.tobytes()]
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.float32)
        header["label_shape"] = list(labels.shape)
        parts.append(labels.tobytes())
    hb = json.dumps(header).encode()
    body = struct.pack(">I", len(hb)) + hb + b"".join(parts)
    return struct.pack(">Q", len(body)) + body


def decode_ndarray_message(body: bytes
                           ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    (hlen,) = struct.unpack(">I", body[:4])
    header = json.loads(body[4:4 + hlen].decode())
    off = 4 + hlen
    shape = tuple(header["shape"])
    n = int(np.prod(shape)) * 4
    feats = np.frombuffer(body[off:off + n], "<f4").reshape(shape).copy()
    off += n
    labels = None
    if "label_shape" in header:
        ls = tuple(header["label_shape"])
        m = int(np.prod(ls)) * 4
        labels = np.frombuffer(body[off:off + m], "<f4").reshape(ls).copy()
    return feats, labels


def _host(a) -> np.ndarray:
    """A numpy array or a tensor (wherever it lies) as a host array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("stream closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


class NDArrayPublisher:
    """Push arrays to a consumer (reference ``NDArrayPublisher``)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)

    def publish(self, features, labels=None) -> None:
        self._sock.sendall(encode_ndarray_message(
            _host(features), None if labels is None else _host(labels)
        ))

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        self._sock.close()


class NDArrayConsumer:
    """Listen for published arrays (reference ``NDArrayConsumer``).
    ``listen()`` starts a daemon acceptor; records land in a bounded
    queue consumed via ``get()`` / iteration."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 queue_size: int = 256):
        self._server = socket.create_server((host, port))
        self.port = self._server.getsockname()[1]
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def listen(self) -> "NDArrayConsumer":
        def run():
            while not self._closed.is_set():
                try:
                    conn, _ = self._server.accept()
                except OSError:
                    return
                try:
                    while True:
                        raw = _read_exact(conn, 8)
                        (size,) = struct.unpack(">Q", raw)
                        if size > _MAX_MESSAGE:
                            raise ValueError("message too large")
                        body = _read_exact(conn, size)
                        self._queue.put(decode_ndarray_message(body))
                except (ConnectionError, ValueError, OSError):
                    conn.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="ndarray-consumer")
        self._thread.start()
        return self

    def get(self, timeout: Optional[float] = None
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return self._queue.get(timeout=timeout)

    def close(self) -> None:
        self._closed.set()
        self._server.close()


class StreamingDataSetIterator(DataSetIterator):
    """DataSetIterator over a live record stream (the
    Kafka->DataSet ingestion leg of the reference's streaming
    pipeline, ``SparkStreamingPipeline.java``): pulls records from an
    ``NDArrayConsumer`` (or any source with ``get(timeout)``),
    batches ``batch_size`` examples, stops after ``total_batches`` (or
    when ``None``, on source timeout)."""

    def __init__(self, source, batch_size: int,
                 total_batches: Optional[int] = None,
                 timeout: float = 10.0):
        self.source = source
        self.batch_size = batch_size
        self.total_batches = total_batches
        self.timeout = timeout
        self._delivered = 0
        self._exhausted = False

    def has_next(self) -> bool:
        if self._exhausted:
            return False
        if self.total_batches is not None:
            return self._delivered < self.total_batches
        return True

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        feats, labels = [], []
        for _ in range(self.batch_size):
            try:
                f, l = self.source.get(timeout=self.timeout)
            except queue.Empty:
                self._exhausted = True
                break
            feats.append(f)
            labels.append(l)
        if not feats:
            raise StopIteration
        has_labels = [l is not None for l in labels]
        if any(has_labels) and not all(has_labels):
            raise ValueError(
                "stream mixes labeled and unlabeled records within one "
                "batch — labels would misalign with features"
            )
        self._delivered += 1
        return DataSet(
            features=np.stack(feats),
            labels=np.stack(labels) if all(has_labels) else None,
        )

    def reset(self) -> None:
        self._delivered = 0  # a live stream cannot rewind

    def batch(self) -> int:
        return self.batch_size

"""MNIST: the IDX reader and ``MnistDataSetIterator``.

Counterpart of ``deeplearning4j_tpu/datasets/mnist.py``. Resolution
order for the four IDX files (gz or raw): the ``data_dir`` argument or
``DL4J_TPU_MNIST_DIR``, then ``~/.deeplearning4j_tpu/mnist/``, then,
only with an explicit opt-in (``allow_synthetic=True`` or
``DL4J_TPU_ALLOW_SYNTHETIC=1``), the JAX package's deterministic
synthetic digits (``_synthetic_mnist``, the same numbers from the same
seed), flagged by ``.synthetic`` and a warning. Batches are assembled
in numpy (gather by the shuffled order, uint8 -> float32 / 255,
one-hot labels): the same bits as the JAX package's native loader.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import (
    DataSet,
    DataSetIterator,
    resolve_synthetic_opt_in,
)

FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}
_ALIASES = {
    "test_images": ["t10k-images-idx3-ubyte", "t10k-idx3-ubyte"],
}


def _read_maybe_gz(path: str) -> bytes:
    if os.path.exists(path + ".gz"):
        with gzip.open(path + ".gz", "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_idx_images(path: str) -> np.ndarray:
    """An IDX3 image file -> uint8 ``[n, rows * cols]`` (reference
    MnistManager.readImage: big-endian magic 2051)."""
    buf = _read_maybe_gz(path)
    magic, n, rows, cols = struct.unpack(">IIII", buf[:16])
    if magic != 2051:
        raise ValueError(f"bad IDX3 magic {magic} in {path}")
    d = rows * cols
    if len(buf) < 16 + n * d:
        raise ValueError(f"truncated IDX3 data in {path}")
    return np.frombuffer(buf, np.uint8, n * d, 16).reshape(n, d).copy()


def read_idx_labels(path: str) -> np.ndarray:
    """An IDX1 label file -> uint8 ``[n]`` (magic 2049)."""
    buf = _read_maybe_gz(path)
    magic, n = struct.unpack(">II", buf[:8])
    if magic != 2049:
        raise ValueError(f"Bad IDX1 magic {magic} in {path}")
    return np.frombuffer(buf, np.uint8, n, 8).copy()


def _find_file(directory: str, stem: str) -> Optional[str]:
    for name in [FILES[stem]] + _ALIASES.get(stem, []):
        p = os.path.join(directory, name)
        if os.path.exists(p) or os.path.exists(p + ".gz"):
            return p
    return None


def _synthetic_mnist(n: int, seed: int,
                     train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-conditional synthetic digits: each class c
    is a distinct fixed blob pattern + noise. Linearly separable but
    shaped/scaled exactly like MNIST (uint8 [n, 784], labels [n])."""
    rng = np.random.RandomState(seed + (0 if train else 1))
    proto_rng = np.random.RandomState(1234)
    protos = (proto_rng.rand(10, 784) > 0.82).astype(np.float32) * 200.0
    labels = rng.randint(0, 10, n).astype(np.uint8)
    imgs = protos[labels] + rng.randn(n, 784) * 25.0
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


def assemble_batch(images: np.ndarray, labels: np.ndarray,
                   order: np.ndarray,
                   n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows ``order`` of the uint8 images as float32 in [0, 1], and
    their one-hot float32 labels."""
    x = images[order].astype(np.float32) / np.float32(255.0)
    y = np.zeros((order.size, n_classes), np.float32)
    y[np.arange(order.size), labels[order]] = 1.0
    return x, y


class MnistDataSetIterator(DataSetIterator):
    """Reference ``MnistDataSetIterator.java:30``: minibatches of
    normalized [0, 1] 784-feature rows + one-hot labels, in a
    permutation drawn from ``seed``."""

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 123,
                 data_dir: Optional[str] = None, binarize: bool = False,
                 shuffle: bool = True,
                 allow_synthetic: Optional[bool] = None):
        self.batch_size = batch_size
        self.synthetic = False
        directory = (data_dir or os.environ.get("DL4J_TPU_MNIST_DIR")
                     or os.path.expanduser("~/.deeplearning4j_tpu/mnist"))
        img_path = _find_file(directory,
                              "train_images" if train else "test_images")
        lab_path = _find_file(directory,
                              "train_labels" if train else "test_labels")
        if img_path and lab_path:
            images = read_idx_images(img_path)
            labels = read_idx_labels(lab_path)
        else:
            resolve_synthetic_opt_in(
                allow_synthetic, "MNIST",
                f"{directory!r} (or set DL4J_TPU_MNIST_DIR)")
            n = num_examples or (60000 if train else 10000)
            images, labels = _synthetic_mnist(n, seed, train)
            self.synthetic = True
        if num_examples is not None:
            images = images[:num_examples]
            labels = labels[:num_examples]
        # uint8 and a permutation; batches are assembled on demand
        self._images = np.ascontiguousarray(images, np.uint8)
        self._labels_u8 = np.ascontiguousarray(labels, np.uint8)
        self._order = (np.random.RandomState(seed).permutation(len(images))
                       if shuffle else np.arange(len(images)))
        self.binarize = binarize
        self._pos = 0

    def next(self) -> DataSet:
        i = self._pos
        j = min(i + self.batch_size, len(self._images))
        self._pos = j
        feats, onehot = assemble_batch(self._images, self._labels_u8,
                                       self._order[i:j], 10)
        if self.binarize:
            feats = (feats > 0.5).astype(np.float32)
        return DataSet(features=feats, labels=onehot)

    def has_next(self) -> bool:
        return self._pos < len(self._images)

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self._images)

    def input_columns(self) -> int:
        return 784

    def total_outcomes(self) -> int:
        return 10

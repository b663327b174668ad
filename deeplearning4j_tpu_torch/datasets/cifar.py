"""CIFAR-10: the binary reader and ``CifarDataSetIterator``.

Counterpart of ``deeplearning4j_tpu/datasets/cifar.py``. Resolution
order for the binary distribution (``cifar-10-batches-bin``:
``data_batch_{1..5}.bin`` / ``test_batch.bin``, records of one label
byte and 3072 RGB bytes): the ``data_dir`` argument or
``DL4J_TPU_CIFAR_DIR``, then ``~/.deeplearning4j_tpu/cifar10/``, then,
only with an explicit opt-in (``allow_synthetic=True`` or
``DL4J_TPU_ALLOW_SYNTHETIC=1``), the JAX package's deterministic
synthetic images (``_synthetic_cifar``, the same numbers from the same
seed), flagged by ``.synthetic`` and a warning. The python-pickle
distribution, which the JAX package also reads, is not read here: the
port unpickles no downloaded file. Batches are assembled in numpy
(gather by the shuffled order, uint8 -> float32 / 255, one-hot labels):
the same bits as the JAX package's native loader. Features are NCHW
``[b, 3, 32, 32]`` (``InputType.convolutional(32, 32, 3)``), or ``[b,
3072]`` rows with ``flat=True``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import (
    DataSet,
    DataSetIterator,
    resolve_synthetic_opt_in,
)
from deeplearning4j_tpu_torch.datasets.mnist import assemble_batch

HEIGHT, WIDTH, CHANNELS, NUM_LABELS = 32, 32, 3, 10
NUM_TRAIN_IMAGES, NUM_TEST_IMAGES = 50000, 10000
_REC = 1 + CHANNELS * HEIGHT * WIDTH  # a 3073-byte binary record

LABELS = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


def read_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A CIFAR-10 binary batch -> (uint8 images ``[n, 3, 32, 32]``,
    uint8 labels ``[n]``)."""
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), np.uint8)
    if buf.size % _REC:
        raise ValueError(f"{path}: size {buf.size} not a multiple of {_REC}")
    rec = buf.reshape(-1, _REC)
    return (rec[:, 1:].reshape(-1, CHANNELS, HEIGHT, WIDTH).copy(),
            rec[:, 0].copy())


def _candidate_dirs(data_dir: Optional[str]) -> List[str]:
    base = (data_dir or os.environ.get("DL4J_TPU_CIFAR_DIR")
            or os.path.expanduser("~/.deeplearning4j_tpu/cifar10"))
    return [base, os.path.join(base, "cifar-10-batches-bin")]


def _load_real(data_dir: Optional[str], train: bool):
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    for d in _candidate_dirs(data_dir):
        if all(os.path.exists(os.path.join(d, n)) for n in names):
            parts = [read_bin(os.path.join(d, n)) for n in names]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
    return None


def _synthetic_cifar(n: int, seed: int, train: bool):
    """Class-conditional colour-blob images, shaped and scaled like
    CIFAR-10 (the JAX package's numbers)."""
    rng = np.random.RandomState(seed + (0 if train else 1))
    proto_rng = np.random.RandomState(4321)
    protos = proto_rng.rand(NUM_LABELS, CHANNELS, HEIGHT, WIDTH).astype(
        np.float32) * 180.0
    labels = rng.randint(0, NUM_LABELS, n).astype(np.uint8)
    imgs = protos[labels] + rng.randn(n, CHANNELS, HEIGHT, WIDTH) * 30.0
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


class CifarDataSetIterator(DataSetIterator):
    """Reference ``CifarDataSetIterator.java``: minibatches of [0, 1]
    images and one-hot labels, in a permutation drawn from ``seed``."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, data_dir: Optional[str] = None,
                 seed: int = 123, shuffle: bool = True, flat: bool = False,
                 allow_synthetic: Optional[bool] = None):
        self.batch_size = batch_size
        self.synthetic = False
        loaded = _load_real(data_dir, train)
        if loaded is not None:
            images, labels = loaded
        else:
            resolve_synthetic_opt_in(
                allow_synthetic, "CIFAR-10",
                f"{_candidate_dirs(data_dir)!r} (or set "
                "DL4J_TPU_CIFAR_DIR)")
            n = num_examples or (NUM_TRAIN_IMAGES if train
                                 else NUM_TEST_IMAGES)
            images, labels = _synthetic_cifar(n, seed, train)
            self.synthetic = True
        if num_examples is not None:
            images, labels = images[:num_examples], labels[:num_examples]
        # uint8 rows and a permutation; batches are assembled on demand
        self._images = np.ascontiguousarray(
            images.reshape(len(images), -1), np.uint8)
        self._labels_u8 = np.ascontiguousarray(labels, np.uint8)
        self._order = (np.random.RandomState(seed).permutation(len(images))
                       if shuffle else np.arange(len(images)))
        self.flat = flat
        self._pos = 0

    def next(self) -> DataSet:
        i = self._pos
        j = min(i + self.batch_size, len(self._images))
        self._pos = j
        feats, onehot = assemble_batch(self._images, self._labels_u8,
                                       self._order[i:j], NUM_LABELS)
        if not self.flat:
            feats = feats.reshape(len(feats), CHANNELS, HEIGHT, WIDTH)
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
        return CHANNELS * HEIGHT * WIDTH

    def total_outcomes(self) -> int:
        return NUM_LABELS

"""Iris (reference: ``datasets/fetchers/IrisDataFetcher`` +
``IrisDataSetIterator``).

The reference bundles the classic 150-example dataset as a resource.
To keep this repo free of copied data files, the default is a
deterministic Iris-like generator (three 4-feature species clusters
with the classic means/spreads); drop the real ``iris.data`` CSV next
to ``DL4J_TPU_IRIS_FILE`` for exact parity.

Counterpart of ``deeplearning4j_tpu/datasets/iris.py``, host code
copied as it is (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

# Classic per-species feature means / stds (sepal-l, sepal-w, petal-l,
# petal-w) — public summary statistics of Fisher's data.
_MEANS = np.array([
    [5.006, 3.428, 1.462, 0.246],   # setosa
    [5.936, 2.770, 4.260, 1.326],   # versicolor
    [6.588, 2.974, 5.552, 2.026],   # virginica
])
_STDS = np.array([
    [0.352, 0.379, 0.174, 0.105],
    [0.516, 0.314, 0.470, 0.198],
    [0.636, 0.322, 0.552, 0.275],
])


def load_iris(seed: int = 6) -> tuple:
    """Returns (features [150,4] float32, one-hot labels [150,3])."""
    path = os.environ.get("DL4J_TPU_IRIS_FILE")
    if path and os.path.exists(path):
        rows = []
        labels = []
        names: dict = {}
        with open(path) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 5:
                    continue
                rows.append([float(v) for v in parts[:4]])
                labels.append(names.setdefault(parts[4], len(names)))
        x = np.asarray(rows, np.float32)
        y = np.zeros((len(labels), 3), np.float32)
        y[np.arange(len(labels)), labels] = 1.0
        return x, y
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for c in range(3):
        xs.append(_MEANS[c] + rng.randn(50, 4) * _STDS[c])
        y = np.zeros((50, 3), np.float32)
        y[:, c] = 1.0
        ys.append(y)
    return (np.concatenate(xs).astype(np.float32), np.concatenate(ys))


class IrisDataSetIterator(DataSetIterator):
    """Reference ``IrisDataSetIterator(batch, numExamples)``."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 seed: int = 6, shuffle: bool = True):
        x, y = load_iris(seed)
        if shuffle:
            idx = np.random.RandomState(seed).permutation(len(x))
            x, y = x[idx], y[idx]
        self._features = x[:num_examples]
        self._labels = y[:num_examples]
        self.batch_size = batch_size
        self._pos = 0

    def next(self) -> DataSet:
        i = self._pos
        j = min(i + self.batch_size, len(self._features))
        self._pos = j
        return DataSet(features=self._features[i:j],
                       labels=self._labels[i:j])

    def has_next(self) -> bool:
        return self._pos < len(self._features)

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self._features)

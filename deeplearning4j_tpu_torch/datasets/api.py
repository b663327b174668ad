"""DataSet container and the iterator SPI.

Counterpart of ``deeplearning4j_tpu/datasets/api.py`` for ``DataSet``,
``DataSetIterator``, ``ListDataSetIterator`` and
``resolve_synthetic_opt_in``. Containers hold numpy arrays on the host;
the network moves each minibatch to its device in ``fit_minibatch``.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclass
class DataSet:
    """features/labels (+ optional masks) minibatch container."""

    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])


class DataSetIterator:
    """Iterator SPI (reference ``DataSetIterator``). Subclasses
    implement ``next`` / ``has_next`` / ``reset``; iterating starts
    from the top (``__iter__`` resets)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def next(self) -> DataSet:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        return -1


class ListDataSetIterator(DataSetIterator):
    """Iterate a pre-built list of minibatches (reference
    ``ListDataSetIterator``)."""

    def __init__(self, batches: Sequence[DataSet]):
        self._batches = list(batches)
        self._pos = 0

    def next(self) -> DataSet:
        ds = self._batches[self._pos]
        self._pos += 1
        return ds

    def has_next(self) -> bool:
        return self._pos < len(self._batches)

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._batches[0].num_examples() if self._batches else 0

    def total_examples(self) -> int:
        return sum(b.num_examples() for b in self._batches)


def resolve_synthetic_opt_in(allow_synthetic: Optional[bool], dataset: str,
                             where: str) -> None:
    """Gate for synthetic-data fallbacks: missing real data is an error
    unless the caller opted in (``allow_synthetic=True`` or
    ``DL4J_TPU_ALLOW_SYNTHETIC=1``); opting in still warns."""
    if allow_synthetic is None:
        allow_synthetic = os.environ.get(
            "DL4J_TPU_ALLOW_SYNTHETIC", "").lower() in ("1", "true", "on")
    if not allow_synthetic:
        raise FileNotFoundError(
            f"{dataset} data not found in {where}. Place the data there, "
            "or opt in to synthetic data with allow_synthetic=True / "
            "DL4J_TPU_ALLOW_SYNTHETIC=1.")
    warnings.warn(
        f"{dataset} data not found — using SYNTHETIC class-conditional "
        f"data (not real {dataset}).", RuntimeWarning, stacklevel=3)

"""Curves dataset (reference ``datasets/fetchers/CurvesDataFetcher
.java`` — downloads ``curves.ser``, a serialized DataSet of 28x28
synthetic curve images used for pretraining/autoencoder demos).

The reference's S3 artifact is a Java-serialized nd4j DataSet; here
the loader reads ``curves.npz`` (arrays ``features`` [n, 784] float,
optional ``labels``) from the data directory. When absent, the same
class of data is regenerated deterministically — parametric quadratic
Bezier strokes rasterized to 28x28, matching the original dataset's
construction idea — behind the standard synthetic opt-in gate.

Counterpart of ``deeplearning4j_tpu/datasets/curves.py``, host code
copied as it is (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

WIDTH = HEIGHT = 28
N_EXAMPLES = 10000


def _raster_curve(rng: np.random.RandomState) -> np.ndarray:
    """One 28x28 grayscale quadratic-Bezier stroke."""
    p = rng.rand(3, 2) * (WIDTH - 5) + 2.0  # control points
    t = np.linspace(0.0, 1.0, 64)[:, None]
    pts = (
        (1 - t) ** 2 * p[0] + 2 * (1 - t) * t * p[1] + t ** 2 * p[2]
    )
    img = np.zeros((HEIGHT, WIDTH), np.float32)
    xi = np.clip(pts[:, 0].round().astype(int), 0, WIDTH - 1)
    yi = np.clip(pts[:, 1].round().astype(int), 0, HEIGHT - 1)
    img[yi, xi] = 1.0
    return img


def _synthetic_curves(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return np.stack(
        [_raster_curve(rng).ravel() for _ in range(n)]
    )


class CurvesDataSetIterator(DataSetIterator):
    """Unsupervised curve images, features == labels when none given
    (the reference feeds curves to pretraining; ``fetch`` returns the
    whole DataSet)."""

    def __init__(self, batch_size: int,
                 num_examples: Optional[int] = None,
                 data_dir: Optional[str] = None, seed: int = 123,
                 allow_synthetic: Optional[bool] = None):
        directory = (
            data_dir
            or os.environ.get("DL4J_TPU_CURVES_DIR")
            or os.path.expanduser("~/.deeplearning4j_tpu/curves")
        )
        path = os.path.join(directory, "curves.npz")
        self.synthetic = False
        if os.path.exists(path):
            with np.load(path) as z:
                feats = np.asarray(z["features"], np.float32)
                labels = (
                    np.asarray(z["labels"], np.float32)
                    if "labels" in z else feats
                )
        else:
            from deeplearning4j_tpu_torch.datasets.api import (
                resolve_synthetic_opt_in,
            )

            resolve_synthetic_opt_in(
                allow_synthetic, "Curves",
                f"{path!r} (or set DL4J_TPU_CURVES_DIR)",
            )
            n = num_examples or N_EXAMPLES
            feats = _synthetic_curves(n, seed)
            labels = feats
            self.synthetic = True
        if num_examples is not None:
            feats, labels = feats[:num_examples], labels[:num_examples]
        self.batch_size = batch_size
        self._features = feats
        self._labels = labels
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

    def input_columns(self) -> int:
        return self._features.shape[1]

    def total_outcomes(self) -> int:
        return self._labels.shape[1]

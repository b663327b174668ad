"""Real raster data for egress-less environments.

The reference's MNIST tests download IDX files at first use
(``datasets/mnist/MnistManager.java``); this build environment has no
egress, so benching "on real data" needs a real dataset that ships
with the image. scikit-learn's ``load_digits`` bundle is exactly that:
1,797 real handwritten digit rasters (UCI Optical Recognition of
Handwritten Digits — genuine pen strokes, 8x8 @ 16 gray levels).

``ensure_digits_idx`` writes them ONCE as standard IDX files
(nearest-neighbor upscaled to 28x28 so LeNet-class configs run
unchanged), after which ``MnistDataSetIterator`` reads real bytes
end-to-end. The upscaling is declared in the marker file: these are
real handwritten images at coarser native resolution than MNIST, not
MNIST itself.

Counterpart of ``deeplearning4j_tpu/datasets/realdata.py``, host code
copied as it is (the port imports nothing of the JAX package); the
files, marker included, are byte for byte the JAX package's, so either
package reads a directory the other wrote.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

_MARKER = "SOURCE.txt"
_TRAIN_N = 1500  # of 1797; remainder is the test split


def _upscale_nn(imgs: np.ndarray, size: int = 28) -> np.ndarray:
    """[n, 8, 8] -> [n, size, size] nearest neighbor."""
    idx = (np.arange(size) * imgs.shape[1]) // size
    return imgs[:, idx][:, :, idx]


def _write_idx3(path: str, images: np.ndarray) -> None:
    n, h, w = images.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, h, w))
        f.write(np.ascontiguousarray(images, np.uint8).tobytes())


def _write_idx1(path: str, labels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(">ii", 2049, len(labels)))
        f.write(np.ascontiguousarray(labels, np.uint8).tobytes())


def ensure_digits_idx(directory: Optional[str] = None) -> Optional[str]:
    """Materialize the real handwritten-digits dataset as IDX files
    (generate-once-and-cache). Returns the directory, or None when
    scikit-learn is unavailable."""
    directory = directory or os.path.expanduser(
        "~/.deeplearning4j_tpu/digits_idx"
    )
    marker = os.path.join(directory, _MARKER)
    if os.path.exists(marker):
        return directory
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        return None
    d = load_digits()
    # 16 gray levels -> 0..255 uint8, like MNIST's byte range
    imgs = np.clip(d.images * 16.0, 0, 255).astype(np.uint8)
    imgs = _upscale_nn(imgs)
    labels = d.target.astype(np.uint8)
    rng = np.random.RandomState(42)
    perm = rng.permutation(len(imgs))
    imgs, labels = imgs[perm], labels[perm]
    os.makedirs(directory, exist_ok=True)
    _write_idx3(os.path.join(directory, "train-images-idx3-ubyte"),
                imgs[:_TRAIN_N])
    _write_idx1(os.path.join(directory, "train-labels-idx1-ubyte"),
                labels[:_TRAIN_N])
    _write_idx3(os.path.join(directory, "t10k-images-idx3-ubyte"),
                imgs[_TRAIN_N:])
    _write_idx1(os.path.join(directory, "t10k-labels-idx1-ubyte"),
                labels[_TRAIN_N:])
    with open(marker, "w") as f:
        f.write(
            "UCI Optical Recognition of Handwritten Digits via "
            "sklearn.datasets.load_digits: 1797 real handwritten "
            "rasters, 8x8@16-levels nearest-neighbor upscaled to "
            "28x28 uint8, shuffled seed=42, split 1500/297. Written "
            "as standard IDX so the native C++ decoder parses real "
            "bytes. NOT MNIST - declared wherever benched.\n"
        )
    return directory

"""LFW — Labeled Faces in the Wild (reference:
``datasets/iterator/impl/LFWDataSetIterator.java`` over datavec's
``LFWLoader`` with ``ParentPathLabelGenerator``).

Reads any image tree laid out person-per-directory
(``lfw/<person>/<person>_0001.jpg``), labels by parent
directory name, resizes to ``img_dim`` and splits train/test by
``split_train_test`` with a seeded shuffle — the same knobs the
reference constructor exposes (batchSize, numExamples, imgDim,
numLabels, train, splitTrainTest, rng).

Resolution order: ``data_dir`` arg, ``DL4J_TPU_LFW_DIR`` env var,
``~/.deeplearning4j_tpu/lfw``. No synthetic fallback — face data can't
be faked meaningfully; missing data raises.

Counterpart of ``deeplearning4j_tpu/datasets/lfw.py``, host code
copied as it is (the port imports nothing of the JAX package), but for
the decode: JAX's goes through PIL, which the card's machine lacks, so
the port's reads the files with ``datasets/imagefile.py`` (JPEG, PNG,
PPM, BMP), bit for bit PIL's ``open(path).convert(mode).resize(size)``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets import imagefile
from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

HEIGHT, WIDTH, CHANNELS = 250, 250, 3
_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def _scan(root: str) -> List[Tuple[str, str]]:
    """(path, person) pairs, person = parent directory name."""
    out = []
    for person in sorted(os.listdir(root)):
        pdir = os.path.join(root, person)
        if not os.path.isdir(pdir):
            continue
        for fn in sorted(os.listdir(pdir)):
            if fn.lower().endswith(_EXTS):
                out.append((os.path.join(pdir, fn), person))
    return out


class LFWDataSetIterator(DataSetIterator):
    """Minibatches of face images, one-hot person labels (reference
    ``LFWDataSetIterator.java:1``)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 img_dim: Tuple[int, int, int] = (HEIGHT, WIDTH, CHANNELS),
                 num_labels: Optional[int] = None, train: bool = True,
                 split_train_test: float = 1.0, seed: int = 42,
                 data_dir: Optional[str] = None, flat: bool = False):
        root = (
            data_dir
            or os.environ.get("DL4J_TPU_LFW_DIR")
            or os.path.expanduser("~/.deeplearning4j_tpu/lfw")
        )
        # tolerate the archive's extra nesting (lfw/lfw/<person>/...)
        if os.path.isdir(os.path.join(root, "lfw")):
            root = os.path.join(root, "lfw")
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"LFW image tree not found at {root!r} (set "
                "DL4J_TPU_LFW_DIR or pass data_dir)."
            )
        entries = _scan(root)
        if not entries:
            raise FileNotFoundError(f"no images found under {root!r}")
        persons = sorted({p for _, p in entries})
        if num_labels is not None and num_labels < len(persons):
            persons = persons[:num_labels]
            keep = set(persons)
            entries = [e for e in entries if e[1] in keep]
        self.labels = persons
        label_idx = {p: i for i, p in enumerate(persons)}

        rng = np.random.RandomState(seed)
        order = rng.permutation(len(entries))
        cut = int(len(entries) * split_train_test)
        sel = order[:cut] if train else order[cut:]
        if num_examples is not None:
            sel = sel[:num_examples]

        # decode lazily per minibatch — the full set at the default
        # 250x250x3 is ~10 GB float32 (reference LFWLoader streams too)
        self._entries = [entries[i] for i in sel]
        self._label_idx = label_idx
        self._img_dim = img_dim
        self._flat = flat
        self.batch_size = batch_size
        self._pos = 0

    def _decode(self, path: str) -> np.ndarray:
        h, w, c = self._img_dim
        img = imagefile.load(path, w, h, "RGB" if c == 3 else "L")
        a = img.astype(np.float32) / 255.0  # [h, w, c?]
        if c == 1:
            a = a[:, :, None]
        return a.transpose(2, 0, 1)

    def next(self) -> DataSet:
        i = self._pos
        j = min(i + self.batch_size, len(self._entries))
        self._pos = j
        chunk = self._entries[i:j]
        h, w, c = self._img_dim
        feats = np.empty((len(chunk), c, h, w), np.float32)
        onehot = np.zeros((len(chunk), len(self.labels)), np.float32)
        for row, (path, person) in enumerate(chunk):
            feats[row] = self._decode(path)
            onehot[row, self._label_idx[person]] = 1.0
        if self._flat:
            feats = feats.reshape(len(feats), -1)
        return DataSet(features=feats, labels=onehot)

    def has_next(self) -> bool:
        return self._pos < len(self._entries)

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self._entries)

    def input_columns(self) -> int:
        h, w, c = self._img_dim
        return c * h * w

    def total_outcomes(self) -> int:
        return len(self.labels)

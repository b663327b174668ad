"""DataSet containers and the iterator SPI.

Counterpart of ``deeplearning4j_tpu/datasets/api.py`` for ``DataSet``
(with its npz codec, the quarantine store's format), ``MultiDataSet``,
``ChunkedDataSet``, ``PlacedDataSet``, ``PlacedChunk``,
``DataSetIterator``, ``ListDataSetIterator``,
``ExistingDataSetIterator`` and ``resolve_synthetic_opt_in``. Host
containers hold numpy arrays; the network moves each minibatch to its
device in ``fit_minibatch`` (uint8 / int8 / int16 arrays at their own
width, cast on the device). A ``PlacedDataSet`` / ``PlacedChunk`` holds
tensors an input pipeline already put on the device, on a copy stream
of its own on the card: ``ready`` is the event recorded after the
copies, and ``wait()`` orders the consumer's stream after it.
"""

from __future__ import annotations

import io
import os
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

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

    # the npz codec of a minibatch (the quarantine store's blobs; the
    # JAX package's format, so each package reads the other's)

    def save_npz(self, file) -> None:
        """This minibatch as an npz (``file``: a path or file-like)."""
        arrays = {"features": np.asarray(self.features),
                  "labels": np.asarray(self.labels)}
        if self.features_mask is not None:
            arrays["features_mask"] = np.asarray(self.features_mask)
        if self.labels_mask is not None:
            arrays["labels_mask"] = np.asarray(self.labels_mask)
        np.savez(file, **arrays)

    def to_npz_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.save_npz(buf)
        return buf.getvalue()

    @classmethod
    def load_npz(cls, file) -> "DataSet":
        """A minibatch written by ``save_npz`` (a path or file-like)."""
        with np.load(file) as z:
            return cls(features=z["features"], labels=z["labels"],
                       features_mask=(z["features_mask"]
                                      if "features_mask" in z else None),
                       labels_mask=(z["labels_mask"]
                                    if "labels_mask" in z else None))

    @classmethod
    def from_npz_bytes(cls, data: bytes) -> "DataSet":
        return cls.load_npz(io.BytesIO(data))


def _at(a, i):
    return None if a is None else a[i]


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _wait_placed(obj) -> None:
    """Order the current CUDA stream after a placed payload's copies
    (its ``ready`` event) and mark each of its tensors as used there,
    so the caching allocator does not hand a buffer back while a step
    still reads it. Nothing to do on the CPU or once waited."""
    ev = obj.ready
    if ev is None:
        return
    import torch

    stream = torch.cuda.current_stream()
    stream.wait_event(ev)

    def mark(v):
        if isinstance(v, (list, tuple)):
            for a in v:
                mark(a)
        elif torch.is_tensor(v) and v.is_cuda:
            v.record_stream(stream)

    for v in (obj.features, obj.labels, obj.features_mask,
              obj.labels_mask, getattr(obj, "weights", None)):
        mark(v)
    obj.ready = None


@dataclass
class ChunkedDataSet:
    """k same-shaped minibatches stacked on a leading axis ([k, b, ...]),
    host arrays: what a chunk-mode ``PrefetchIterator`` hands the
    megastep executor (the engines' ``fit_epoch_megastep``)."""

    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    @property
    def k(self) -> int:
        return int(np.shape(self.features)[0])

    def num_examples(self) -> int:
        s = np.shape(self.features)
        return int(s[0]) * int(s[1])

    def to_datasets(self) -> List["DataSet"]:
        """The k minibatches (for a consumer without a chunk path)."""
        return [DataSet(self.features[i], self.labels[i],
                        _at(self.features_mask, i), _at(self.labels_mask, i))
                for i in range(self.k)]


@dataclass
class PlacedDataSet:
    """A minibatch already cast and placed on the device by an input
    pipeline's placement (``DistributedTrainer.place_minibatch``), so
    the step never waits on a host-to-device copy. The fields are
    tensors (for a ``ComputationGraph`` lists of tensors) in the layout
    the placement made; ``num_rows`` is the count of valid examples (a
    padded trailing batch carries more rows, masked out of the loss);
    ``has_masks`` whether a mask rides along; ``weights`` the
    placement's per-microbatch loss weights (the trainer's); ``ready``
    the event after the copies (None: usable at once)."""

    features: object
    labels: object
    features_mask: object = None
    labels_mask: object = None
    num_rows: Optional[int] = None
    has_masks: Optional[bool] = None
    weights: object = None
    local: Optional[bool] = None
    ready: object = None

    def num_examples(self) -> int:
        if self.num_rows is not None:
            return int(self.num_rows)
        return int(np.shape(_first(self.features))[0])

    def wait(self) -> "PlacedDataSet":
        _wait_placed(self)
        return self


@dataclass
class PlacedChunk:
    """A block of k same-shaped minibatches stacked ``[k, b, ...]`` and
    already placed on the device (``DistributedTrainer.place_chunk``):
    the double-buffered feed of the megastep executor, assembled and
    copied on the prefetch worker while the card runs the previous
    chunk. ``num_rows`` counts the valid examples of all k steps;
    ``weights`` is the placement's ``[k, w]`` table of loss weights;
    ``ready`` as ``PlacedDataSet``'s."""

    features: object
    labels: object
    features_mask: object = None
    labels_mask: object = None
    num_rows: Optional[int] = None
    weights: object = None
    local: Optional[bool] = None
    ready: object = None

    @property
    def k(self) -> int:
        return int(np.shape(_first(self.features))[0])

    def num_examples(self) -> int:
        if self.num_rows is not None:
            return int(self.num_rows)
        s = np.shape(_first(self.features))
        return int(s[0]) * int(s[1])

    def wait(self) -> "PlacedChunk":
        _wait_placed(self)
        return self

    def to_datasets(self) -> List[PlacedDataSet]:
        """The k placed minibatches (the per-step fallback of a block
        of one)."""
        self.wait()

        def at(v, i):
            if isinstance(v, (list, tuple)):
                return [_at(a, i) for a in v]
            return _at(v, i)

        rows = None if self.num_rows is None else self.num_rows // self.k
        return [PlacedDataSet(
            at(self.features, i), at(self.labels, i),
            at(self.features_mask, i), at(self.labels_mask, i),
            num_rows=rows,
            has_masks=(self.features_mask is not None
                       or self.labels_mask is not None),
            weights=_at(self.weights, i), local=self.local)
            for i in range(self.k)]


@dataclass
class MultiDataSet:
    """Multi-input/multi-output container (reference nd4j MultiDataSet,
    consumed by ComputationGraph): one array per graph input and per
    output, and optionally one mask (or None) per input and per
    output."""

    features: Sequence[np.ndarray]
    labels: Sequence[np.ndarray]
    features_masks: Optional[Sequence[Optional[np.ndarray]]] = None
    labels_masks: Optional[Sequence[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


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


class ExistingDataSetIterator(DataSetIterator):
    """Any iterable of DataSets as an iterator (reference
    ``ExistingDataSetIterator``)."""

    def __init__(self, iterable):
        self._iterable = iterable
        self._it = None

    def __iter__(self):
        self._it = iter(self._iterable)
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self._iterable)
        return next(self._it)

    def reset(self):
        self._it = None


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

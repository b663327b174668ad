"""RecordReader bridge (reference: the DataVec bridge
``RecordReaderDataSetIterator`` / ``SequenceRecordReaderDataSetIterator``
in ``datasets/datavec/``; DataVec itself is an external dependency of
the reference — here a compact host-side equivalent).

``RecordReader`` yields records (lists of values); the iterator turns
them into featurized minibatches with optional one-hot label handling,
mirroring the reference's (labelIndex, numPossibleLabels) contract.

Counterpart of ``deeplearning4j_tpu/datasets/record_reader.py``, host code
copied as it is (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator


class RecordReader:
    """SPI: iterable of records (list of str/float)."""

    def records(self) -> Iterator[List]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CSVRecordReader(RecordReader):
    """Reference DataVec ``CSVRecordReader`` (skip lines, delimiter)."""

    def __init__(self, path: str, skip_lines: int = 0,
                 delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def records(self) -> Iterator[List]:
        with open(self.path, newline="") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield row


class CollectionRecordReader(RecordReader):
    def __init__(self, collection: Sequence[Sequence]):
        self.collection = collection

    def records(self) -> Iterator[List]:
        return iter([list(r) for r in self.collection])


def _featurize_row(row: List[float], label_index: Optional[int],
                   num_possible_labels: int, regression: bool):
    """Split one numeric record into (features, label_row-or-None) —
    shared by the flat and sequence iterators."""
    if label_index is None:
        return row, None
    label = row[label_index]
    feats = row[:label_index] + row[label_index + 1:]
    if regression:
        return feats, [label]
    onehot = [0.0] * num_possible_labels
    cls = int(label)
    if not 0 <= cls < num_possible_labels:
        raise ValueError(
            f"label {label} outside [0, {num_possible_labels})"
        )
    onehot[cls] = 1.0
    return feats, onehot


class RecordReaderDataSetIterator(DataSetIterator):
    """Reference ``RecordReaderDataSetIterator``: featurize records,
    optionally one-hot a label column."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_possible_labels: int = 0,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self._it: Optional[Iterator[List]] = None
        self._pending: Optional[List] = None

    def _ensure(self) -> None:
        if self._it is None:
            self.reader.reset()
            self._it = self.reader.records()
            self._pending = next(self._it, None)

    def has_next(self) -> bool:
        self._ensure()
        return self._pending is not None

    def next(self) -> DataSet:
        self._ensure()
        feats, labels = [], []
        while self._pending is not None and len(feats) < self.batch_size:
            row = [float(v) for v in self._pending]
            self._pending = next(self._it, None)
            f, l = _featurize_row(
                row, self.label_index, self.num_possible_labels,
                self.regression,
            )
            feats.append(f)
            if l is not None:
                labels.append(l)
        if not feats:
            raise StopIteration
        x = np.asarray(feats, np.float32)
        y = (np.asarray(labels, np.float32) if labels else x)
        return DataSet(features=x, labels=y)

    def reset(self) -> None:
        self._it = None
        self._pending = None

    def batch(self) -> int:
        return self.batch_size


class SequenceRecordReader:
    """SPI: iterable of sequences, each a list of records (reference
    DataVec ``SequenceRecordReader``)."""

    def sequences(self) -> Iterator[List[List]]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (reference
    ``CSVSequenceRecordReader`` over a file-per-sequence layout);
    accepts a list of paths or a directory."""

    def __init__(self, paths, skip_lines: int = 0,
                 delimiter: str = ","):
        if isinstance(paths, str):
            paths = sorted(
                os.path.join(paths, n) for n in os.listdir(paths)
                if n.endswith(".csv")
            )
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def sequences(self) -> Iterator[List[List]]:
        for p in self.paths:
            with open(p, newline="") as f:
                rows = [
                    row for i, row in enumerate(
                        csv.reader(f, delimiter=self.delimiter)
                    )
                    if i >= self.skip_lines and row
                ]
            yield rows


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Sequence[Sequence[Sequence]]):
        self._sequences = sequences

    def sequences(self) -> Iterator[List[List]]:
        return iter(
            [[list(r) for r in s] for s in self._sequences]
        )


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Reference ``SequenceRecordReaderDataSetIterator``: sequences ->
    [batch, features, time] tensors with per-timestep labels, padded
    to the batch's longest sequence with masks (the reference's
    variable-length alignment)."""

    def __init__(self, reader: SequenceRecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_possible_labels: int = 0,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self._it: Optional[Iterator] = None
        self._pending = None

    def _ensure(self) -> None:
        if self._it is None:
            self.reader.reset()
            self._it = self.reader.sequences()
            self._pending = next(self._it, None)

    def has_next(self) -> bool:
        self._ensure()
        return self._pending is not None

    def _featurize(self, seq):
        feats, labels = [], []
        for row in seq:
            f, l = _featurize_row(
                [float(v) for v in row], self.label_index,
                self.num_possible_labels, self.regression,
            )
            feats.append(f)
            if l is not None:
                labels.append(l)
        return np.asarray(feats, np.float32), (
            np.asarray(labels, np.float32) if labels else None
        )

    def next(self) -> DataSet:
        self._ensure()
        seqs = []
        while self._pending is not None and len(seqs) < self.batch_size:
            if len(self._pending) == 0:
                raise ValueError(
                    f"sequence {len(seqs)} of this batch is empty "
                    "(zero-length or header-only input)"
                )
            seqs.append(self._featurize(self._pending))
            self._pending = next(self._it, None)
        if not seqs:
            raise StopIteration
        t_max = max(f.shape[0] for f, _ in seqs)
        b = len(seqs)
        n_feat = seqs[0][0].shape[1]
        x = np.zeros((b, n_feat, t_max), np.float32)
        mask = np.zeros((b, t_max), np.float32)
        y = None
        for i, (f, l) in enumerate(seqs):
            t = f.shape[0]
            x[i, :, :t] = f.T
            mask[i, :t] = 1.0
            if l is not None:
                if y is None:
                    y = np.zeros((b, l.shape[1], t_max), np.float32)
                y[i, :, :t] = l.T
        same_len = all(f.shape[0] == t_max for f, _ in seqs)
        return DataSet(
            features=x, labels=(y if y is not None else x),
            features_mask=None if same_len else mask,
            labels_mask=None if same_len or y is None else mask,
        )

    def reset(self) -> None:
        self._it = None
        self._pending = None

    def batch(self) -> int:
        return self.batch_size


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Reference ``RecordReaderMultiDataSetIterator``: combine named
    readers into MultiDataSets via column-range input/output specs.

    Builder mirror: ``add_reader(name, reader)``, ``add_input(name,
    from_col, to_col)``, ``add_output(name, from_col, to_col)``,
    ``add_output_one_hot(name, col, n_classes)``."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._readers: dict = {}
        self._inputs: List[tuple] = []
        self._outputs: List[tuple] = []
        self._iters: Optional[dict] = None
        self._pending: Optional[dict] = None

    def add_reader(self, name: str, reader: RecordReader):
        self._readers[name] = reader
        return self

    def add_input(self, name: str, from_col: int, to_col: int):
        self._inputs.append((name, from_col, to_col, None))
        return self

    def add_output(self, name: str, from_col: int, to_col: int):
        self._outputs.append((name, from_col, to_col, None))
        return self

    def add_output_one_hot(self, name: str, col: int, n_classes: int):
        self._outputs.append((name, col, col, n_classes))
        return self

    def _fetch_row(self):
        """One aligned row from every reader, or None at exhaustion."""
        out = {}
        for n, it in self._iters.items():
            row = next(it, None)
            if row is None:
                return None
            out[n] = [float(v) for v in row]
        return out

    def _ensure(self) -> None:
        if self._iters is None:
            for r in self._readers.values():
                r.reset()
            self._iters = {
                n: r.records() for n, r in self._readers.items()
            }
            # one-row lookahead keeps the has_next contract exact at
            # batch boundaries (same pattern as
            # RecordReaderDataSetIterator._pending)
            self._pending = self._fetch_row()

    def has_next(self) -> bool:
        self._ensure()
        return self._pending is not None

    def next(self):
        from deeplearning4j_tpu_torch.datasets.api import MultiDataSet

        self._ensure()
        if self._pending is None:
            raise StopIteration
        rows: dict = {n: [] for n in self._readers}
        while self._pending is not None and (
            len(next(iter(rows.values()))) < self.batch_size
        ):
            for n, row in self._pending.items():
                rows[n].append(row)
            self._pending = self._fetch_row()

        def slice_cols(spec):
            name, a, b, onehot = spec
            data = np.asarray(rows[name], np.float32)[:, a:b + 1]
            if onehot is not None:
                cls = data[:, 0].astype(int)
                if ((cls < 0) | (cls >= onehot)).any():
                    bad = cls[(cls < 0) | (cls >= onehot)][0]
                    raise ValueError(
                        f"label {bad} outside [0, {onehot}) in "
                        f"reader '{name}' column {a}"
                    )
                out = np.zeros((data.shape[0], onehot), np.float32)
                out[np.arange(data.shape[0]), cls] = 1.0
                return out
            return data

        return MultiDataSet(
            features=[slice_cols(s) for s in self._inputs],
            labels=[slice_cols(s) for s in self._outputs],
        )

    def reset(self) -> None:
        self._iters = None
        self._pending = None

    def batch(self) -> int:
        return self.batch_size

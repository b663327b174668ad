"""Classification evaluation (reference: ``eval/Evaluation.java:46``,
``eval/ConfusionMatrix.java``).

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``. Host-side
numpy: evaluation is bookkeeping over argmaxes, not device work; the
card does the batched ``output()`` forward. Labels, predictions and
masks may be numpy arrays or tensors; a tensor on the card is copied to
the host once per ``eval`` call (``host_array``), never per row.
Argmax-tie semantics follow numpy's first-max rule (the reference uses
nd4j argmax, also first-max).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


def host_array(a, dtype=None) -> Optional[np.ndarray]:
    """``a`` as a host numpy array (None stays None): a tensor is
    copied off its device in one transfer, half precision widened to
    float32."""
    if a is None:
        return None
    if torch.is_tensor(a):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        a = a.cpu().numpy()
    return np.asarray(a, dtype=dtype)


class ConfusionMatrix:
    def __init__(self, n_classes: int):
        self.n = n_classes
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, c: int) -> int:
        return int(self.matrix[c, :].sum())

    def predicted_total(self, c: int) -> int:
        return int(self.matrix[:, c].sum())

    def total(self) -> int:
        return int(self.matrix.sum())


class Prediction:
    """One prediction with its source-record metadata (reference
    ``eval/meta/Prediction.java:1``)."""

    def __init__(self, actual_class: int, predicted_class: int,
                 record_meta_data=None):
        self.actual_class = actual_class
        self.predicted_class = predicted_class
        self.record_meta_data = record_meta_data

    def __repr__(self):
        return (
            f"Prediction(actualClass={self.actual_class},"
            f"predictedClass={self.predicted_class},"
            f"RecordMetaData={self.record_meta_data})"
        )

    def __eq__(self, other):
        return (
            isinstance(other, Prediction)
            and self.actual_class == other.actual_class
            and self.predicted_class == other.predicted_class
            and self.record_meta_data == other.record_meta_data
        )


class Evaluation:
    """Accuracy/precision/recall/F1 + confusion matrix; with record
    metadata, per-prediction attribution (reference ``eval():202`` +
    ``getPredictionErrors``/``getPredictionsByActualClass``)."""

    def __init__(self, n_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None):
        self.labels = labels
        self.n_classes = n_classes or (len(labels) if labels else None)
        self.confusion: Optional[ConfusionMatrix] = None
        # (actual, predicted) -> [Prediction]; populated only when
        # record metadata is supplied (reference addToMetaConfusionMatrix)
        self._meta: Dict[tuple, List[Prediction]] = defaultdict(list)

    def _ensure(self, n: int) -> None:
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None,
             record_meta_data: Optional[List] = None) -> None:
        """labels/predictions: one-hot or probability arrays,
        ``[batch, nClasses]`` or RNN ``[batch, nClasses, time]`` with
        optional ``[batch, time]`` mask (reference ``eval():190`` and
        ``evalTimeSeries``). ``record_meta_data`` (reference ``:202``):
        one metadata object per example; predictions become queryable
        via ``get_prediction_errors`` etc."""
        labels = host_array(labels)
        predictions = host_array(predictions)
        mask = host_array(mask)
        if labels.ndim == 3:
            # -> rows per (example, timestep), mask-filtered
            b, c, t = labels.shape
            lab2 = labels.transpose(0, 2, 1).reshape(-1, c)
            pred2 = predictions.transpose(0, 2, 1).reshape(-1, c)
            meta2 = (
                [m for m in record_meta_data for _ in range(t)]
                if record_meta_data is not None else None
            )
            if mask is not None:
                keep = np.asarray(mask).reshape(-1).astype(bool)
                lab2, pred2 = lab2[keep], pred2[keep]
                if meta2 is not None:
                    meta2 = [m for m, k in zip(meta2, keep) if k]
            self.eval(lab2, pred2, record_meta_data=meta2)
            return
        if labels.ndim == 2 and labels.shape[1] == 1:
            # single output column = binary with 0.5 threshold
            # (reference eval() nCols == 1 branch)
            self._ensure(2)
            actual = (labels[:, 0] > 0.5).astype(np.int64)
            guess = (predictions[:, 0] > 0.5).astype(np.int64)
        else:
            self._ensure(labels.shape[1])
            actual = labels.argmax(axis=1)
            guess = predictions.argmax(axis=1)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            actual, guess = actual[keep], guess[keep]
            if record_meta_data is not None:
                record_meta_data = [
                    m for m, k in zip(record_meta_data, keep) if k
                ]
        for i, (a, g) in enumerate(zip(actual, guess)):
            a, g = int(a), int(g)
            self.confusion.add(a, g)
            if record_meta_data is not None and i < len(record_meta_data):
                self._meta[(a, g)].append(
                    Prediction(a, g, record_meta_data[i])
                )

    # -- record-metadata queries (reference Evaluation meta methods) ----

    def get_prediction_errors(self) -> List[Prediction]:
        """All misclassified predictions (reference
        ``getPredictionErrors``)."""
        out: List[Prediction] = []
        for (a, g), preds in sorted(self._meta.items()):
            if a != g:
                out.extend(preds)
        return out

    def get_predictions_by_actual_class(self, c: int) -> List[Prediction]:
        out: List[Prediction] = []
        for (a, _), preds in sorted(self._meta.items()):
            if a == c:
                out.extend(preds)
        return out

    def get_predictions_by_predicted_class(self, c: int) -> List[Prediction]:
        out: List[Prediction] = []
        for (_, g), preds in sorted(self._meta.items()):
            if g == c:
                out.extend(preds)
        return out

    def get_predictions(self, actual: int, predicted: int
                        ) -> List[Prediction]:
        return list(self._meta.get((actual, predicted), ()))

    # -- metrics -------------------------------------------------------

    def accuracy(self) -> float:
        m = self.confusion.matrix
        tot = m.sum()
        return float(np.trace(m) / tot) if tot else 0.0

    def precision(self, c: Optional[int] = None) -> float:
        if c is not None:
            pt = self.confusion.predicted_total(c)
            return self.confusion.get_count(c, c) / pt if pt else 0.0
        vals = [self.precision(i) for i in range(self.n_classes)
                if self.confusion.predicted_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c: Optional[int] = None) -> float:
        if c is not None:
            at = self.confusion.actual_total(c)
            return self.confusion.get_count(c, c) / at if at else 0.0
        vals = [self.recall(i) for i in range(self.n_classes)
                if self.confusion.actual_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c: Optional[int] = None) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, c: int) -> float:
        fp = self.confusion.predicted_total(c) - self.confusion.get_count(c, c)
        neg = self.confusion.total() - self.confusion.actual_total(c)
        return fp / neg if neg else 0.0

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Combine partial evaluations (reference: distributed eval
        ``EvaluationReduceFunction``)."""
        if other.confusion is None:
            return self
        self._ensure(other.n_classes)
        self.confusion.matrix += other.confusion.matrix
        for key, preds in other._meta.items():
            self._meta[key].extend(preds)
        return self

    def _label(self, c: int) -> str:
        if self.labels and c < len(self.labels):
            return str(self.labels[c])
        return str(c)

    def stats(self, print_confusion: bool = True) -> str:
        """Summary + per-class breakdown + confusion matrix (reference
        ``Evaluation.stats()`` layout)."""
        lines = [
            "========================Evaluation======================",
            f" Examples:  {self.confusion.total()}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "",
            " Per-class:",
        ]
        for c in range(self.n_classes):
            lines.append(
                f"  {self._label(c):>12}: precision={self.precision(c):.4f} "
                f"recall={self.recall(c):.4f} f1={self.f1(c):.4f} "
                f"(n={self.confusion.actual_total(c)})"
            )
        if print_confusion:
            lines += ["", " Confusion matrix (rows=actual, cols=predicted):"]
            # identical prefix + field widths as the data rows so the
            # column headers sit over their counts
            header = " ".join(
                f"{self._label(c):>8}" for c in range(self.n_classes)
            )
            lines.append(f"  {'':>12} {header}")
            for a in range(self.n_classes):
                row = " ".join(
                    f"{self.confusion.get_count(a, p):>8d}"
                    for p in range(self.n_classes)
                )
                lines.append(f"  {self._label(a):>12} {row}")
        lines.append(
            "========================================================"
        )
        return "\n".join(lines)


class RegressionEvaluation:
    """MSE/MAE/RMSE/R^2 per column (reference
    ``eval/RegressionEvaluation.java``)."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n_columns = n_columns
        self._sum_sq = None
        self._sum_abs = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_lp = None
        self._count = 0

    def eval(self, labels, predictions,
             mask: Optional[np.ndarray] = None) -> None:
        labels = host_array(labels, np.float64)
        predictions = host_array(predictions, np.float64)
        mask = host_array(mask)
        if labels.ndim == 3:
            c = labels.shape[1]
            labels = labels.transpose(0, 2, 1).reshape(-1, c)
            predictions = predictions.transpose(0, 2, 1).reshape(-1, c)
            if mask is not None:
                keep = np.asarray(mask).reshape(-1).astype(bool)
                labels, predictions = labels[keep], predictions[keep]
        n = labels.shape[1]
        if self._sum_sq is None:
            self.n_columns = n
            self._sum_sq = np.zeros(n)
            self._sum_abs = np.zeros(n)
            self._sum_label = np.zeros(n)
            self._sum_label_sq = np.zeros(n)
            self._sum_pred = np.zeros(n)
            self._sum_lp = np.zeros(n)
        d = predictions - labels
        self._sum_sq += (d * d).sum(axis=0)
        self._sum_abs += np.abs(d).sum(axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_label_sq += (labels * labels).sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._sum_lp += (labels * predictions).sum(axis=0)
        self._count += labels.shape[0]

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_sq[col] / self._count)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._count)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def correlation_r2(self, col: int) -> float:
        """Pearson correlation between labels and predictions
        (reference ``RegressionEvaluation.correlationR2``)."""
        n = self._count
        num = n * self._sum_lp[col] - self._sum_label[col] * self._sum_pred[col]
        den_l = n * self._sum_label_sq[col] - self._sum_label[col] ** 2
        # n*sum(p^2) reconstructed from sum_sq = sum((p-l)^2):
        # sum(p^2) = sum_sq + 2*sum(lp) - sum(l^2)
        sum_pred_sq = self._sum_sq[col] + 2 * self._sum_lp[col] - \
            self._sum_label_sq[col]
        den_p = n * sum_pred_sq - self._sum_pred[col] ** 2
        den = np.sqrt(den_l * den_p) if den_l * den_p > 0 else 0.0
        return float(num / den) if den else 0.0

    def r_squared(self, col: int) -> float:
        """Coefficient of determination 1 - SSres/SStot."""
        n = self._count
        ss_res = self._sum_sq[col]
        ss_tot = self._sum_label_sq[col] - self._sum_label[col] ** 2 / n
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_sq / self._count))

    def stats(self) -> str:
        cols = range(self.n_columns)
        return "\n".join(
            f"col {c}: MSE={self.mean_squared_error(c):.6f} "
            f"MAE={self.mean_absolute_error(c):.6f} "
            f"RMSE={self.root_mean_squared_error(c):.6f} "
            f"R2={self.correlation_r2(c):.4f}"
            for c in cols
        )

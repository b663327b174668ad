"""ROC / AUC (reference ``eval/ROC.java`` — thresholded ROC for binary
classifiers, with AUC by trapezoidal integration), plus the
multi-class one-vs-all variant.

Counterpart of ``deeplearning4j_tpu/eval/roc.py``; inputs may be numpy
arrays or tensors (one host copy per ``eval`` call)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import host_array


class ROC:
    """Binary ROC. ``threshold_steps`` mirrors the reference's
    constructor; probabilities are binned into thresholds rather than
    sorted exactly (same algorithm as ``ROC.java``)."""

    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = threshold_steps
        n = threshold_steps + 1
        self._tp = np.zeros(n, dtype=np.int64)
        self._fp = np.zeros(n, dtype=np.int64)
        self._fn = np.zeros(n, dtype=np.int64)
        self._tn = np.zeros(n, dtype=np.int64)
        self._count = 0

    def eval(self, labels, predictions,
             mask: Optional[np.ndarray] = None) -> None:
        """labels: [n] or [n, 2] one-hot (positive = column 1);
        predictions: matching probabilities."""
        labels = host_array(labels)
        predictions = host_array(predictions)
        mask = host_array(mask)
        if labels.ndim == 2 and labels.shape[1] == 2:
            pos = labels[:, 1]
            prob = predictions[:, 1]
        else:
            pos = labels.reshape(-1)
            prob = predictions.reshape(-1)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1).astype(bool)
            pos, prob = pos[keep], prob[keep]
        pos = pos > 0.5
        thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
        for i, t in enumerate(thresholds):
            pred_pos = prob >= t
            self._tp[i] += int(np.sum(pred_pos & pos))
            self._fp[i] += int(np.sum(pred_pos & ~pos))
            self._fn[i] += int(np.sum(~pred_pos & pos))
            self._tn[i] += int(np.sum(~pred_pos & ~pos))
        self._count += pos.size

    def get_roc_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)] (reference ``getResults``)."""
        out = []
        thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
        for i, t in enumerate(thresholds):
            p = self._tp[i] + self._fn[i]
            n = self._fp[i] + self._tn[i]
            tpr = self._tp[i] / p if p else 0.0
            fpr = self._fp[i] / n if n else 0.0
            out.append((float(t), float(fpr), float(tpr)))
        return out

    def calculate_auc(self) -> float:
        """Trapezoidal AUC (reference ``calculateAUC``)."""
        pts = sorted((fpr, tpr) for _, fpr, tpr in self.get_roc_curve())
        pts = [(0.0, 0.0)] + pts + [(1.0, 1.0)]
        auc = 0.0
        for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
            auc += (x1 - x0) * (y0 + y1) / 2.0
        return float(auc)


class ROCMultiClass:
    """One-vs-all ROC per class (reference ``eval/ROCMultiClass.java``)."""

    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = threshold_steps
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions,
             mask: Optional[np.ndarray] = None) -> None:
        labels = host_array(labels)
        predictions = host_array(predictions)
        mask = host_array(mask)
        n_classes = labels.shape[1]
        if not self._rocs:
            self._rocs = [ROC(self.threshold_steps) for _ in range(n_classes)]
        for c in range(n_classes):
            self._rocs[c].eval(labels[:, c], predictions[:, c], mask)

    def calculate_auc(self, c: int) -> float:
        return self._rocs[c].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))

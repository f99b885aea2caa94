"""Classification metrics: overall accuracy, average accuracy, Cohen's kappa,
and per-class accuracy, computed from a confusion matrix.

Port-owned numpy copy of ``confusion_matrix``, ``Metrics`` and
``classification_metrics`` from ``hsimae_tpu/utils/metrics.py``; numerically
equivalent to sklearn's ``accuracy_score``, mean ``recall_score`` and
``cohen_kappa_score``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Metrics:
    oa: float
    aa: float
    kappa: float
    per_class: np.ndarray  # recall per class, shape [n_classes]

    @property
    def mean3(self) -> float:
        """(oa + aa + kappa) / 3 — the reference's model-selection scalar
        (the reference's ``Model_Finetuning.py``)."""
        return (self.oa + self.aa + self.kappa) / 3.0

    def __repr__(self):
        return f"Metrics(oa={self.oa:.4f}, aa={self.aa:.4f}, kappa={self.kappa:.4f})"


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64).reshape(-1)
    y_pred = np.asarray(y_pred, dtype=np.int64).reshape(-1)
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def metrics_from_confusion(cm: np.ndarray) -> Metrics:
    """``per_class`` is ALIGNED by class index (length n_classes); classes
    absent from both y_true and y_pred get recall 0 but are excluded from AA
    (sklearn averages recall over the union of observed labels)."""
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    diag = np.diag(cm)
    row = cm.sum(axis=1)  # true counts per class
    col = cm.sum(axis=0)  # predicted counts per class

    oa = diag.sum() / max(total, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.where(row > 0, diag / np.maximum(row, 1.0), 0.0)
    # sklearn's recall_score(average=None) averages over classes present in
    # y_true OR y_pred; classes never seen get recall 0 and are included.
    present = (row > 0) | (col > 0)
    aa = per_class[present].mean() if present.any() else 0.0

    pe = (row * col).sum() / max(total * total, 1.0)
    kappa = (oa - pe) / (1.0 - pe) if pe < 1.0 else 0.0
    return Metrics(oa=float(oa), aa=float(aa), kappa=float(kappa),
                   per_class=per_class)


def classification_metrics(y_true, y_pred, ignore_zero: bool = True) -> Metrics:
    """Metrics on the reference's convention: label 0 is background.

    The reference filters to ``gt != 0`` pixels and shifts labels by -1 before
    scoring (the reference's ``Model_Finetuning.py``). ``y_true``/
    ``y_pred`` here carry raw (0-based-with-background) labels. A background
    PREDICTION (shifted to -1) is sklearn's extra label: always wrong, its
    zero-recall included in AA — mapped here to a trailing bucket column.
    """
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if ignore_zero:
        keep = y_true != 0
        y_true = y_true[keep] - 1
        y_pred = y_pred[keep] - 1
    n = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    invalid = y_pred < 0
    if invalid.any():
        y_pred = np.where(invalid, n, y_pred)  # extra always-wrong bucket
        m = metrics_from_confusion(confusion_matrix(y_true, y_pred, n + 1))
        return Metrics(oa=m.oa, aa=m.aa, kappa=m.kappa,
                       per_class=m.per_class[:n])
    return metrics_from_confusion(confusion_matrix(y_true, y_pred, n))

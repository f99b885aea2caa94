"""Confusion-matrix accumulation on the device.

Counterpart of ``hsimae_tpu/ops/metrics_ops.py`` (a one-hot product there, a
weighted ``index_add_`` at ``y_true * C + y_pred`` here; with weights
of 0 and 1 the counts are whole numbers, which float32 sums exactly in any
order): evaluation loops
keep one ``[C, C]`` float32 matrix on the device and fetch it once a pass,
never the logits.
"""

from __future__ import annotations

from typing import Optional

import torch


def confusion_matrix_op(y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int,
                        weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B]`` labels and ``[B]`` predictions -> ``[n_classes, n_classes]``
    float32 counts (rows true, columns predicted), each pair weighted by
    ``weight`` (1 when None)."""
    idx = y_true.long() * n_classes + y_pred.long()
    w = (torch.ones_like(idx, dtype=torch.float32) if weight is None
         else weight.to(torch.float32))
    cm = torch.zeros(n_classes * n_classes, dtype=torch.float32, device=idx.device)
    return cm.index_add_(0, idx, w).reshape(n_classes, n_classes)


def update_confusion(cm: torch.Tensor, y_true: torch.Tensor, y_pred: torch.Tensor,
                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cm`` plus the counts of one batch."""
    return cm + confusion_matrix_op(y_true, y_pred, cm.shape[0], weight)

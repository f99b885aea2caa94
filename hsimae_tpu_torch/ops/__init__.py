"""The fused encoder block (its hand-written kernels and plain version) and
the on-device metrics op. Imports nothing of ``hsimae_tpu_torch.models``: a
serving artifact loads where the model source is not deployed."""

from hsimae_tpu_torch.ops.metrics_ops import confusion_matrix_op, update_confusion
from hsimae_tpu_torch.ops.fused_block import fused_encoder_block

__all__ = [
    "confusion_matrix_op",
    "update_confusion",
    "fused_encoder_block",
]

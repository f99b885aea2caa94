"""Serving: exported classifier artifacts.

Counterpart of ``hsimae_tpu/serving``. The classifier forward is exported
with :func:`torch.export.export` at a fixed set of batch buckets, for the
CPU and the CUDA card, and bundled with the weights and the model metadata
in one file. The artifact loads and runs without the model source; on the
card its encoder blocks run the hand-written fused-block kernels through
the registered op ``torch.ops.hsimae.fused_block``.
"""

from hsimae_tpu_torch.serving.export import (
    ExportedClassifier,
    export_classifier,
    export_module_classifier,
    load_classifier,
)

__all__ = ["ExportedClassifier", "export_classifier", "export_module_classifier",
           "load_classifier"]

from hsimae_tpu_torch.utils.seed import seed_everything
from hsimae_tpu_torch.utils.metrics import classification_metrics, Metrics
from hsimae_tpu_torch.utils.colormap import label_to_colormap
from hsimae_tpu_torch.utils.logger import MetricLogger
from hsimae_tpu_torch.utils.early_stop import EarlyStopping

__all__ = [
    "seed_everything",
    "classification_metrics",
    "Metrics",
    "label_to_colormap",
    "MetricLogger",
    "EarlyStopping",
]

from hsimae_tpu_torch.bench.registry import (
    ALL_BASELINES,
    DATASETS,
    BaselineSpec,
    get_baseline_spec,
)
from hsimae_tpu_torch.bench.harness import (
    BaselineRun,
    epoch_lr,
    evaluate_baseline,
    preprocess_scene,
    train_baseline,
)

__all__ = [
    "ALL_BASELINES",
    "DATASETS",
    "BaselineSpec",
    "get_baseline_spec",
    "BaselineRun",
    "epoch_lr",
    "evaluate_baseline",
    "preprocess_scene",
    "train_baseline",
]

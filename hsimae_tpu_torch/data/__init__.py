from hsimae_tpu_torch.data.gwpca import apply_gwpca, pca_fit_transform, split_band_groups
from hsimae_tpu_torch.data.windows import window_starts, patch_grid_indices, PretrainCutIndex
from hsimae_tpu_torch.data.sampling import (
    sample_per_class,
    train_val_split,
    DualSceneSplit,
    dual_scene_split,
)
from hsimae_tpu_torch.data.synthetic import make_synthetic_scene, make_textured_scene
from hsimae_tpu_torch.data.datasets import (
    REGISTRY as DATASET_REGISTRY,
    get_data_path,
    load_dataset,
    load_pretrain_corpus,
)
from hsimae_tpu_torch.data.pipeline import ScenePatchSource, MultiScenePatchSource, augment_flips

__all__ = [
    "apply_gwpca",
    "pca_fit_transform",
    "split_band_groups",
    "window_starts",
    "patch_grid_indices",
    "PretrainCutIndex",
    "sample_per_class",
    "train_val_split",
    "DualSceneSplit",
    "dual_scene_split",
    "make_synthetic_scene",
    "make_textured_scene",
    "ScenePatchSource",
    "MultiScenePatchSource",
    "augment_flips",
    "DATASET_REGISTRY",
    "get_data_path",
    "load_dataset",
    "load_pretrain_corpus",
]

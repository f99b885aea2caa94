"""Per-model benchmark configuration registry.

Counterpart of ``hsimae_tpu/bench/registry.py``, field for field: each
model's constructor arguments per dataset and its optimizer / schedule /
epochs / patch size / preprocessing (the reference harness's
``model_config``):

| model          | patch | optimizer          | schedule              | epochs | notes |
|----------------|-------|--------------------|-----------------------|--------|-------|
| HybridFormer   | 15    | AdamW wd 0         | none                  | 200    | norm (1,0) |
| GSC-ViT        | 8     | AdamW wd 0.05      | none                  | 200    | norm + per-band center |
| DCTN           | 15    | AdamW wd 0         | plateau f=0.1 p=50    | 200    | norm (1,0) |
| SSFTT          | 13/9  | AdamW wd 0         | none                  | 200    | PCA 30 whiten |
| SSRN           | 9     | RMSprop m 0.9      | plateau f=0.5 p=10    | 200    | norm (1,0) |
| FDSSC          | 9     | RMSprop m 0.9      | plateau f=0.5 p=10    | 400    | early-stop 30 |
| DBDA           | 9     | AdamW wd 0         | cosine w/u 10%        | 200    | early-stop 30 |
| SpectralFormer | 7     | AdamW wd 0.005     | step //10 gamma 0.9   | 1000   | norm (1,0) |

Datasets carry (bands, n_classes incl. background):
Salinas (204, 17), PaviaU (103, 10), Houston2013 (144, 16), LongKou (270, 10).
Synthetic datasets pass explicit (bands, n_classes).

``build(bands, n_classes, dataset)`` returns a port net initialised with
torch's defaults; the harness initialises it as flax does
(:func:`hsimae_tpu_torch.models.baselines.common.init_like_flax`). Where a
port net needs a width the JAX zoo reads from its first input, the build
passes it: SSFTT's ``bands`` (the PCA count its input has), SSRN's
``patch_size``. SpectralFormer is built in its CAF mode, the only one the
registry uses (the port has no other). JAX's ``optimizer_key`` (the key of
its compiled-step cache) has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from hsimae_tpu_torch.models import baselines as zoo

DATASETS = {
    "Salinas": dict(bands=204, n_classes=17),
    "PaviaU": dict(bands=103, n_classes=10),
    "Houston2013": dict(bands=144, n_classes=16),
    "LongKou": dict(bands=270, n_classes=10),
}


@dataclasses.dataclass
class BaselineSpec:
    name: str
    build: Callable  # (bands, n_classes, dataset) -> nn.Module
    patch_size: int
    epochs: int
    optimizer: str = "adamw"  # adamw | rmsprop
    weight_decay: float = 0.0
    scheduler: str = "none"  # none | plateau | cosine | step
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    step_gamma: float = 0.9
    early_stop: bool = False
    batch_size: int = 64
    pca_nc: Optional[int] = None
    pca_whiten: bool = True
    norm: Optional[Tuple[float, float]] = (1.0, 0.0)
    center: bool = False


def _ssftt_patch(dataset: str) -> int:
    return 9 if dataset == "Houston2013" else 13


def _ssftt_k3d(dataset: str) -> int:
    return 24 if dataset == "Houston2013" else 8


def _ssftt_k2d(dataset: str) -> int:
    return {"Salinas": 64, "PaviaU": 32, "Houston2013": 48, "LongKou": 64}.get(dataset, 64)


def get_baseline_spec(model_name: str, dataset: str = "PaviaU") -> BaselineSpec:
    if model_name == "SSRN":
        return BaselineSpec(
            "SSRN", lambda b, n, d: zoo.SSRN(bands=b, num_classes=n, patch_size=9),
            patch_size=9, epochs=200, optimizer="rmsprop",
            scheduler="plateau", plateau_factor=0.5, plateau_patience=10,
        )
    if model_name == "FDSSC":
        return BaselineSpec(
            "FDSSC", lambda b, n, d: zoo.FDSSC(bands=b, num_classes=n),
            patch_size=9, epochs=400, optimizer="rmsprop",
            scheduler="plateau", plateau_factor=0.5, plateau_patience=10,
            early_stop=True,
        )
    if model_name == "DBDA":
        return BaselineSpec(
            "DBDA", lambda b, n, d: zoo.DBDA(bands=b, num_classes=n),
            patch_size=9, epochs=200, scheduler="cosine", early_stop=True,
        )
    if model_name == "SSFTT":
        return BaselineSpec(
            "SSFTT",
            lambda b, n, d: zoo.SSFTT(num_classes=n, kernel_3d=_ssftt_k3d(d),
                                      kernel_2d=_ssftt_k2d(d), num_tokens=4,
                                      dim=64, heads=4, bands=b),
            patch_size=_ssftt_patch(dataset), epochs=200,
            pca_nc=30, pca_whiten=True, norm=None,
        )
    if model_name == "SpectralFormer":
        return BaselineSpec(
            "SpectralFormer",
            lambda b, n, d: zoo.SpectralFormer(
                image_size=7, near_band=3, num_bands=b, num_classes=n,
                dim=64, depth=5, heads=4, mlp_dim=8, dropout=0.1),
            patch_size=7, epochs=1000, weight_decay=0.005, scheduler="step",
        )
    if model_name == "HybridFormer":
        return BaselineSpec(
            "HybridFormer",
            lambda b, n, d: zoo.HybridFormer(
                image_size=15, patch_sizes=(3, 5), num_classes=n, dim=100,
                depth=2, heads=4, channels=b, dropout=0.2, emb_dropout=0.2),
            patch_size=15, epochs=200,
        )
    if model_name == "GSC-ViT":
        heads = (4, 4, 4) if dataset == "LongKou" else (1, 1, 1)
        return BaselineSpec(
            "GSC-ViT",
            lambda b, n, d: zoo.GSCViT(
                num_classes=n, channels=b, heads=heads, depth=(1, 1, 1),
                group_spatial_size=(4, 4, 4), dropout=0.1,
                padding=(1, 1, 1), dims=(256, 128, 64), num_groups=(16, 16, 16)),
            patch_size=8, epochs=200, weight_decay=0.05, center=True,
        )
    if model_name == "DCTN":
        dims = (440, 440, 512, 512) if dataset == "Salinas" else (320, 320, 512, 512)
        groups, gw, pd = ((11, 40, 55) if dataset == "Salinas" else (5, 64, 40))
        return BaselineSpec(
            "DCTN",
            lambda b, n, d: zoo.DCTN(
                layers=(2, 2, 5, 3), bands=b, num_classes=n, embed_dims=dims,
                transitions=(False, True, False, False), segment_dim=(8, 8, 4, 4),
                mlp_ratios=(3.0, 3.0, 3.0, 3.0), groups=groups, groups_width=gw,
                pool_depth=pd),
            patch_size=15, epochs=200, scheduler="plateau",
            plateau_factor=0.1, plateau_patience=50,
        )
    if model_name == "RSSAN":
        # present in the reference zoo but not wired into its harness; the
        # RSSAN paper's configuration
        return BaselineSpec(
            "RSSAN", lambda b, n, d: zoo.RSSAN(bands=b, num_classes=n),
            patch_size=9, epochs=200,
        )
    if model_name == "HiT":
        return BaselineSpec(
            "HiT",
            lambda b, n, d: zoo.HiT(bands=b, num_classes=n, layers=(2, 2, 4, 2)),
            patch_size=15, epochs=200,
        )
    raise KeyError(f"unknown baseline {model_name!r}")


ALL_BASELINES = ["SSRN", "FDSSC", "DBDA", "SSFTT", "SpectralFormer",
                 "HybridFormer", "GSC-ViT", "DCTN", "RSSAN", "HiT"]

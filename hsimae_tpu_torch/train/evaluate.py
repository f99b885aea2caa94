"""Full-scene per-pixel classification and its metrics.

Counterpart of ``classify_scene`` / ``evaluate_scene`` in
``hsimae_tpu/train/evaluate.py``:

* an inference model (encoder + AGG head, no decoder) takes the given
  weights by key intersection and must cover ``cls_head``;
* every pixel gets a patch centred on it (symmetric padding), gathered on
  the device in large batches;
* background is excluded at argmax over ``logits[:, 1:]``, then +1, on the
  device, so each batch fetches ``[B]`` int32 labels;
* OA / AA / kappa / per-class are computed on ``test_gt != 0`` pixels.

Data-parallel meshes and colormaps are not ported yet.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from hsimae_tpu_torch.config import EvalConfig, ModelConfig
from hsimae_tpu_torch.data.pipeline import ScenePatchSource, batch_indices
from hsimae_tpu_torch.models.hsimae import CLS_HEAD_NAME, HSIMAE, build_hsi_vit
from hsimae_tpu_torch.utils.metrics import Metrics, classification_metrics


@dataclasses.dataclass
class SceneEvalResult:
    pred_map: np.ndarray  # [h, w] predicted labels (1-based; never 0)
    metrics: Metrics


def _load_weights(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Key-intersection restore: keys the model lacks (a decoder) are
    ignored; a missing ``cls_head`` raises, other missing keys warn."""
    own = model.state_dict()
    usable = {k: v for k, v in state_dict.items() if k in own}
    missing = [k for k in own if k not in usable]
    if any(k.split(".")[0] == CLS_HEAD_NAME for k in missing):
        raise ValueError(
            f"weights do not cover {CLS_HEAD_NAME}: wrong num_classes or a "
            f"pretrain-only checkpoint? (matched {len(usable)} of {len(own)} keys)")
    if missing:
        warnings.warn(f"{len(missing)} parameters stay at their seeded init "
                      f"(ignored {len(state_dict) - len(usable)} source keys)", stacklevel=3)
    model.load_state_dict(usable, strict=False)


def build_classifier(
    params: Optional[Dict[str, torch.Tensor]],
    model_cfg: ModelConfig,
    num_classes: int,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> HSIMAE:
    """The inference model on ``device`` in eval mode. ``params`` is a
    ``state_dict`` (reference names); ``None`` keeps the weights of a seeded
    init (``seed``)."""
    model = build_hsi_vit(model_cfg, num_classes, seed=seed, device="cpu")
    if params is not None:
        _load_weights(model, params)
    return model.to(device)


@torch.inference_mode()
def predict_scene(model: HSIMAE, scene: np.ndarray, cfg: EvalConfig = EvalConfig()) -> np.ndarray:
    """Predict a label for every pixel with a built model -> [h, w] int32
    (1-based). The scene goes to the model's device."""
    device = model.pos_embed.device
    source = ScenePatchSource(scene, model.cfg.img_size, device=device)
    h, w = scene.shape[:2]
    n = h * w
    bs = min(cfg.batch_size, n)
    out = np.zeros(n, np.int32)
    for chunk, valid in batch_indices(n, bs, shuffle=False):
        logits = model.classify(source.gather_pixels(chunk))
        pred = (torch.argmax(logits[:, 1:], dim=-1).to(torch.int32) + 1).cpu().numpy()
        out[chunk[valid]] = pred[valid]
    return out.reshape(h, w)


def classify_scene(
    scene: np.ndarray,
    params: Optional[Dict[str, torch.Tensor]],
    model_cfg: ModelConfig,
    num_classes: int,
    cfg: EvalConfig = EvalConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> np.ndarray:
    """Predict a label for every pixel -> [h, w] int32 (1-based):
    :func:`build_classifier` then :func:`predict_scene`."""
    model = build_classifier(params, model_cfg, num_classes, device, seed)
    return predict_scene(model, scene, cfg)


def evaluate_scene(
    scene: np.ndarray,
    test_gt: np.ndarray,
    params: Optional[Dict[str, torch.Tensor]],
    model_cfg: ModelConfig,
    num_classes: int,
    cfg: EvalConfig = EvalConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> SceneEvalResult:
    pred_map = classify_scene(scene, params, model_cfg, num_classes, cfg, device, seed)
    return SceneEvalResult(pred_map=pred_map, metrics=classification_metrics(test_gt, pred_map))

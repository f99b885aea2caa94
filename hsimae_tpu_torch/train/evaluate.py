"""Full-scene per-pixel classification, its metrics and colormaps.

Counterpart of ``classify_scene`` / ``evaluate_scene`` in
``hsimae_tpu/train/evaluate.py``:

* an inference model (encoder + AGG head, no decoder) takes the given
  weights by key and shape intersection (``partial_restore``) and must
  cover ``cls_head``;
* every pixel gets a patch centred on it (symmetric padding), gathered on
  the device in large batches;
* background is excluded at argmax over ``logits[:, 1:]``, then +1, on the
  device, so each batch fetches ``[B]`` int32 labels;
* OA / AA / kappa / per-class are computed on ``test_gt != 0`` pixels;
* with a ``save_dir``, the map is written as ``<name>_pred.png`` and, with
  background where ``test_gt == 0``, ``<name>_pred_masked.png``.

* :func:`classify_scene_artifact` / :func:`evaluate_scene_artifact` do the
  same through a loaded serving artifact
  (:class:`hsimae_tpu_torch.serving.ExportedClassifier`): no model source;
* data parallelism: under a process group (``torch.distributed.run``, or with
  a ``mesh``), the batch is padded to a multiple of the data axis and each
  rank classifies its contiguous share of every batch, on the fused-block
  kernel, from its own resident copy of the scene. Its ``[B / P]`` int32
  labels stay on its device until one all-gather at the end of the scene;
  every rank returns the whole map, and rank 0 alone writes the PNGs.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from hsimae_tpu_torch.checkpoints.io import partial_restore
from hsimae_tpu_torch.config import EvalConfig, ModelConfig
from hsimae_tpu_torch.data.pipeline import ScenePatchSource, batch_indices
from hsimae_tpu_torch.models.hsimae import CLS_HEAD_NAME, HSIMAE, build_hsi_vit
from hsimae_tpu_torch.parallel.mesh import (
    all_gather_rows,
    data_size,
    default_mesh,
    is_main_process,
    mesh_slice,
    pad_to_multiple,
)
from hsimae_tpu_torch.utils.colormap import save_colormap
from hsimae_tpu_torch.utils.metrics import Metrics, classification_metrics


@dataclasses.dataclass
class SceneEvalResult:
    pred_map: np.ndarray  # [h, w] predicted labels (1-based; never 0)
    metrics: Metrics
    # with the ranks the evaluate CLI starts itself (--dp): each rank's
    # kernel launches, by kernel name, in rank order
    launches_by_rank: Optional[list] = None


def _load_weights(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """:func:`partial_restore`, so keys the model lacks (a decoder) and
    tensors of another shape (a head with another class count) are ignored,
    but a ``cls_head`` left uncovered raises; other uncovered keys warn."""
    loaded, skipped = partial_restore(model, state_dict, verbose=False)
    covered = set(loaded)
    missing = [k for k in model.state_dict() if k not in covered]
    if any(k.split(".")[0] == CLS_HEAD_NAME for k in missing):
        raise ValueError(
            f"weights do not cover {CLS_HEAD_NAME}: wrong num_classes or a "
            f"pretrain-only checkpoint? (matched {len(loaded)} of "
            f"{len(loaded) + len(missing)} keys)")
    if missing:
        warnings.warn(f"{len(missing)} parameters stay at their seeded init "
                      f"(ignored {len(skipped)} source keys)", stacklevel=3)


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
def predict_scene(model: HSIMAE, scene: np.ndarray, cfg: EvalConfig = EvalConfig(),
                  mesh=None) -> np.ndarray:
    """Predict a label for every pixel with a built model -> [h, w] int32
    (1-based). The scene goes to the model's device. With a ``mesh``, this
    rank classifies its share of every batch and the map is gathered from
    every rank (module docstring)."""
    device = model.pos_embed.device
    source = ScenePatchSource(scene, model.cfg.img_size, device=device)
    h, w = scene.shape[:2]
    n = h * w
    bs = pad_to_multiple(min(cfg.batch_size, n), data_size(mesh))
    own = mesh_slice(bs, mesh)
    out = np.zeros(n, np.int32)
    batches = list(batch_indices(n, bs, shuffle=False))
    preds = []
    for chunk, valid in batches:
        logits = model.classify(source.gather_pixels(chunk[own]))
        pred = torch.argmax(logits[:, 1:], dim=-1).to(torch.int32) + 1
        if mesh is None:
            out[chunk[valid]] = pred.cpu().numpy()[valid]
        else:
            preds.append(pred)
    if mesh is not None:
        # [P, batches * B/P] -> [batches, P, B/P]: batch-major, then rank
        shares = all_gather_rows(torch.cat(preds), mesh).reshape(data_size(mesh), len(batches), -1)
        labels = shares.transpose(0, 1).reshape(len(batches), bs).cpu().numpy()
        for (chunk, valid), pred in zip(batches, labels):
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
    mesh=None,
) -> np.ndarray:
    """Predict a label for every pixel -> [h, w] int32 (1-based):
    :func:`build_classifier` then :func:`predict_scene`. ``mesh`` defaults
    to :func:`default_mesh`: data-parallel under a process group."""
    model = build_classifier(params, model_cfg, num_classes, device, seed)
    return predict_scene(model, scene, cfg, mesh if mesh is not None else default_mesh())


@torch.inference_mode()
def classify_scene_artifact(scene: np.ndarray, classifier, cfg: EvalConfig = EvalConfig()
                            ) -> np.ndarray:
    """Predict a label for every pixel through a loaded serving artifact ->
    [h, w] int32 (1-based, background excluded, as :func:`classify_scene`).
    Each batch is gathered on the artifact's device and stays there; the
    artifact's buckets pad it."""
    img_size = int(classifier.model_meta.get("img_size", 9))
    source = ScenePatchSource(scene, img_size, device=classifier.device)
    h, w = scene.shape[:2]
    n = h * w
    bs = min(cfg.batch_size, n)
    out = np.zeros(n, np.int32)
    for chunk, valid in batch_indices(n, bs, shuffle=False):
        pred = classifier.predict(source.gather_pixels(chunk)).cpu().numpy()
        out[chunk[valid]] = pred[valid]
    return out.reshape(h, w)


def _finish_eval(pred_map: np.ndarray, test_gt: np.ndarray, cfg: EvalConfig,
                 save_dir: Optional[str], name: str) -> SceneEvalResult:
    m = classification_metrics(test_gt, pred_map)
    if save_dir and cfg.save_colormaps and is_main_process():
        os.makedirs(save_dir, exist_ok=True)
        save_colormap(os.path.join(save_dir, f"{name}_pred.png"), pred_map)
        masked = np.where(test_gt != 0, pred_map, 0)
        save_colormap(os.path.join(save_dir, f"{name}_pred_masked.png"), masked)
    return SceneEvalResult(pred_map=pred_map, metrics=m)


def evaluate_scene(
    scene: np.ndarray,
    test_gt: np.ndarray,
    params: Optional[Dict[str, torch.Tensor]],
    model_cfg: ModelConfig,
    num_classes: int,
    cfg: EvalConfig = EvalConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
    save_dir: Optional[str] = None,
    name: str = "scene",
    mesh=None,
) -> SceneEvalResult:
    pred_map = classify_scene(scene, params, model_cfg, num_classes, cfg, device, seed, mesh)
    return _finish_eval(pred_map, test_gt, cfg, save_dir, name)


def evaluate_scene_artifact(
    scene: np.ndarray,
    test_gt: np.ndarray,
    classifier,
    cfg: EvalConfig = EvalConfig(),
    save_dir: Optional[str] = None,
    name: str = "scene",
) -> SceneEvalResult:
    pred_map = classify_scene_artifact(scene, classifier, cfg)
    return _finish_eval(pred_map, test_gt, cfg, save_dir, name)

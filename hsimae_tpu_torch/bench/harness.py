"""Generic baseline training / evaluation harness.

Counterpart of ``hsimae_tpu/bench/harness.py`` (the reference's
``training`` / ``test_model`` loops) for the port's zoo:

* supervised few-shot split: per-pixel patches from the padded scene,
  ``num`` samples a class, the training pixels zeroed from ``test_gt``;
* a 50/50 stratified train/val split, CE with label 0 ignored, per-epoch
  val OA/AA/kappa, ``EarlyStopping(30)`` on val ``mean3`` keeping the best
  state (parameters and BatchNorm buffers, copied) where the spec asks;
* per-model optimizer and schedule from :mod:`hsimae_tpu_torch.bench.registry`.
  The plateau schedule keeps the reference's quirk (it steps
  ``ReduceLROnPlateau`` with the epoch number as the metric), so it is
  ``lr0 * factor ** (epoch // (patience + 1))``.

Not ported, by design: JAX's ``_cached_steps`` and ``_set_lr`` exist to
compile one train step for every run on the TPU; the port sets each
group's rate before each epoch (:func:`set_lr`).

The draws can be injected: ``init_state`` (the initial weights, e.g. the
JAX zoo's through ``from_jax_zoo``), ``flips(epoch, step, n)`` -> the
``(fh, fv)`` flip masks of a batch, ``dropout_masks(shape, keep, device)``
-> a keep mask. By default the weights are drawn as flax draws them
(:func:`init_like_flax`, a CPU generator of ``seed``), the flips and
dropout masks from a generator of ``seed`` on ``device``.

The entry points run on ``device`` (``cuda`` by default); nothing falls
back to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hsimae_tpu_torch.bench.registry import BaselineSpec
from hsimae_tpu_torch.data.pipeline import ScenePatchSource, augment_flips, batch_indices, draw_flips
from hsimae_tpu_torch.data.sampling import sample_per_class, train_val_split
from hsimae_tpu_torch.models.baselines.common import MaskFn, init_like_flax, set_dropout_masks
from hsimae_tpu_torch.train.finetune import cross_entropy_ignore0
from hsimae_tpu_torch.train.optim import AdamW, RMSprop, decay_all, set_lr, timm_cosine_schedule
from hsimae_tpu_torch.utils.early_stop import EarlyStopping
from hsimae_tpu_torch.utils.metrics import Metrics, classification_metrics


def preprocess_scene(scene: np.ndarray, spec: BaselineSpec,
                     resize=None) -> np.ndarray:
    """The reference's ``data_trans``: optional global PCA (whitened,
    :func:`hsimae_tpu_torch.data.gwpca.pca_fit_transform`), float64 min-max
    to ``spec.norm``, optional per-band centring, optional zoom resize."""
    scene = np.asarray(scene, np.float64)
    if spec.pca_nc is not None:
        from hsimae_tpu_torch.data.gwpca import pca_fit_transform

        h, w, c = scene.shape
        scene = pca_fit_transform(scene.reshape(-1, c), spec.pca_nc,
                                  whiten=spec.pca_whiten).reshape(h, w, spec.pca_nc)
    if spec.norm is not None:
        hi, lo = spec.norm
        scene = (scene - scene.min()) / (scene.max() - scene.min())
        scene = scene * (hi - lo) + lo
    if spec.center:
        scene = scene - scene.mean(axis=(0, 1), keepdims=True)
    if resize is not None:
        from scipy import ndimage

        scene = ndimage.zoom(scene, np.asarray(resize) / np.asarray(scene.shape))
    return np.ascontiguousarray(scene, np.float32)


def epoch_lr(spec: BaselineSpec, lr0: float, epoch: int) -> float:
    if spec.scheduler == "none":
        return lr0
    if spec.scheduler == "plateau":
        return lr0 * spec.plateau_factor ** (epoch // (spec.plateau_patience + 1))
    if spec.scheduler == "step":
        step_size = max(spec.epochs // 10, 1)
        return lr0 * spec.step_gamma ** (epoch // step_size)
    if spec.scheduler == "cosine":
        sched = timm_cosine_schedule(
            lr0, t_initial=spec.epochs,
            warmup_t=int(np.ceil(0.1 * spec.epochs)),
            lr_min=lr0 * 0.01, warmup_lr_init=lr0 * 0.01)
        return float(sched(epoch))
    raise KeyError(spec.scheduler)


def make_optimizer(spec: BaselineSpec, model: torch.nn.Module, lr0: float):
    """optax's ``rmsprop(lr, momentum=0.9)`` or ``adamw(lr,
    weight_decay=wd)`` (every parameter decayed) over ``model``'s
    parameters, at rate ``lr0`` until :func:`set_lr` changes it."""
    if spec.optimizer == "rmsprop":
        opt = RMSprop(model.named_parameters(), momentum=0.9)
    else:
        opt = AdamW(model.named_parameters(), spec.weight_decay, decay=decay_all)
    set_lr(opt, lr0)
    return opt


def make_train_step(model: torch.nn.Module, optimizer) -> Callable:
    """``step(x, y, w) -> loss``: one train-mode forward, the CE with label
    0 ignored and weights ``w``, backward and update. The loss stays on the
    device."""

    def step(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        model.train()
        loss = cross_entropy_ignore0(model(x), y, w)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def eval_logits(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    model.eval()
    return model(x)


@dataclasses.dataclass
class BaselineRun:
    state: Dict[str, torch.Tensor]  # the trained net's state_dict (on its device)
    val_metrics: Metrics
    history: dict


def build_model(spec: BaselineSpec, bands: int, n_classes: int,
                init_state: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                device: str | torch.device = "cuda") -> torch.nn.Module:
    """``spec``'s net on ``device``: ``init_state`` loaded by name and shape,
    or initialised as flax does from a CPU generator of ``seed``."""
    model = spec.build(bands, n_classes, "synthetic")
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    else:
        init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def train_baseline(
    scene: np.ndarray,
    gt: np.ndarray,
    spec: BaselineSpec,
    lr: float = 1e-3,
    samples_per_class: Optional[int] = 10,
    percent: Optional[float] = None,
    seed: int = 3407,
    flip_augment: bool = True,
    verbose: bool = False,
    device: str | torch.device = "cuda",
    init_state: Optional[Dict[str, torch.Tensor]] = None,
    flips: Optional[Callable] = None,
    dropout_masks: Optional[MaskFn] = None,
):
    """Train one baseline on one scene; returns ``(BaselineRun, test_gt,
    scene_p)``. ``history`` holds each epoch's mean ``loss`` and val
    ``mean3``, and ``train_seconds`` / ``train_steps``: the wall time of
    each epoch's steps up to its one loss read, and their count."""
    device = torch.device(device)
    rng_np = np.random.default_rng(seed)
    scene_p = preprocess_scene(scene, spec)
    n_classes = int(gt.max()) + 1
    model = build_model(spec, scene_p.shape[-1], n_classes, init_state, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if flips is None:
        flips = lambda epoch, step, n: draw_flips(n, gen, device)  # noqa: E731
    set_dropout_masks(model, dropout_masks or (
        lambda shape, keep, dev: torch.rand(shape, generator=gen, device=dev) < keep))

    train_index, test_gt = sample_per_class(
        gt.reshape(-1), num=samples_per_class, percent=percent, rng=rng_np)
    labels = gt.reshape(-1)[train_index].astype(np.int32)
    tr_i, tr_y, va_i, va_y = train_val_split(train_index, labels, 0.5, rng=rng_np)

    source = ScenePatchSource(scene_p, spec.patch_size, device=device)
    bs = min(spec.batch_size, len(tr_i))
    opt = make_optimizer(spec, model, lr)
    step = make_train_step(model, opt)

    hist = {"loss": [], "val_mean3": [], "train_seconds": [], "train_steps": []}
    # EarlyStopping(30) with best-state retention, as the reference harness
    stopper = EarlyStopping(patience=30)
    vm = None

    for epoch in range(spec.epochs):
        ep_rng = np.random.default_rng(seed + 7000 + epoch)
        set_lr(opt, epoch_lr(spec, lr, epoch))
        t0 = time.perf_counter()
        losses, steps = [], 0
        for chunk, valid in batch_indices(len(tr_i), bs, rng=ep_rng):
            x = source.gather_pixels(tr_i[chunk])
            if flip_augment:
                x = augment_flips(x, flips=flips(epoch, steps, len(chunk)))
            y = torch.as_tensor(tr_y[chunk] * valid, dtype=torch.int64).to(device)
            w = torch.as_tensor(valid, dtype=torch.float32).to(device)
            losses.append(step(x, y, w))  # on the device; one read an epoch
            steps += 1
        hist["loss"].append(float(torch.stack(losses).sum()) / max(steps, 1))
        hist["train_seconds"].append(time.perf_counter() - t0)
        hist["train_steps"].append(steps)

        vp, vg = [], []
        for chunk, valid in batch_indices(len(va_i), min(512, len(va_i)), shuffle=False):
            logits = eval_logits(model, source.gather_pixels(va_i[chunk]))
            vp.append(logits.argmax(-1).cpu().numpy()[valid])
            vg.append(va_y[chunk][valid])
        vm = classification_metrics(np.concatenate(vg), np.concatenate(vp))
        hist["val_mean3"].append(vm.mean3)
        if verbose:
            print(f"[{spec.name}] epoch {epoch}: loss {hist['loss'][-1]:.4f} "
                  f"val mean3 {vm.mean3:.4f}")

        snapshot = (({k: v.detach().clone() for k, v in model.state_dict().items()}, vm)
                    if spec.early_stop else None)
        if stopper(vm.mean3, value=snapshot) and spec.early_stop:
            break

    if spec.early_stop and stopper.best_value is not None:
        best, vm = stopper.best_value
        model.load_state_dict(best)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return BaselineRun(state=state, val_metrics=vm, history=hist), test_gt, scene_p


def evaluate_baseline(
    run: BaselineRun,
    scene_p: np.ndarray,
    test_gt: np.ndarray,
    spec: BaselineSpec,
    n_classes: int,
    batch_size: int = 2048,
    device: str | torch.device = "cuda",
) -> Metrics:
    """Full-scene per-pixel inference in batches of ``batch_size``; each
    pixel's label is ``argmax(logits[:, 1:]) + 1``, scored against
    ``test_gt``."""
    device = torch.device(device)
    model = build_model(spec, scene_p.shape[-1], n_classes, run.state, device=device)
    source = ScenePatchSource(scene_p, spec.patch_size, device=device)
    h, w = scene_p.shape[:2]
    n = h * w
    out = torch.zeros(n, dtype=torch.int32, device=device)
    for chunk, valid in batch_indices(n, min(batch_size, n), shuffle=False):
        logits = eval_logits(model, source.gather_pixels(chunk))
        pred = (logits[:, 1:].argmax(dim=1) + 1).to(torch.int32)
        keep = torch.from_numpy(valid).to(device)
        out[torch.from_numpy(chunk).to(device)[keep]] = pred[keep]
    return classification_metrics(test_gt, out.cpu().numpy().reshape(test_gt.shape))

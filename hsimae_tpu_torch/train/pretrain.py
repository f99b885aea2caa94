"""MAE pretraining: the train step and the resumable epoch loop.

Counterpart of ``make_pretrain_step`` and ``run_pretraining`` in
``hsimae_tpu/train/pretrain.py``, on one device:

* scenes stay resident on the device; each step gathers its patch batch
  from ``(row, col, scene_id)`` rows of the cut index;
* the kept-grid shape ``(len_t, len_l)`` is drawn on the host per batch and
  batches are grouped by shape;
* every random draw of a step (flips, kept rows and columns, drop-path keep
  masks) comes from a generator seeded from ``(seed, global step)``, or is
  injected, so a resumed run draws what an uninterrupted run draws;
* the padded tail of an epoch has weight 0, so each cut counts once;
* losses stay on the device and are summed once an epoch;
* checkpoints go through the backend ``cfg.checkpoint_backend`` names:
  ``"msgpack"``, the synchronous ``ckpt_{step}.pt`` files, or ``"orbax"``,
  the background writer with retention
  (:class:`hsimae_tpu_torch.checkpoints.async_io.AsyncCheckpointer`); a
  resume that finds only the other backend's checkpoints raises;
* with ``profile_dir``, the second epoch of the call is traced with
  ``torch.profiler`` (the first holds the warm-up).

The step runs the Block modules under autograd: the fused-block kernel has
no backward and serves the inference path only.
"""

from __future__ import annotations

import os
import random as _pyrandom
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hsimae_tpu_torch.checkpoints.async_io import AsyncCheckpointer, checkpoint_steps
from hsimae_tpu_torch.checkpoints.io import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)
from hsimae_tpu_torch.config import ModelConfig, PretrainConfig
from hsimae_tpu_torch.data.pipeline import (
    MultiScenePatchSource,
    augment_flips,
    batch_indices,
    draw_flips,
)
from hsimae_tpu_torch.models.hsimae import HSIMAE, DropKeep, build_hsimae
from hsimae_tpu_torch.models.masking import GridMask, group_by_shape, spatial_spectral_mask
from hsimae_tpu_torch.train.optim import AdamW, pretrain_optimizer, set_lr
from hsimae_tpu_torch.utils.logger import MetricLogger


class PretrainDraws(NamedTuple):
    """The random draws of one step: flip masks ``(fh, fv)`` (None: no
    flips), the kept grid and the drop-path keep masks (None: none)."""

    flips: Optional[Tuple[torch.Tensor, torch.Tensor]]
    grid: GridMask
    drop_keep: Optional[DropKeep]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, dtype=np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def draw_pretrain(model: HSIMAE, n: int, len_t: int, len_l: int,
                  generator: torch.Generator, device, flip: bool = True) -> PretrainDraws:
    """Draw a step's flips, kept grid and (when the model has drop-path)
    keep masks, in that order."""
    c = model.cfg
    flips = draw_flips(n, generator, device=device) if flip else None
    grid = spatial_spectral_mask(n, c.t_size, c.l_size, len_t, len_l, generator, device)
    drop_keep = (model.draw_drop_keep(n, len_t, len_l, generator, device)
                 if c.drop_path > 0.0 else None)
    return PretrainDraws(flips, grid, drop_keep)


def make_pretrain_step(model: HSIMAE, optimizer: AdamW, sched: Callable[[int], float],
                       flip_augment: bool = True, seed: int = 0):
    """Returns ``step(imgs, len_t, len_l, w=None, draws=None) -> loss``.

    ``w`` is an optional per-sample weight (0 for the padded tail).
    ``draws`` (:class:`PretrainDraws`) injects the step's draws; without it
    they come from :func:`step_generator` at ``(seed, optimizer.count)``,
    flips only with ``flip_augment``. Update ``k`` runs at ``sched(k)``,
    ``k`` the updates already applied. The loss stays on the device."""

    def step(imgs: torch.Tensor, len_t: int, len_l: int, w: Optional[torch.Tensor] = None,
             draws: Optional[PretrainDraws] = None) -> torch.Tensor:
        k = optimizer.count
        if draws is None:
            g = step_generator(seed, k, imgs.device)
            draws = draw_pretrain(model, imgs.shape[0], len_t, len_l, g, imgs.device,
                                  flip_augment)
        if draws.flips is not None:
            imgs = augment_flips(imgs, flips=draws.flips)
        if not model.training:
            model.train()
        loss = model.forward_pretrain(imgs, len_t, len_l, w, draws.grid, draws.drop_keep)[0]
        optimizer.zero_grad()
        loss.backward()
        set_lr(optimizer, sched(k))
        optimizer.step()
        return loss.detach()

    return step


def _profiler(profile_dir: str, device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    return torch.profiler.profile(activities=acts)


def run_pretraining(
    source: MultiScenePatchSource,
    locs: np.ndarray,
    model_cfg: ModelConfig,
    cfg: PretrainConfig,
    workdir: Optional[str] = None,
    resume: bool = True,
    logger: Optional[MetricLogger] = None,
    stop_after_epochs: Optional[int] = None,
    device: str | torch.device = "cuda",
    profile_dir: Optional[str] = None,
):
    """Epoch loop over the cut index ``locs`` -> (model, history) with
    ``history = {"epoch_loss": [...], "patches_per_sec": [...],
    "checkpoint_seconds": [...]}`` for the epochs this call ran (the last:
    the step thread's time in each checkpoint save). With ``workdir``:
    checkpoints every ``cfg.checkpoint_every_steps`` steps (at epoch ends)
    through ``cfg.checkpoint_backend``, resume from the latest when
    ``resume``, and ``params_final.pt`` + ``train_log.npy`` at the end.
    ``stop_after_epochs`` ends the call early (a simulated preemption); the
    schedule still spans ``cfg.epochs``. ``profile_dir`` receives
    ``epoch_{n}.trace.json``, a ``torch.profiler`` trace of the call's
    second epoch ``n``."""
    if cfg.checkpoint_backend not in ("msgpack", "orbax"):
        raise ValueError(f"unknown checkpoint_backend {cfg.checkpoint_backend!r} "
                         "(msgpack or orbax)")
    model = build_hsimae(model_cfg, seed=cfg.seed, device=device)
    n = len(locs)
    bs = min(cfg.batch_size, n)
    steps_per_epoch = int(np.ceil(n / bs))
    total_steps = steps_per_epoch * cfg.epochs
    optimizer, sched = pretrain_optimizer(
        model, cfg.lr, cfg.weight_decay, total_steps, warmup_frac=cfg.warmup_frac,
        lr_min=cfg.lr_min, b1=cfg.adam_b1, b2=cfg.adam_b2,
        mu_dtype=getattr(torch, cfg.adam_mu_dtype) if cfg.adam_mu_dtype else None)

    ckptr = None
    if workdir and cfg.checkpoint_backend == "orbax":
        ckptr = AsyncCheckpointer(workdir, max_to_keep=cfg.ckpt_max_to_keep)
    start_epoch = 0
    if resume and workdir:
        # each backend's latest step, and whether the other backend wrote here
        if ckptr is not None:
            where = "the background writer"
            step = ckptr.restore_latest(model, optimizer)
            other = latest_checkpoint(workdir)
        else:
            where = latest_checkpoint(workdir)
            step = restore_checkpoint(where, model, optimizer) if where else None
            other = checkpoint_steps(workdir)
            other = f"background-writer steps {other}" if other else None
        if step is not None:
            start_epoch = step // steps_per_epoch
            print(f"[pretrain] resumed from {where} at step {step}, epoch {start_epoch}")
        elif other:
            # the backend was flipped between runs: starting at epoch 0 would
            # overwrite the run
            if ckptr is not None:
                ckptr.close()
            raise RuntimeError(
                f"resume requested with --ckpt-backend {cfg.checkpoint_backend!r}, which "
                f"found no checkpoint in {workdir}, but the other backend's checkpoints "
                f"exist there ({other}); re-run with the backend the workdir was written "
                "with, or pass resume=False / a fresh workdir to deliberately start over")

    logger = logger or MetricLogger(workdir)
    step_fn = make_pretrain_step(model, optimizer, sched, seed=cfg.seed)
    t_size, l_size = model_cfg.t_size, model_cfg.l_size
    epoch_losses, rates, ckpt_seconds = [], [], []
    end_epoch = cfg.epochs
    if stop_after_epochs is not None:
        end_epoch = min(end_epoch, start_epoch + stop_after_epochs)

    # the cut index lives on the device: a host array would make every
    # step's upload wait for the card
    locs_dev = torch.as_tensor(locs, dtype=torch.int64).to(device)
    prof = None
    # the background writer is waited for and closed on every exit path
    try:
        for epoch in range(start_epoch, end_epoch):
            if profile_dir and epoch == start_epoch + 1:
                prof = _profiler(profile_dir, device)
                prof.start()
            # per-epoch reseeded shuffle and grid shapes
            ep_rng = np.random.default_rng(cfg.seed + epoch)
            shape_rng = _pyrandom.Random(cfg.seed * 1000 + epoch)
            ep_steps, step_losses = 0, []
            t0 = time.perf_counter()
            batches = list(batch_indices(n, bs, rng=ep_rng))
            rows = torch.as_tensor(np.stack([c for c, _ in batches])).to(device)  # one upload
            for (len_t, len_l), group in group_by_shape(range(len(batches)), t_size, l_size,
                                                         cfg.mask_ratio, shape_rng).items():
                for i in group:
                    valid = batches[i][1]
                    # the wrapped duplicates of the padded tail weigh 0
                    w = None if valid.all() else torch.as_tensor(valid, dtype=torch.float32,
                                                                 device=device)
                    loss = step_fn(source.gather(locs_dev[rows[i]]), len_t, len_l, w)
                    ep_steps += 1
                    step_losses.append(loss)
                    if ep_steps % cfg.log_every == 0:
                        logger.log(step=optimizer.count, loss=float(loss),
                                   lr=sched(optimizer.count - 1))
            ep_loss = float(torch.stack(step_losses).sum())  # one sync an epoch
            dt = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
                prof.export_chrome_trace(os.path.join(profile_dir, f"epoch_{epoch}.trace.json"))
                prof = None
            mean_loss = ep_loss / max(ep_steps, 1)
            pps = ep_steps * bs / dt
            epoch_losses.append(mean_loss)
            rates.append(pps)
            logger.log(epoch=epoch, epoch_loss=mean_loss, patches_per_sec=pps)
            print(f"[pretrain] epoch {epoch}: loss {mean_loss:.4f}  {pps:,.0f} patches/s")
            if workdir and cfg.checkpoint_every_steps and (
                    (epoch + 1) * steps_per_epoch % cfg.checkpoint_every_steps < steps_per_epoch):
                t0 = time.perf_counter()
                if ckptr is not None:
                    ckptr.save(optimizer.count, model, optimizer)  # returns at once
                else:
                    save_checkpoint(workdir, optimizer.count, model, optimizer)
                ckpt_seconds.append(time.perf_counter() - t0)
    finally:
        if prof is not None:
            prof.stop()
        if ckptr is not None:
            ckptr.close()  # every enqueued save on disk before returning
    if workdir:
        save_params(f"{workdir}/params_final.pt", model)
        np.save(f"{workdir}/train_log.npy", np.array([epoch_losses, []], dtype=object))
    return model, {"epoch_loss": epoch_losses, "patches_per_sec": rates,
                   "checkpoint_seconds": ckpt_seconds}

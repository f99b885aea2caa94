"""Dual-branch fine-tuning: supervised cross-entropy on a few labeled
patches plus masked reconstruction on unlabeled patches of the same scene.

Counterpart of ``hsimae_tpu/train/finetune.py`` on one device:

* the fine-tuning model is the pretrained encoder and decoder plus a
  classification head (drop-path 0.2); pretrained weights load by key and
  shape, so a pretrain checkpoint leaves the head at its seeded init;
* the labeled pool is split 50/50, stratified, into train and val;
* an unlabeled batch holds ``ceil(n_unlabeled / steps_per_epoch) / 2``
  windows, taken in a reshuffled order that wraps;
* a step's loss is ``lamda * rec + CE`` with class 0 ignored; padded
  labeled rows weigh 0 in both losses;
* the rate follows a cosine over epochs (``finetune_optimizer``);
* every random draw of a step (flips of each batch, the kept grid over both
  batches, the drop-path masks of both encodes) comes from a generator
  seeded from ``(seed, step)``, or is injected;
* losses and the train confusion stay on the device and are fetched once
  an epoch; validation accumulates its confusion and CE on the device and
  fetches them once a pass;
* data parallelism: under a process group (``torch.distributed.run``, or with
  a ``mesh``), the labeled and unlabeled batches (and the val batches) are
  padded to multiples of the data axis and each rank gathers its
  contiguous rows of them. Every rank draws the global batch's draws and
  keeps its rows; both losses divide by the global batch's sums of
  weights; gradients and losses are summed over the data axis in one
  all-reduce a step; the train and val confusion matrices and CE sums are
  summed over it before their one fetch. Rank 0 alone logs and writes.

The dual step runs the Block modules under autograd (the fused-block kernel
has no backward). Validation runs the model in eval mode, so with
``cfg.use_kernel`` its encoder goes through the fused-block kernel; each
step sets the mode it needs.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hsimae_tpu_torch.checkpoints.io import partial_restore, save_params
from hsimae_tpu_torch.config import FinetuneConfig, ModelConfig
from hsimae_tpu_torch.data.pipeline import (
    ScenePatchSource,
    augment_flips,
    batch_indices,
    draw_flips,
)
from hsimae_tpu_torch.data.sampling import DualSceneSplit, train_val_split
from hsimae_tpu_torch.models.hsimae import HSIMAE, DropKeep, build_dual_vit
from hsimae_tpu_torch.models.masking import GridMask, group_by_shape, spatial_spectral_mask
from hsimae_tpu_torch.ops.metrics_ops import confusion_matrix_op
from hsimae_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    barrier,
    data_size,
    default_mesh,
    global_sum,
    is_main_process,
    mesh_slice,
    pad_to_multiple,
    replicate,
)
from hsimae_tpu_torch.train.optim import AdamW, finetune_optimizer, set_lr
from hsimae_tpu_torch.train.pretrain import step_generator, take_drop_keep
from hsimae_tpu_torch.utils.logger import MetricLogger
from hsimae_tpu_torch.utils.metrics import Metrics, metrics_from_raw_confusion

# the encoder's parameters: a pretrained dict must cover at least one
ENCODER_PARAMS = ("patch_embed", "blocks_1", "blocks_2", "blocks", "norm")


def ce_weights(labels: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each sample's weight in :func:`cross_entropy_ignore0`: 0 for label 0,
    else ``weight`` (1 without it)."""
    m = (labels != 0).float()
    return m if weight is None else m * weight


def cross_entropy_ignore0(logits: torch.Tensor, labels: torch.Tensor,
                          weight: Optional[torch.Tensor] = None,
                          denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over the samples whose label is not 0 (torch's
    ``ignore_index=0``), each weighted by ``weight``; the sum of weights
    (or ``denom``, a global batch's, for a data-parallel rank) is floored
    at 1."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    m = ce_weights(labels, weight)
    return -(ll * m).sum() / (m.sum() if denom is None else denom).clamp(min=1.0)


class DualDraws(NamedTuple):
    """The random draws of one dual step: flip masks ``(fh, fv)`` of the
    labeled and of the unlabeled batch (None: no flips), the kept grid over
    both batches, and the drop-path keep masks of the classification encode
    and of the masked encode (None: none)."""

    flips: Optional[Tuple[torch.Tensor, torch.Tensor]]
    flips_u: Optional[Tuple[torch.Tensor, torch.Tensor]]
    grid: GridMask
    drop_keep_cls: Optional[DropKeep]
    drop_keep_rec: Optional[DropKeep]


def draw_dual(model: HSIMAE, n: int, n_u: int, len_t: int, len_l: int,
              generator: torch.Generator, device, flip: bool = True) -> DualDraws:
    """Draw a dual step's flips (labeled, then unlabeled), kept grid over
    ``n + n_u`` samples and (when the model has drop-path) the keep masks of
    the unmasked encode of ``n`` and of the masked encode of ``n + n_u``, in
    that order."""
    c = model.cfg
    flips = draw_flips(n, generator, device=device) if flip else None
    flips_u = draw_flips(n_u, generator, device=device) if flip else None
    grid = spatial_spectral_mask(n + n_u, c.t_size, c.l_size, len_t, len_l, generator, device)
    keep_cls = keep_rec = None
    if c.drop_path > 0.0:
        keep_cls = model.draw_drop_keep(n, c.t_size, c.l_size, generator, device)
        keep_rec = model.draw_drop_keep(n + n_u, len_t, len_l, generator, device)
    return DualDraws(flips, flips_u, grid, keep_cls, keep_rec)


def local_dual_draws(draws: DualDraws, n: int, n_u: int, rows: slice, rows_u: slice
                     ) -> DualDraws:
    """A global dual step's draws cut to the labeled samples ``rows`` of
    ``n`` and the unlabeled samples ``rows_u`` of ``n_u``: the masked
    encode's samples are ``rows`` then ``n + rows_u``."""
    dev = draws.grid.mask.device
    both = torch.cat([torch.arange(n, device=dev)[rows],
                      n + torch.arange(n_u, device=dev)[rows_u]])
    flips = None if draws.flips is None else tuple(f[rows] for f in draws.flips)
    flips_u = None if draws.flips_u is None else tuple(f[rows_u] for f in draws.flips_u)
    return DualDraws(flips, flips_u, GridMask(*(t[both] for t in draws.grid)),
                     take_drop_keep(draws.drop_keep_cls, n, rows),
                     take_drop_keep(draws.drop_keep_rec, n + n_u, both))


def make_dual_step(model: HSIMAE, optimizer: AdamW, sched: Callable[[int], float],
                   lamda: float, flip_augment: bool = True, seed: int = 0, mesh=None):
    """Returns ``step(x, y, w, x_u, len_t, len_l, draws=None) -> (loss,
    loss_rec, logits)``.

    ``x [n, ...]`` with labels ``y [n]`` (0 for padding) and weights
    ``w [n]`` (0 for padding) is the labeled batch, ``x_u`` the unlabeled
    one. ``draws`` (:class:`DualDraws`) injects the step's draws; without it
    they come from :func:`step_generator` at ``(seed, optimizer.count)``,
    flips only with ``flip_augment``. Update ``k`` runs at ``sched(k)``.
    The outputs stay on the device; ``logits`` are the forward's, before
    the update.

    With a ``mesh`` of data axis ``P``, ``x`` and ``x_u`` hold this rank's
    rows of global batches of ``P * len(x)`` and ``P * len(x_u)``
    (:func:`mesh_slice`), while ``y``, ``w`` and ``draws`` are the global
    batch's; the losses are the global batch's on every rank, the logits
    this rank's rows'."""

    def step(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, x_u: torch.Tensor,
             len_t: int, len_l: int, draws: Optional[DualDraws] = None):
        k = optimizer.count
        p = data_size(mesh)
        n, n_u = x.shape[0] * p, x_u.shape[0] * p
        if draws is None:
            g = step_generator(seed, k, x.device)
            draws = draw_dual(model, n, n_u, len_t, len_l, g, x.device, flip_augment)
        rec_denom = ce_denom = None
        if mesh is not None:
            # the global batch's sums of weights, then this rank's rows
            w_all = torch.cat([w, w.new_ones(n_u)])
            rec_denom = (draws.grid.mask * w_all[:, None]).sum()
            ce_denom = ce_weights(y, w).sum()
            rows, rows_u = mesh_slice(n, mesh), mesh_slice(n_u, mesh)
            draws = local_dual_draws(draws, n, n_u, rows, rows_u)
            y, w = y[rows], w[rows]
        if draws.flips is not None:
            x = augment_flips(x, flips=draws.flips)
            x_u = augment_flips(x_u, flips=draws.flips_u)
        model.train()
        loss_rec, logits = model.forward_dual(x, x_u, len_t, len_l, w, draws.grid,
                                              draws.drop_keep_cls, draws.drop_keep_rec,
                                              loss_denom=rec_denom)
        loss = lamda * loss_rec + cross_entropy_ignore0(logits, y, w, ce_denom)
        optimizer.zero_grad()
        loss.backward()
        if mesh is not None:
            loss, loss_rec = all_reduce_grads(model, mesh, loss, loss_rec)
        set_lr(optimizer, sched(k))
        optimizer.step()
        return loss.detach(), loss_rec.detach(), logits.detach()

    return step


def make_eval_metrics_step(model: HSIMAE, n_classes: int):
    """Returns ``ev(x, y, w) -> (cm, ce_sum, ce_count)``: the eval-mode
    classification of ``x`` (through the fused-block kernel with
    ``cfg.use_kernel``), its argmax folded into a ``[C, C]`` confusion
    matrix and the CE partial sums over rows of label not 0, each row
    weighted by ``w`` (0 for padding). All three stay on the device."""

    @torch.inference_mode()
    def ev(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
        model.eval()
        logits = model.classify(x)
        cm = confusion_matrix_op(y, torch.argmax(logits, dim=-1), n_classes, w)
        logp = F.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, 1, y.long()[:, None])[:, 0]
        m = (y != 0).float() * w
        return cm, -(ll * m).sum(), m.sum()

    return ev


@dataclasses.dataclass
class FinetuneResult:
    params: Dict[str, torch.Tensor]  # the fine-tuned state dict, on the CPU
    val_metrics: Optional[Metrics]
    history: dict
    model_cfg: ModelConfig
    num_classes: int


def dual_branch_finetune(
    split: DualSceneSplit,
    model_cfg: ModelConfig,
    cfg: FinetuneConfig,
    pretrained: Optional[Dict[str, torch.Tensor]] = None,
    workdir: Optional[str] = None,
    seed: Optional[int] = None,
    logger: Optional[MetricLogger] = None,
    eval_every: int = 1,
    device: str | torch.device = "cuda",
    mesh=None,
) -> FinetuneResult:
    """Fine-tune on ``split`` for ``cfg.epochs`` epochs, validating every
    ``eval_every`` epochs and after the last. ``history`` has the JAX
    loop's curves (``loss``, ``loss_rec``, ``train_aa``, ``val_*``) plus
    ``epoch_seconds`` (the dual steps of each epoch, to their fetch) and
    ``val_seconds`` (each validation pass, to its fetch). With ``workdir``:
    ``finetuned.pt`` (the state dict) and ``train_log.npy``. ``mesh``
    (default: :func:`default_mesh`) makes the loop data-parallel (module
    docstring); the result is then the same on every rank."""
    seed = cfg.seed if seed is None else seed
    if mesh is None:
        mesh = default_mesh()
    main, p = is_main_process(), data_size(mesh)
    n_class = split.n_classes
    model = build_dual_vit(model_cfg, n_class, drop_path=cfg.drop_path, seed=seed, device="cpu")
    if pretrained is not None:
        loaded, _ = partial_restore(model, pretrained)
        if not any(k.split(".")[0] in ENCODER_PARAMS for k in loaded):
            raise ValueError(
                f"the pretrained weights cover no encoder parameter of the model (matched "
                f"{len(loaded)} keys, e.g. {sorted(pretrained)[:3]}): not a checkpoint of this "
                "model, or a train state left wrapped?")
    model.to(device)

    rng_np = np.random.default_rng(seed)
    tr_idx, tr_y, va_idx, va_y = train_val_split(split.labeled_index, split.labels,
                                                 cfg.train_ratio, rng=rng_np)
    source = ScenePatchSource(split.scene, model_cfg.img_size, device=device)
    n_tr, n_un = len(tr_idx), len(split.unlabeled_starts)
    # batches padded to multiples of the data axis; the schedule counts the
    # steps the padded batches take
    bs_l = pad_to_multiple(min(cfg.batch_size, n_tr), p)
    steps_per_epoch = int(np.ceil(n_tr / bs_l))
    bs_u = pad_to_multiple(max(1, int(np.ceil(n_un / steps_per_epoch) / 2)), p)
    bs_v = pad_to_multiple(min(cfg.val_batch_size, len(va_idx)), p)
    own_l, own_u, own_v = mesh_slice(bs_l, mesh), mesh_slice(bs_u, mesh), mesh_slice(bs_v, mesh)

    optimizer, sched = finetune_optimizer(model, cfg.lr, cfg.weight_decay, cfg.epochs,
                                          steps_per_epoch, cfg.warmup_frac,
                                          encoder_lr_scale=cfg.encoder_lr_scale)
    if mesh is not None:
        replicate(model, mesh, optimizer)
    step_fn = make_dual_step(model, optimizer, sched, cfg.lamda, True, seed, mesh)
    eval_fn = make_eval_metrics_step(model, n_class)
    logger = logger or (MetricLogger(workdir) if main else MetricLogger(echo=False))
    t_size, l_size = model_cfg.t_size, model_cfg.l_size

    def labeled(idx, ys, chunk, valid, own):
        """This rank's patches (rows ``own``) of one labeled chunk, and the
        whole chunk's labels (0 for padding) and weights."""
        y = torch.as_tensor(ys[chunk] * valid, dtype=torch.int64).to(device)
        w = torch.as_tensor(valid, dtype=torch.float32).to(device)
        return source.gather_pixels(idx[chunk][own]), y, w

    hist = {"loss": [], "loss_rec": [], "train_aa": [], "val_loss": [], "val_oa": [],
            "val_aa": [], "val_kappa": [], "val_epoch": [], "epoch_seconds": [],
            "val_seconds": []}
    best = None
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        ep_rng = np.random.default_rng(seed + 1000 + epoch)
        shape_rng = _pyrandom.Random(seed * 131 + epoch)
        un_order = ep_rng.permutation(n_un)
        un_pos = 0
        step_losses, step_recs, step_cms = [], [], []
        batches = list(batch_indices(n_tr, bs_l, rng=ep_rng))
        for (len_t, len_l), group in group_by_shape(batches, t_size, l_size, cfg.mask_ratio,
                                                    shape_rng).items():
            for chunk, valid in group:
                x, y, w = labeled(tr_idx, tr_y, chunk, valid, own_l)
                # the unlabeled batch: a reshuffled order that wraps; a pool
                # smaller than one batch is tiled
                if un_pos + bs_u > n_un:
                    un_order = ep_rng.permutation(n_un)
                    un_pos = 0
                u_sel = un_order[un_pos:un_pos + bs_u]
                if len(u_sel) < bs_u:
                    u_sel = np.resize(un_order, bs_u)
                un_pos += bs_u
                x_u = source.gather_windows(split.unlabeled_starts[u_sel[own_u]])
                loss, loss_rec, logits = step_fn(x, y, w, x_u, len_t, len_l)
                step_losses.append(loss)
                step_recs.append(loss_rec)
                step_cms.append(confusion_matrix_op(y[own_l], torch.argmax(logits, dim=-1),
                                                    n_class, w[own_l]))

        # one fetch an epoch: the losses (the global batch's already) and
        # the train confusion summed over the epoch and the data axis
        cm = global_sum(torch.stack(step_cms).sum(0), mesh)
        host = torch.cat([torch.stack(step_losses), torch.stack(step_recs),
                          cm.flatten()]).cpu().numpy()
        hist["epoch_seconds"].append(time.perf_counter() - t0)
        n_steps = len(step_losses)
        hist["loss"].append(float(host[:n_steps].sum()) / steps_per_epoch)
        hist["loss_rec"].append(float(host[n_steps:2 * n_steps].sum()) / steps_per_epoch)
        hist["train_aa"].append(metrics_from_raw_confusion(
            host[2 * n_steps:].reshape(n_class, n_class)).aa)

        if (epoch + 1) % eval_every == 0 or epoch == cfg.epochs - 1:
            t0 = time.perf_counter()
            cm = torch.zeros(n_class, n_class, device=device)
            ce = torch.zeros(2, device=device)
            for chunk, valid in batch_indices(len(va_idx), bs_v, shuffle=False):
                xv, yv, wv = labeled(va_idx, va_y, chunk, valid, own_v)
                c, s, n = eval_fn(xv, yv[own_v], wv[own_v])
                cm += c
                ce += torch.stack([s, n])
            # one fetch a pass: the confusion matrix and the CE sums, summed
            # over the data axis
            host = global_sum(torch.cat([cm.flatten(), ce]), mesh).cpu().numpy()
            hist["val_seconds"].append(time.perf_counter() - t0)
            vm = metrics_from_raw_confusion(host[:-2].reshape(n_class, n_class))
            val_loss = float(host[-2] / max(host[-1], 1.0))
            hist["val_loss"].append(val_loss)
            hist["val_oa"].append(vm.oa)
            hist["val_aa"].append(vm.aa)
            hist["val_kappa"].append(vm.kappa)
            hist["val_epoch"].append(epoch)
            best = vm
            logger.log(epoch=epoch, loss=hist["loss"][-1], val_loss=val_loss, val_oa=vm.oa,
                       val_aa=vm.aa, val_kappa=vm.kappa, lr=sched(optimizer.count - 1))

    if workdir and main:
        save_params(f"{workdir}/finetuned.pt", model)
        np.save(f"{workdir}/train_log.npy",
                np.array([hist["loss"], hist["val_oa"]], dtype=object))
    barrier()
    return FinetuneResult(
        params={k: v.detach().cpu() for k, v in model.state_dict().items()},
        val_metrics=best, history=hist, model_cfg=model_cfg.replace(num_classes=n_class),
        num_classes=n_class)

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
  ``torch.profiler`` (the first holds the warm-up);
* with ``cfg.fused_steps = K`` (``--fused-steps``), the counterpart of the
  JAX package's ``lax.scan`` chunk: the epoch is padded (wrapping) to whole
  chunks of K batches, each trained by :func:`make_fused_pretrain_chunk`
  (one bulk gather, K steps captured once per kept-grid shape as one CUDA
  graph and replayed); the wrapped duplicates train at full weight, as in
  the JAX package, and the schedule counts the padded steps;
* data parallelism: under a process group (``torch.distributed.run``, or with
  a ``mesh``), the global batch is padded to a multiple of the data axis
  and every rank gathers and trains its contiguous rows of it. Every rank
  draws the global batch's flips, kept grid and drop-path masks from the
  step's generator and keeps its rows, so the draws are the single
  process's; the loss divides by the global batch's sum of weights, the
  gradients (and the reported loss) are summed over the data axis in one
  all-reduce before the update. Rank 0 alone logs, profiles and writes
  files; every rank resumes from the same checkpoint.

The step runs the Block modules under autograd: the fused-block kernel has
no backward and serves the inference path only.
"""

from __future__ import annotations

import os
import random as _pyrandom
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

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
    gather_multiscene,
)
from hsimae_tpu_torch.models.hsimae import HSIMAE, DropKeep, build_hsimae
from hsimae_tpu_torch.models.masking import (
    GridMask,
    choose_grid_shape,
    group_by_shape,
    spatial_spectral_mask,
)
from hsimae_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    barrier,
    data_size,
    default_mesh,
    is_main_process,
    local_tensor,
    mesh_slice,
    pad_to_multiple,
    replicate,
)
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


def take_rows(t: torch.Tensor, n: int, rows) -> torch.Tensor:
    """The rows of samples ``rows`` (a slice or an index tensor) of the 1-D
    ``t``, which holds ``n`` samples of equal row counts: a drop-path mask
    of ``n * len_t`` rows keeps ``len_t`` rows a sample."""
    return t.reshape(n, -1)[rows].reshape(-1)


def take_drop_keep(keep: Optional[DropKeep], n: int, rows) -> Optional[DropKeep]:
    """The drop-path keep masks of samples ``rows`` of ``n``."""
    if keep is None:
        return None
    return {name: [None if k is None else tuple(take_rows(t, n, rows) for t in k)
                   for k in masks] for name, masks in keep.items()}


def local_pretrain_draws(draws: PretrainDraws, n: int, rows) -> PretrainDraws:
    """A global batch's draws cut to the samples ``rows`` of ``n``."""
    flips = None if draws.flips is None else tuple(f[rows] for f in draws.flips)
    return PretrainDraws(flips, GridMask(*(t[rows] for t in draws.grid)),
                         take_drop_keep(draws.drop_keep, n, rows))


def make_pretrain_step(model: HSIMAE, optimizer: AdamW, sched: Callable[[int], float],
                       flip_augment: bool = True, seed: int = 0, mesh=None):
    """Returns ``step(imgs, len_t, len_l, w=None, draws=None) -> loss``.

    ``w`` is an optional per-sample weight (0 for the padded tail).
    ``draws`` (:class:`PretrainDraws`) injects the step's draws; without it
    they come from :func:`step_generator` at ``(seed, optimizer.count)``,
    flips only with ``flip_augment``. Update ``k`` runs at ``sched(k)``,
    ``k`` the updates already applied. The loss stays on the device.

    With a ``mesh`` of data axis ``P``, ``imgs`` holds this rank's rows of
    a global batch of ``P * len(imgs)`` (:func:`mesh_slice`), while ``w``
    and ``draws`` are the global batch's; the returned loss is the global
    batch's, on every rank."""

    def step(imgs: torch.Tensor, len_t: int, len_l: int, w: Optional[torch.Tensor] = None,
             draws: Optional[PretrainDraws] = None) -> torch.Tensor:
        k = optimizer.count
        n = imgs.shape[0] * data_size(mesh)
        if draws is None:
            g = step_generator(seed, k, imgs.device)
            draws = draw_pretrain(model, n, len_t, len_l, g, imgs.device, flip_augment)
        denom = None
        if mesh is not None:
            # the global batch's sum of weights, then this rank's rows
            denom = (draws.grid.mask if w is None else draws.grid.mask * w[:, None]).sum()
            rows = mesh_slice(n, mesh)
            draws = local_pretrain_draws(draws, n, rows)
            w = None if w is None else w[rows]
        if draws.flips is not None:
            imgs = augment_flips(imgs, flips=draws.flips)
        if not model.training:
            model.train()
        loss = model.forward_pretrain(imgs, len_t, len_l, w, draws.grid, draws.drop_keep,
                                      loss_denom=denom)[0]
        optimizer.zero_grad()
        loss.backward()
        if mesh is not None:
            loss, = all_reduce_grads(model, mesh, loss)
        set_lr(optimizer, sched(k))
        optimizer.step()
        return loss.detach()

    return step


def _stack_draws(draws: Sequence[PretrainDraws], device) -> PretrainDraws:
    """K steps' draws as one :class:`PretrainDraws` of ``[K, ...]`` tensors
    on ``device`` (None stays None)."""
    leaves = [pytree.tree_flatten(d) for d in draws]
    spec = leaves[0][1]
    stacked = [None if ts[0] is None else torch.stack(ts).to(device)
               for ts in zip(*(ls for ls, _ in leaves))]
    return pytree.tree_unflatten(stacked, spec)


def _draws_at(draws: PretrainDraws, i) -> PretrainDraws:
    """Step ``i`` (an index or a slice) of stacked draws."""
    return pytree.tree_map(lambda t: None if t is None else t[i], draws)


class FusedPretrainChunk:
    """K whole train steps a call: the counterpart of the JAX package's
    ``make_fused_pretrain_chunk`` (one ``lax.scan`` dispatch). Made by
    :func:`make_fused_pretrain_chunk`; ``capture_seconds`` holds the
    seconds each ``(len_t, len_l, K)`` took to capture (warm-up included)."""

    def __init__(self, model: HSIMAE, optimizer: AdamW, sched: Callable[[int], float],
                 source: MultiScenePatchSource, seed: int = 0, flip_augment: bool = True,
                 mesh=None):
        self.model, self.optimizer, self.sched = model, optimizer, sched
        self.source, self.seed, self.flip_augment, self.mesh = source, seed, flip_augment, mesh
        self.capture_seconds: Dict[Tuple[int, int, int], float] = {}
        # per (len_t, len_l, K): (graph, static draws, static loss denominators, mean loss);
        # the patches and the rates of a K are shared by its graphs, and every graph
        # draws from one memory pool
        self._graphs: Dict[Tuple[int, int, int], tuple] = {}
        self._shared: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._pool = None
        self._addresses: Optional[List[int]] = None

    def __call__(self, locs_chunk, len_t: int, len_l: int,
                 draws: Optional[Sequence[PretrainDraws]] = None) -> torch.Tensor:
        """Train on the batches ``locs_chunk [K, B, 3]`` (rows of the cut
        index) -> the K steps' mean loss, on the device. ``draws``: the K
        steps' :class:`PretrainDraws` (of the global batch), else drawn as
        the eager step draws them. ``optimizer.count`` advances by K."""
        k = int(locs_chunk.shape[0])
        imgs, drawn, rates, denoms = self._inputs(locs_chunk, len_t, len_l, draws)
        if imgs.is_cuda:
            loss = self._replay((len_t, len_l, k), imgs, drawn, rates, denoms)
        else:  # the plain version: the same steps, one after another
            loss = self._steps(imgs, drawn, rates, denoms, len_t, len_l)
        self.optimizer.count += k
        return loss

    def _inputs(self, locs_chunk, len_t: int, len_l: int,
                draws: Optional[Sequence[PretrainDraws]]):
        """(patches [K, b, ps, ps, C] of this rank's rows, the draws stacked
        over K (this rank's rows), rates ``[3, K]`` (rate, bias corrections),
        the global batches' loss denominators [K] under a mesh, else None)."""
        src, model, mesh = self.source, self.model, self.mesh
        dev = src.device
        k, n = int(locs_chunk.shape[0]), int(locs_chunk.shape[1])
        count = self.optimizer.count
        rows = mesh_slice(n, mesh)
        locs = torch.as_tensor(locs_chunk, dtype=torch.int64).to(dev)[:, rows]
        # one bulk gather of the chunk's patches, as the JAX chunk gathers before its scan
        imgs = gather_multiscene(src._flat, src._widths, src._bases, src._min, src._max,
                                 locs.reshape(-1, 3), src.patch_size)
        imgs = imgs.reshape(k, -1, *imgs.shape[1:])
        if draws is None:
            draws = [draw_pretrain(model, n, len_t, len_l,
                                   step_generator(self.seed, count + i, dev), dev,
                                   self.flip_augment) for i in range(k)]
        denoms = None
        if mesh is not None:
            denoms = torch.stack([d.grid.mask.sum() for d in draws]).to(dev)
            draws = [local_pretrain_draws(d, n, rows) for d in draws]
        bcs = [self.optimizer.bias_corrections(count + i + 1) for i in range(k)]
        rates = torch.tensor([[self.sched(count + i) for i in range(k)],
                              [b[0] for b in bcs], [b[1] for b in bcs]], dtype=torch.float32)
        if dev.type == "cuda":  # pinned: the upload does not wait for the card
            rates = rates.pin_memory().to(dev, non_blocking=True)
        return imgs, _stack_draws(draws, dev), rates, denoms

    def _steps(self, imgs: torch.Tensor, draws: PretrainDraws, rates: torch.Tensor,
               denoms: Optional[torch.Tensor], len_t: int, len_l: int) -> torch.Tensor:
        """The K steps of :func:`make_pretrain_step` on the stacked inputs,
        the update through :meth:`AdamW.step_from` -> the mean loss."""
        model, opt = self.model, self.optimizer
        if not model.training:
            model.train()
        losses = []
        for i in range(imgs.shape[0]):
            d, x = _draws_at(draws, i), imgs[i]
            if d.flips is not None:
                x = augment_flips(x, flips=d.flips)
            loss = model.forward_pretrain(x, len_t, len_l, None, d.grid, d.drop_keep,
                                          loss_denom=None if denoms is None else denoms[i])[0]
            opt.zero_grad()
            loss.backward()
            if self.mesh is not None:
                loss, = all_reduce_grads(model, self.mesh, loss)
            opt.step_from(rates[0, i], rates[1, i], rates[2, i])
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def _state(self) -> List[torch.Tensor]:
        """The tensors the steps update in place: parameters and moments."""
        opt = self.optimizer
        return ([local_tensor(p) for g in opt.param_groups for p in g["params"]]
                + [m for ms in (*opt.mu, *opt.nu) for m in ms])

    def _replay(self, key: Tuple[int, int, int], imgs: torch.Tensor, draws: PretrainDraws,
                rates: torch.Tensor, denoms: Optional[torch.Tensor]) -> torch.Tensor:
        if key not in self._graphs:
            self._capture(key, imgs, draws, rates, denoms)
        if [t.data_ptr() for t in self._state()] != self._addresses:
            raise RuntimeError("a parameter or an optimizer moment was replaced after the fused "
                               "chunk's CUDA graph was captured; restore state in place "
                               "(load_state_dict copies), before the first chunk")
        graph, static_draws, static_denoms, mean = self._graphs[key]
        static_imgs, static_rates = self._shared[key[2]]
        static_imgs.copy_(imgs)
        static_rates.copy_(rates)
        for dst, src in zip(pytree.tree_leaves(static_draws), pytree.tree_leaves(draws)):
            if dst is not None:
                dst.copy_(src)
        if denoms is not None:
            static_denoms.copy_(denoms)
        graph.replay()
        # the replay changed the weights without bumping their version counters
        self.model.forget_kernel_params()
        return mean.clone()  # the next replay of another graph may reuse the pool's slot

    def _capture(self, key: Tuple[int, int, int], imgs: torch.Tensor, draws: PretrainDraws,
                 rates: torch.Tensor, denoms: Optional[torch.Tensor]) -> None:
        """Capture the K steps of ``key`` as one CUDA graph reading static
        copies of the inputs, after one warm-up step on a side stream whose
        updates are undone (the parameters and moments are copied back in
        place). Raises if the capture fails."""
        len_t, len_l, k = key
        if self.mesh is not None:
            backend = dist.get_backend(self.mesh.get_group("data"))
            if backend != "nccl":
                raise RuntimeError(
                    f"the fused chunk captures its gradient all-reduce in a CUDA graph, and "
                    f"{backend} collectives cannot be captured (they pass through the host); "
                    "run the data-parallel fused path over NCCL (a card a rank) or use "
                    "fused_steps=0")
        t0 = time.perf_counter()
        if k not in self._shared:
            self._shared[k] = (imgs.clone(), rates.clone())
        static_imgs, static_rates = self._shared[k]
        static_draws = pytree.tree_map(lambda t: None if t is None else t.clone(), draws)
        static_denoms = None if denoms is None else denoms.clone()
        state = self._state()
        saved = [t.detach().clone() for t in state]  # no autograd node kept alive
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._steps(static_imgs[:1], _draws_at(static_draws, slice(0, 1)),
                        static_rates[:, :1], None if denoms is None else static_denoms[:1],
                        len_t, len_l)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        del saved
        self.optimizer.zero_grad()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # thread-local: the background checkpoint writer may wait on an event meanwhile
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            mean = self._steps(static_imgs, static_draws, static_rates, static_denoms,
                               len_t, len_l)
        self.optimizer.zero_grad()
        torch.cuda.synchronize()
        self._graphs[key] = (graph, static_draws, static_denoms, mean)
        if self._addresses is None:
            self._addresses = [t.data_ptr() for t in state]
        self.capture_seconds[key] = time.perf_counter() - t0


def make_fused_pretrain_chunk(model: HSIMAE, optimizer: AdamW, sched: Callable[[int], float],
                              source: MultiScenePatchSource, seed: int = 0,
                              flip_augment: bool = True, mesh=None) -> FusedPretrainChunk:
    """Returns ``chunk(locs_chunk [K, B, 3], len_t, len_l, draws=None) ->
    mean_loss``: K train steps on the K batches of cut-index rows, equal to
    K :func:`make_pretrain_step` calls on the same batches (the JAX
    package's ``make_fused_pretrain_chunk``, one dispatch a chunk).

    * One bulk gather of the chunk's ``K * B`` patches through ``source``'s
      flat scene buffer.
    * Step ``i`` draws what the eager step draws at update ``count + i``
      (:func:`step_generator` at ``(seed, count + i)``, :func:`draw_pretrain`),
      or takes ``draws[i]``. The draws are made outside the graph and
      copied into its static buffers (the JAX chunk's ``fold_in(base, i)``
      stream has no torch counterpart).
    * On a CUDA device the K steps (flips, ``forward_pretrain``, backward,
      :meth:`AdamW.step_from` at ``sched(count + i)``) are captured once per
      ``(len_t, len_l, K)`` as one ``torch.cuda.CUDAGraph``, every graph in
      one memory pool; a chunk is then one replay. A failed capture raises.
      Nothing may rebind a parameter or a moment after a capture (a replay
      checks). On the CPU the same steps run in a loop: the plain version.
    * Under a ``mesh`` each rank gathers its rows of each global batch
      (:func:`mesh_slice`), takes its rows of the global batch's draws and
      divides by the global batch's sum of weights; the gradient
      all-reduce is captured with the steps, which NCCL allows and gloo
      does not (raises on a card).

    The mean loss stays on the device; ``optimizer.count`` advances by K."""
    return FusedPretrainChunk(model, optimizer, sched, source, seed, flip_augment, mesh)


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
    mesh=None,
):
    """Epoch loop over the cut index ``locs`` -> (model, history) with
    ``history = {"epoch_loss": [...], "patches_per_sec": [...],
    "capture_seconds": [...], "checkpoint_seconds": [...]}`` for the epochs
    this call ran (``capture_seconds``: each epoch's seconds capturing the
    fused chunk's CUDA graphs, 0 without ``cfg.fused_steps``; the last: the
    step thread's time in each checkpoint save). With ``workdir``:
    checkpoints every ``cfg.checkpoint_every_steps`` steps (at epoch ends)
    through ``cfg.checkpoint_backend``, resume from the latest when
    ``resume``, and ``params_final.pt`` + ``train_log.npy`` at the end.
    ``stop_after_epochs`` ends the call early (a simulated preemption); the
    schedule still spans ``cfg.epochs``. ``profile_dir`` receives
    ``epoch_{n}.trace.json``, a ``torch.profiler`` trace of the call's
    second epoch ``n``. ``mesh`` (default: :func:`default_mesh`, the data
    axis over every rank of the process group, if one is up) makes the
    loop data-parallel (module docstring); ``history`` is then the global
    batch's on every rank."""
    if cfg.checkpoint_backend not in ("msgpack", "orbax"):
        raise ValueError(f"unknown checkpoint_backend {cfg.checkpoint_backend!r} "
                         "(msgpack or orbax)")
    model = build_hsimae(model_cfg, seed=cfg.seed, device=device)
    if mesh is None:
        mesh = default_mesh()
    main = is_main_process()
    n = len(locs)
    bs = pad_to_multiple(min(cfg.batch_size, n), data_size(mesh))
    steps_per_epoch = int(np.ceil(n / bs))
    k = min(cfg.fused_steps, steps_per_epoch)
    if k > 0:
        # whole chunks of k steps an epoch: the schedule and the resume count the padding
        steps_per_epoch = int(np.ceil(steps_per_epoch / k)) * k
    total_steps = steps_per_epoch * cfg.epochs
    optimizer, sched = pretrain_optimizer(
        model, cfg.lr, cfg.weight_decay, total_steps, warmup_frac=cfg.warmup_frac,
        lr_min=cfg.lr_min, b1=cfg.adam_b1, b2=cfg.adam_b2,
        mu_dtype=getattr(torch, cfg.adam_mu_dtype) if cfg.adam_mu_dtype else None)

    ckptr = None
    # every rank reads the same checkpoint; rank 0 alone writes
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
            if main:
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

    if mesh is not None:
        replicate(model, mesh, optimizer)
    logger = logger or (MetricLogger(workdir) if main else MetricLogger(echo=False))
    if k > 0:
        chunk_fn = make_fused_pretrain_chunk(model, optimizer, sched, source, seed=cfg.seed,
                                             mesh=mesh)
    else:
        step_fn = make_pretrain_step(model, optimizer, sched, seed=cfg.seed, mesh=mesh)
    own = mesh_slice(bs, mesh)  # this rank's rows of every batch
    t_size, l_size = model_cfg.t_size, model_cfg.l_size
    epoch_losses, rates, capture_seconds, ckpt_seconds = [], [], [], []
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
            if profile_dir and main and epoch == start_epoch + 1:
                prof = _profiler(profile_dir, device)
                prof.start()
            # per-epoch reseeded shuffle and grid shapes
            ep_rng = np.random.default_rng(cfg.seed + epoch)
            shape_rng = _pyrandom.Random(cfg.seed * 1000 + epoch)
            ep_steps, step_losses = 0, []
            captured = sum(chunk_fn.capture_seconds.values()) if k > 0 else 0.0
            t0 = time.perf_counter()
            if k > 0:
                # the shuffled epoch padded (wrapping) to whole [k, bs] chunks; the
                # duplicates train at full weight, as in the JAX package
                n_chunks = steps_per_epoch // k
                order = np.resize(ep_rng.permutation(n), n_chunks * k * bs)
                rows = torch.as_tensor(order.reshape(n_chunks, k, bs)).to(device)  # one upload
                for ci in range(n_chunks):
                    len_t, len_l = choose_grid_shape(t_size, l_size, cfg.mask_ratio, shape_rng)
                    loss = chunk_fn(locs_dev[rows[ci]], len_t, len_l)
                    ep_steps += k
                    step_losses.append(loss * k)
                    if (ci + 1) * k % cfg.log_every < k:
                        logger.log(step=optimizer.count, loss=float(loss),
                                   lr=sched(optimizer.count - 1))
            else:
                batches = list(batch_indices(n, bs, rng=ep_rng))
                rows = torch.as_tensor(np.stack([c for c, _ in batches])).to(device)  # one upload
                for (len_t, len_l), group in group_by_shape(range(len(batches)), t_size, l_size,
                                                             cfg.mask_ratio, shape_rng).items():
                    for i in group:
                        valid = batches[i][1]
                        # the wrapped duplicates of the padded tail weigh 0
                        w = None if valid.all() else torch.as_tensor(valid, dtype=torch.float32,
                                                                     device=device)
                        loss = step_fn(source.gather(locs_dev[rows[i][own]]), len_t, len_l, w)
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
            capture_seconds.append(
                sum(chunk_fn.capture_seconds.values()) - captured if k > 0 else 0.0)
            logger.log(epoch=epoch, epoch_loss=mean_loss, patches_per_sec=pps)
            if main:
                print(f"[pretrain] epoch {epoch}: loss {mean_loss:.4f}  {pps:,.0f} patches/s")
            if workdir and cfg.checkpoint_every_steps and (
                    (epoch + 1) * steps_per_epoch % cfg.checkpoint_every_steps < steps_per_epoch):
                if main:
                    t0 = time.perf_counter()
                    if ckptr is not None:
                        ckptr.save(optimizer.count, model, optimizer)  # returns at once
                    else:
                        save_checkpoint(workdir, optimizer.count, model, optimizer)
                    ckpt_seconds.append(time.perf_counter() - t0)
                barrier()
    finally:
        if prof is not None:
            prof.stop()
        if ckptr is not None:
            ckptr.close()  # every enqueued save on disk before returning
    if workdir and main:
        save_params(f"{workdir}/params_final.pt", model)
        np.save(f"{workdir}/train_log.npy", np.array([epoch_losses, []], dtype=object))
    barrier()
    return model, {"epoch_loss": epoch_losses, "patches_per_sec": rates,
                   "capture_seconds": capture_seconds, "checkpoint_seconds": ckpt_seconds}

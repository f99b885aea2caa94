"""Optimizer and learning-rate schedule of MAE pretraining.

Counterpart of ``hsimae_tpu/train/optim.py`` (``timm_cosine_schedule``,
``wd_mask``, ``adamw``, ``pretrain_optimizer``, ``finetune_optimizer``),
and of the two optax optimizers the baseline harness uses
(``hsimae_tpu/bench/harness.py::make_optimizer``).

* The schedule is timm's ``CosineLRScheduler`` (one cycle): linear warmup
  from ``warmup_lr_init`` for ``t < warmup_t``, else
  ``lr_min + (lr - lr_min) * (1 + cos(pi * t / t_initial)) / 2`` on the
  global ``t``. Pretraining shifts it by one step (timm is stepped after
  the update and starts at ``warmup_lr_init``): ``sched(t) = cosine(max(t-1, 0))``.
  Fine-tuning runs it over epochs, shifted by one epoch.
* Weight decay skips every parameter whose dotted name contains ``bias`` or
  ``norm`` (the reference's rule by name); ``AdamW(decay=decay_all)`` decays
  every parameter, as ``optax.adamw`` without a mask does.
* :class:`AdamW` has optax's ``adamw`` arithmetic: decoupled decay
  ``lr * wd * p`` added to the Adam direction, ``eps`` outside the square
  root, bias correction, the first moment optionally stored in bfloat16.
  Update ``k`` (``k`` updates already applied) runs at ``sched(k)``: the
  caller sets each group's ``lr`` before each step. :meth:`AdamW.step_from`
  is the same update with the rate and the bias corrections read from
  tensors on the device, so a CUDA graph can capture it.
* :class:`RMSprop` has ``optax.rmsprop(lr, momentum=m)``'s arithmetic,
  which is not ``torch.optim.RMSprop``'s.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from hsimae_tpu_torch.parallel.mesh import local_tensor


def timm_cosine_schedule(base_lr: float, t_initial: int, warmup_t: int = 0,
                         lr_min: float = 0.0,
                         warmup_lr_init: float = 0.0) -> Callable[[int], float]:
    """timm ``CosineLRScheduler`` (single cycle) as a function of the step."""

    def schedule(t) -> float:
        t = float(t)
        if warmup_t > 0 and t < warmup_t:
            return warmup_lr_init + t * ((base_lr - warmup_lr_init) / warmup_t)
        return lr_min + 0.5 * (base_lr - lr_min) * (1.0 + math.cos(math.pi * t / max(t_initial, 1)))

    return schedule


def wd_mask(name: str) -> bool:
    """True when the parameter of dotted name ``name`` takes weight decay."""
    name = name.lower()
    return not ("bias" in name or "norm" in name)


def decay_all(name: str) -> bool:
    """Every parameter takes weight decay (``optax.adamw`` without a mask)."""
    return True


class AdamW:
    """AdamW over named parameters, grouped by rate and decay: with one
    rate, ``param_groups[0]`` takes weight decay and ``param_groups[1]``
    does not (``decay(name)``: :func:`wd_mask` by default, :func:`decay_all`
    for every parameter); ``lr_scale(name)`` gives each parameter a
    multiple of the rate, and each multiple gets such a pair. Each group
    holds ``params``, ``names``, ``lr`` (:func:`set_lr` sets it to the rate
    times the group's ``lr_scale`` before each :meth:`step`) and
    ``weight_decay``. The second moment is float32; the first is stored in
    ``mu_dtype`` and updated in float32. A tensor-parallel parameter (a
    ``DTensor``) is updated on the shard this rank holds, and its moments
    are that shard's: the update is elementwise."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None,
                 lr_scale: Optional[Callable[[str], float]] = None,
                 decay: Callable[[str], bool] = wd_mask):
        groups: Dict[Tuple[float, bool], Dict] = {}
        for name, p in named_params:
            if not p.requires_grad:
                continue
            scale = 1.0 if lr_scale is None else float(lr_scale(name))
            for decays in (True, False):  # a pair for each rate, decay first
                groups.setdefault((scale, decays), {
                    "names": [], "params": [], "lr": 0.0, "lr_scale": scale,
                    "weight_decay": weight_decay if decays else 0.0})
            g = groups[scale, bool(decay(name))]
            g["names"].append(name)
            g["params"].append(p)
        self.param_groups = list(groups.values())
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype or torch.float32
        self.count = 0  # updates applied
        self.mu = [[torch.zeros_like(local_tensor(p), dtype=self.mu_dtype) for p in g["params"]]
                   for g in self.param_groups]
        self.nu = [[torch.zeros_like(local_tensor(p), dtype=torch.float32) for p in g["params"]]
                   for g in self.param_groups]

    def zero_grad(self) -> None:
        """Drop every gradient: the next backward allocates new ones (under
        a CUDA graph capture, in the graph's memory pool)."""
        for g in self.param_groups:
            for p in g["params"]:
                p.grad = None

    def bias_corrections(self, k: int) -> Tuple[float, float]:
        """``(1 - b1^k, 1 - b2^k)``, the bias corrections of update ``k``
        (counted from 1)."""
        return 1.0 - self.b1 ** k, 1.0 - self.b2 ** k

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient."""
        k = self.count + 1
        self._update(*self.bias_corrections(k))
        self.count = k

    @torch.no_grad()
    def step_from(self, lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor) -> None:
        """The update of :meth:`step` with the rate and the two bias
        corrections read from 0-d float32 tensors on the parameters'
        device, each group at ``lr`` times its ``lr_scale``: a CUDA graph
        that captures it takes new values from those tensors at each
        replay. ``count`` is the caller's to advance."""
        self._update(bc1, bc2, lr)

    def _update(self, bc1, bc2, lr: Optional[torch.Tensor] = None) -> None:
        """The update, with ``bc1``/``bc2`` floats or 0-d tensors; without
        ``lr`` each group runs at its ``lr``."""
        b1, b2 = self.b1, self.b2
        for g, mus, nus in zip(self.param_groups, self.mu, self.nu):
            live = [i for i, p in enumerate(g["params"]) if p.grad is not None]
            if not live:
                continue
            params = [local_tensor(g["params"][i]) for i in live]
            grads = [local_tensor(g["params"][i].grad).float() for i in live]
            nu = [nus[i] for i in live]
            stored_mu = [mus[i] for i in live]
            mu = stored_mu if self.mu_dtype == torch.float32 else [m.float() for m in stored_mu]
            # mu = b1*mu + (1-b1)*g; nu = b2*nu + (1-b2)*g^2
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            # direction = (mu / bc1) / (sqrt(nu / bc2) + eps)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            if g["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=g["weight_decay"])
            if lr is None:
                torch._foreach_add_(params, upd, alpha=-g["lr"])
            else:
                torch._foreach_mul_(upd, lr if g["lr_scale"] == 1.0 else lr * g["lr_scale"])
                torch._foreach_sub_(params, upd)
            if mu is not stored_mu:
                for dst, src in zip(stored_mu, mu):
                    dst.copy_(src)

    def state_dict(self, cpu: bool = True) -> Dict:
        """Moments by parameter name (CPU copies; with ``cpu=False`` the
        moments themselves, for a caller that copies them) and the update
        count."""
        out = {"count": self.count, "mu": {}, "nu": {}}
        for g, mus, nus in zip(self.param_groups, self.mu, self.nu):
            for name, m, v in zip(g["names"], mus, nus):
                out["mu"][name] = m.detach().cpu() if cpu else m.detach()
                out["nu"][name] = v.detach().cpu() if cpu else v.detach()
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Copy moments saved by :meth:`state_dict` into this optimizer's
        (keeping their dtypes and devices)."""
        with torch.no_grad():
            for g, mus, nus in zip(self.param_groups, self.mu, self.nu):
                for name, m, v in zip(g["names"], mus, nus):
                    m.copy_(state["mu"][name])
                    v.copy_(state["nu"][name])
        self.count = int(state["count"])


class RMSprop:
    """``optax.rmsprop(lr, decay=0.9, eps=1e-8, momentum=m)`` over named
    parameters: ``nu = decay * nu + (1 - decay) * g^2`` (from 0),
    ``u = g / sqrt(nu + eps)`` (eps inside the root), then optax's chain
    scales by the rate before the momentum trace: ``t = m * t - lr * u``,
    ``p += t``. With a rate that changes between steps this is not
    ``-lr * (u + m * t)``. One group (``param_groups[0]``, its ``lr`` set
    before each :meth:`step`, as :class:`AdamW`'s)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 momentum: float = 0.9, decay: float = 0.9, eps: float = 1e-8):
        names, params = zip(*[(n, p) for n, p in named_params if p.requires_grad])
        self.param_groups = [{"names": list(names), "params": list(params), "lr": 0.0,
                              "lr_scale": 1.0}]
        self.momentum, self.decay, self.eps = momentum, decay, eps
        self.nu = [torch.zeros_like(p) for p in params]
        self.trace = [torch.zeros_like(p) for p in params]

    def zero_grad(self) -> None:
        for p in self.param_groups[0]["params"]:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        g = self.param_groups[0]
        live = [i for i, p in enumerate(g["params"]) if p.grad is not None]
        if not live:
            return
        params = [g["params"][i] for i in live]
        grads = [g["params"][i].grad for i in live]
        nu = [self.nu[i] for i in live]
        trace = [self.trace[i] for i in live]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.decay)
        denom = torch._foreach_add(nu, self.eps)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_div(grads, denom)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, upd, alpha=-g["lr"])
        torch._foreach_add_(params, trace)


def pretrain_optimizer(model: torch.nn.Module, lr: float, weight_decay: float,
                       total_steps: int, warmup_frac: float = 0.05, lr_min: float = 1e-6,
                       b1: float = 0.9, b2: float = 0.95,
                       mu_dtype: Optional[torch.dtype] = None) -> Tuple[AdamW, Callable]:
    """(optimizer, sched): per-step cosine with ``ceil(warmup_frac * total)``
    warmup steps from 0, shifted by one step: ``sched(t) = cosine(max(t-1, 0))``."""
    inner = timm_cosine_schedule(lr, t_initial=total_steps,
                                 warmup_t=int(math.ceil(total_steps * warmup_frac)),
                                 lr_min=lr_min, warmup_lr_init=0.0)

    def sched(t) -> float:
        return inner(max(int(t) - 1, 0))

    opt = AdamW(model.named_parameters(), weight_decay, b1=b1, b2=b2, mu_dtype=mu_dtype)
    return opt, sched


def finetune_optimizer(model: torch.nn.Module, lr: float, weight_decay: float, epochs: int,
                       steps_per_epoch: int, warmup_frac: float = 0.1,
                       encoder_lr_scale: float = 1.0) -> Tuple[AdamW, Callable]:
    """(optimizer, sched) of dual-branch fine-tuning: a cosine over EPOCHS
    with ``ceil(warmup_frac * epochs)`` warmup epochs, initial and floor
    rate ``lr * 0.01``, shifted by one epoch (the reference steps its
    scheduler after each epoch): update ``t`` runs at
    ``cosine(max(t // steps_per_epoch - 1, 0))``. Betas (0.9, 0.999).

    ``encoder_lr_scale`` multiplies the rate of every parameter outside
    ``cls_head`` (and so its decay, which the rate multiplies): with any
    value but 1 the optimizer has a head rate and an encoder rate; 0 freezes
    the encoder while the head trains."""
    inner = timm_cosine_schedule(lr, t_initial=epochs,
                                 warmup_t=int(math.ceil(warmup_frac * epochs)),
                                 lr_min=lr * 0.01, warmup_lr_init=lr * 0.01)

    def sched(t) -> float:
        return inner(max(int(t) // max(steps_per_epoch, 1) - 1, 0))

    def scale(name: str) -> float:
        return 1.0 if name.split(".")[0] == "cls_head" else encoder_lr_scale

    opt = AdamW(model.named_parameters(), weight_decay, b1=0.9, b2=0.999,
                lr_scale=None if encoder_lr_scale == 1.0 else scale)
    return opt, sched


def set_lr(optimizer: AdamW, lr: float) -> None:
    """Set every group's learning rate to ``lr`` times its ``lr_scale``
    (before each step)."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_scale"]

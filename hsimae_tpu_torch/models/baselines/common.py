"""Shared primitives of the baseline zoo.

Counterpart of ``hsimae_tpu/models/baselines/common.py``: the pre-norm
residual transformer with a fused-qkv attention, the GELU feed-forward,
and the conv -> BatchNorm -> ReLU stem, plus what the JAX zoo takes from
flax and torch lacks.

Conventions (all zoo nets):
* the forward takes channels-last ``[B, h, w, bands]``, as the JAX zoo's
  does, and permutes once inside to the channels-first layout of PyTorch's
  convolutions;
* parameter names and shapes are the reference torch models' (the names
  ``hsimae_tpu/models/baselines/convert.py`` reads), so a net's
  ``state_dict`` goes through the JAX converter into the flax model and
  back through :func:`hsimae_tpu_torch.models.baselines.convert.from_jax_zoo`;
* :class:`BatchNorm` has flax's semantics; ``self.training`` plays the part
  of flax's ``train`` flag;
* :class:`Dropout` keep masks can be injected (:func:`set_dropout_masks`);
* :func:`init_like_flax` initialises as the flax modules do.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# a keep-mask source: (shape, keep probability, device) -> bool tensor of that shape
MaskFn = Callable[[Sequence[int], float, torch.device], torch.Tensor]

# flax's truncated-normal initialisers divide the standard deviation by the
# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over axis 1 of ``[B, C, ...]``.

    In training it normalises by the batch's biased statistics (flax's fast
    variance, ``E[x^2] - E[x]^2`` clipped at 0) and updates
    ``running = m * running + (1 - m) * stat`` with the flax momentum ``m``
    (flax 0.9 is torch's 0.1), the variance biased too; in eval it
    normalises by the running statistics. ``y = (x - mean) * (weight *
    rsqrt(var + eps)) + bias``. Parameters ``weight``/``bias``, buffers
    ``running_mean``/``running_var`` (torch's names; no
    ``num_batches_tracked``)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = [0] + list(range(2, x.ndim))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class MaxPool2d(nn.Module):
    """``F.max_pool2d`` whose routing can be read and injected. With
    ``record`` set, ``last_route`` keeps each window's flat argmax (as
    ``return_indices`` gives it); with ``route`` set, each window takes the
    element ``route`` names instead of its own maximum, and ``route_gap``
    is the most by which a routed element falls below its window's maximum.
    Rounding can flip a near-tie, so a check of one implementation's
    gradients against another's routes both alike."""

    def __init__(self, kernel_size: int, stride: int):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.record, self.route = False, None
        self.last_route: Optional[torch.Tensor] = None
        self.route_gap: Optional[float] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.route is None and not self.record:
            return F.max_pool2d(x, self.kernel_size, self.stride)
        y, idx = F.max_pool2d(x, self.kernel_size, self.stride, return_indices=True)
        if self.record:
            self.last_route = idx.detach()
        if self.route is None:
            return y
        routed = x.flatten(2).gather(2, self.route.to(x.device).flatten(2)).view_as(y)
        self.route_gap = (y - routed).max().item()
        return routed


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; in eval, or
    at rate 0, the identity. The keep mask comes from ``self.masks(shape,
    keep, device)`` when set (an injected draw), else from ``torch.rand``
    on the input's device."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.masks: Optional[MaskFn] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = (self.masks(x.shape, keep, x.device) if self.masks is not None
                else torch.rand(x.shape, device=x.device) < keep)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_dropout_masks(model: nn.Module, masks: Optional[MaskFn]) -> None:
    """Give every :class:`Dropout` of ``model`` the keep-mask source
    ``masks`` (``None``: draw with ``torch.rand`` again)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.masks = masks


def all_keep(shape, keep: float, device) -> torch.Tensor:
    """A keep-mask source that keeps everything (dropout off in training)."""
    return torch.ones(tuple(shape), dtype=torch.bool, device=device)


def variance_scaling_(w: torch.Tensor, fan: float,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``variance_scaling(1.0, ..., "truncated_normal")`` with the fan
    given: a unit normal truncated to [-2, 2] times ``sqrt(1 / fan) /
    0.8796``."""
    std = math.sqrt(1.0 / fan) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def normal_(w: torch.Tensor, std: float, generator: Optional[torch.Generator] = None):
    """flax ``initializers.normal(std)``."""
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


def init_like_flax(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise ``model`` as its flax counterpart initialises: every
    Linear and Conv kernel ``lecun_normal`` (fan-in = a kernel's input
    channels a group times its window), every bias 0; norms keep torch's
    ones and zeros, PReLU its 0.25. Then each module with an ``init_flax``
    method draws its own explicitly initialised parameters."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            variance_scaling_(m.weight, m.weight[0].numel(), generator=generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "init_flax"):
            m.init_flax(generator)
    return model


def conv_bn_relu(conv: nn.Module, features: int) -> nn.Sequential:
    """``conv`` -> :class:`BatchNorm` -> ReLU as the reference's
    ``nn.Sequential`` (its parameters at ``.0`` and ``.1``)."""
    return nn.Sequential(conv, BatchNorm(features), nn.ReLU())


class MlpBlock(nn.Module):
    """Linear -> GELU -> Dropout -> Linear -> Dropout as ``net`` (the zoo's
    FeedForward: its Linears at ``net.0`` and ``net.3``)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(), Dropout(dropout),
                                 nn.Linear(hidden_dim, dim), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class FusedAttention(nn.Module):
    """Multi-head self-attention with a fused qkv projection ``to_qkv``.
    ``scale`` defaults to ``head_dim ** -0.5`` (SSFTT passes ``dim **
    -0.5``). The output projection is ``nn1`` followed by dropout (SSFTT's
    names) or, with ``out="to_out"``, ``to_out = Sequential(Linear,
    Dropout)`` (SpectralFormer's)."""

    def __init__(self, dim: int, heads: int, dim_head: Optional[int] = None,
                 dropout: float = 0.0, qkv_bias: bool = True, scale: Optional[float] = None,
                 out: str = "nn1"):
        super().__init__()
        self.heads = heads
        self.hd = dim_head or dim // heads
        inner = self.hd * heads
        self.scale = scale if scale is not None else self.hd ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=qkv_bias)
        proj, drop = nn.Linear(inner, dim), Dropout(dropout)
        self.out = out
        if out == "to_out":
            self.to_out = nn.Sequential(proj, drop)
        else:
            self.nn1, self.do1 = proj, drop

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.to_qkv(x).reshape(b, n, 3, self.heads, self.hd).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, self.heads * self.hd)
        return self.to_out(o) if self.out == "to_out" else self.do1(self.nn1(o))


class PreNorm(nn.Module):
    """``fn(norm(x))`` with a LayerNorm ``norm`` (eps 1e-5)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class Residual(nn.Module):
    """``fn(x) + x``."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x) + x


class TransformerEncoder(nn.Module):
    """``depth`` x (``x + attn(ln x)``; ``x + mlp(ln x)``), laid out as the
    reference's ``layers.{i}.0.fn.{norm,fn}`` / ``layers.{i}.1.fn.{norm,fn}``."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: Optional[int] = None, dropout: float = 0.0,
                 attn_scale: Optional[float] = None):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Residual(PreNorm(dim, FusedAttention(dim, heads, dim_head, dropout,
                                                     scale=attn_scale))),
                Residual(PreNorm(dim, MlpBlock(dim, mlp_dim, dropout))),
            ]) for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, mlp in self.layers:
            x = mlp(attn(x))
        return x


def hwc_to_chw(x: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, C]`` -> ``[B, C, h, w]``, contiguous. A permuted view
    would carry the channels-last strides into every layer after it, and
    CUDA's ``avg_pool2d`` backward on a channels-last input with a
    contiguous gradient returns a wrong gradient (torch 2.11)."""
    return x.permute(0, 3, 1, 2).contiguous()


def chw_to_hwc(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, h, w]`` -> ``[B, h, w, C]``."""
    return x.permute(0, 2, 3, 1)


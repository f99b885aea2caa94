"""GSC-ViT: groupwise separable convolution + groupwise pixel/patch
self-attention stages.

Counterpart of ``hsimae_tpu/models/baselines/gscvit.py`` with the
reference's parameter names. The quirks stay: the stem applies BN+ReLU
twice; the stage count is ``len(dims) - 1`` while the post-norm test
compares against ``len(depth) - 1``, so every stage built has a post-norm;
a block's output replaces its input (no residual). The reference's
``conv_last`` is never called and is left out.

GSSA: the map is tiled into ``gss x gss`` spatial groups, each group gets a
learned group token, attention runs within each group (token included);
then the group tokens attend to each other and their attention weights
re-aggregate the grouped feature maps across groups.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hsimae_tpu_torch.models.baselines.common import BatchNorm, Dropout, hwc_to_chw, normal_


class ChanLayerNorm(nn.Module):
    """LayerNorm over the channels of ``[B, C, H, W]`` with ``g`` / ``b`` of
    shape ``[1, C, 1, 1]`` (biased variance, eps 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hwc_to_chw(F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.g.reshape(-1),
                                       self.b.reshape(-1), self.eps))


class GSC(nn.Module):
    """Grouped pointwise conv -> grouped 3x3 conv -> BN -> ReLU."""

    def __init__(self, dim_in: int, dim_out: int, padding: int, num_groups: int):
        super().__init__()
        self.gpwc = nn.Conv2d(dim_in, dim_out, 1, groups=num_groups)
        self.gc = nn.Conv2d(dim_out, dim_out, 3, padding=padding, groups=num_groups)
        self.bn = BatchNorm(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.gc(self.gpwc(x))))


class GSSA(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 16,
                 group_spatial_size: int = 4, dropout: float = 0.0):
        super().__init__()
        self.heads, self.d, self.g = heads, dim_head, group_spatial_size
        inner = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, inner * 3, 1, bias=False)
        self.group_tokens = nn.Parameter(torch.empty(dim))
        self.group_tokens_to_qk = nn.Sequential(nn.LayerNorm(dim_head, eps=1e-5), nn.GELU(),
                                                nn.Identity(), nn.Conv1d(inner, inner * 2, 1))
        self.attn_dropout = Dropout(dropout)
        self.to_out = nn.Sequential(nn.Conv2d(inner, dim, 1), Dropout(dropout))

    def init_flax(self, generator):
        normal_(self.group_tokens, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        b, c, hh, ww = x.shape
        g, h, d = self.g, self.heads, self.d
        nx, ny = hh // g, ww // g
        n_groups = nx * ny
        inner = h * d
        # tile into groups: [(b nx ny), g*g, C]
        xg = x.permute(0, 2, 3, 1).reshape(b, nx, g, ny, g, c).permute(0, 1, 3, 2, 4, 5)
        xg = xg.reshape(b * n_groups, g * g, c)
        xg = torch.cat([self.group_tokens.expand(xg.shape[0], 1, c), xg], dim=1)
        qkv = F.linear(xg, self.to_qkv.weight[:, :, 0])
        q, k, v = qkv.reshape(xg.shape[0], -1, 3, h, d).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q * d ** -0.5) @ k.transpose(-1, -2), dim=-1)
        out = self.attn_dropout(attn) @ v  # [bG, h, gg+1, d]
        group_tok, fmap = out[:, :, 0], out[:, :, 1:]

        if n_groups > 1:
            # the group tokens attend across groups
            gt = group_tok.reshape(b, n_groups, h, d).transpose(1, 2)  # [b, h, G, d]
            norm, act, _, qk = self.group_tokens_to_qk
            y = act(norm(gt)).transpose(1, 2).reshape(b, n_groups, inner)
            y = F.linear(y, qk.weight[:, :, 0], qk.bias)  # mixes heads
            wq, wk = y.reshape(b, n_groups, h, 2 * d).transpose(1, 2).chunk(2, dim=-1)
            w_attn = torch.softmax((wq * d ** -0.5) @ wk.transpose(-1, -2), dim=-1)
            w_attn = self.attn_dropout(w_attn)
            fm = fmap.reshape(b, n_groups, h, g * g, d).transpose(1, 2)  # [b, h, G, gg, d]
            fm = torch.einsum("bhij,bhjnd->bhind", w_attn, fm)
            fmap = fm.transpose(1, 2).reshape(b * n_groups, h, g * g, d)

        # reassemble the map: [b, inner, H, W]
        fm = fmap.transpose(1, 2).reshape(b, nx, ny, g, g, inner)
        fm = fm.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, inner)
        return self.to_out(hwc_to_chw(fm))


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChanLayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class _Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, gss: int, dropout: float,
                 norm_output: bool):
        super().__init__()
        self.layers = nn.ModuleList([_PreNorm(dim, GSSA(dim, heads, 16, gss, dropout))
                                     for _ in range(depth)])
        if norm_output:
            self.norm = ChanLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)  # no residual, as the reference
        return self.norm(x) if hasattr(self, "norm") else x


class _SpectralCalibration(nn.Module):
    def __init__(self, channels: int, out: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out, 1)
        self.bn = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class GSCViT(nn.Module):
    def __init__(self, num_classes: int, channels: int, depth: Tuple[int, ...] = (1, 1, 1),
                 heads: Tuple[int, ...] = (1, 1, 1), group_spatial_size: Sequence[int] = (4, 4, 4),
                 padding: Sequence[int] = (1, 1, 1), dims: Tuple[int, ...] = (256, 128, 64),
                 num_groups: Sequence[int] = (16, 16, 16), dropout: float = 0.1):
        super().__init__()
        self.sc = _SpectralCalibration(channels, 256)
        self.bn_1 = BatchNorm(256)
        stages = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            stages.append(nn.ModuleList([
                GSC(din, dout, padding[i], num_groups[i]),
                _Transformer(dout, depth[i], heads[i], group_spatial_size[i], dropout,
                             norm_output=i != len(depth) - 1),
                BatchNorm(dout), nn.ReLU(), nn.Conv2d(dout, dout, 1)]))
        self.layers_trans = nn.ModuleList(stages)
        self.mlp_head = nn.Sequential(nn.Identity(), nn.LayerNorm(dims[-1], eps=1e-5),
                                      nn.Linear(dims[-1], num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.sc(hwc_to_chw(x))
        x = F.relu(self.bn_1(x))
        for gsc, transformer, bn, relu, pw in self.layers_trans:
            x = gsc(x)
            y = x
            x = relu(bn(pw(transformer(x)) + y))
        return self.mlp_head(x.mean(dim=(2, 3)))


"""DCTN: multiscale 3-D / grouped-2-D patch embedding (MDCP) + EISA
attention-permutator stages + a parallel conv path, concat-fused head.

Counterpart of ``hsimae_tpu/models/baselines/dctn.py`` with the
reference's parameter names:

* ``AdaptiveAvgPool3d`` is ``F.adaptive_avg_pool*``, whose bins are the
  JAX zoo's pooling matrices' (an axis already at its size is left alone
  in both);
* the composite head pools the conv path, the token path and the
  downsampled embedding to the token grid before the 1x1 ``ConvEnd`` (the
  JAX zoo's reading of a head whose shapes cannot concatenate as the
  reference writes them);
* the block norm is a GroupNorm (16 groups; 8 when dim == 440, eps 1e-5),
  and the block replaces ``x`` with ``norm(x)`` before its residual.

The reference's unused parameters (EISA's ``conv``, the model's
``gamma1`` / ``gamma3`` / ``weights`` / ``conv_cls_head``) are left out.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hsimae_tpu_torch.models.baselines.common import BatchNorm, MaxPool2d, chw_to_hwc, hwc_to_chw


def adaptive_avg_pool(x: torch.Tensor, sizes: Tuple[int, ...]) -> torch.Tensor:
    """torch's adaptive average pooling of the trailing ``len(sizes)`` axes
    of a channels-first tensor (2-D or 3-D)."""
    if tuple(x.shape[-len(sizes):]) == tuple(sizes):
        return x
    pool = F.adaptive_avg_pool3d if len(sizes) == 3 else F.adaptive_avg_pool2d
    return pool(x, sizes)


class Add2D(nn.Module):
    """Grouped 3x3 + grouped 5x5 against a 1x1 shortcut, BN on each."""

    def __init__(self, features: int, groups: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, groups=groups)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 5, padding=2, groups=groups)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, features, 1)
        self.bn3 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(self.bn3(self.conv3(x)) + y)


class MDCP(nn.Module):
    """Multiscale dual-path patch embedding: ``[B, h, w, bands]`` ->
    ``[B, embed_dim, 7, 7]`` (channels-first)."""

    def __init__(self, bands: int, embed_dim: int, groups: int, groups_width: int,
                 pool_depth: int):
        super().__init__()
        self.bands, self.pool_depth = bands, pool_depth
        new_bands = math.ceil(bands / groups) * groups
        width = groups * groups_width
        self.conv_1 = nn.Conv2d(new_bands, width, 1, groups=groups)
        self.bn_1 = BatchNorm(width)
        self.add2D = Add2D(width, groups)
        self.proj = nn.Conv3d(1, 4, (11, 7, 7), padding=(0, 3, 3))
        self.proj2 = nn.Conv3d(4, 8, (9, 5, 5), padding=(0, 2, 2))
        self.bn = BatchNorm(8)
        self.weights = nn.Parameter(torch.ones(2))
        self.down_sample = nn.Conv2d(8 * pool_depth, embed_dim, 3, stride=2)

    def init_flax(self, generator):
        nn.init.ones_(self.weights)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = hwc_to_chw(x)
        pad = self.conv_1.in_channels - self.bands
        # replication pad at the end of the band axis
        x1 = torch.cat([xc, xc[:, -1:].expand(-1, pad, -1, -1)], 1) if pad else xc
        x1 = self.add2D(F.relu(self.bn_1(self.conv_1(x1))))

        # the 3-D path over (bands, h, w) with one input channel
        y = self.proj2(self.proj(xc.unsqueeze(1)))
        y = self.bn(adaptive_avg_pool(y, (self.pool_depth, 15, 15)))
        b, c, s, hh, ww = y.shape
        # c-major fold: feature = channel * depth + d
        y = y.reshape(b, c * s, hh, ww)

        x1 = adaptive_avg_pool(x1, (hh, ww))
        return self.down_sample(y * self.weights[0] + x1 * self.weights[1])


class FFNConv(nn.Module):
    """1x1 -> GELU -> depthwise 3x3 -> GELU -> 1x1, bias-free."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.Conv1 = nn.Conv2d(dim, hidden, 1, bias=False)
        self.proj1 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden, bias=False)
        self.Conv2 = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv2(F.gelu(self.proj1(F.gelu(self.Conv1(x)))))


class EISA(nn.Module):
    """Efficient interactive self-attention: sigmoid-gated height, width and
    spectral branches mixed by small 1-D convs. Layers built with the
    reference's ``bias=qkv_bias`` are bias-free, its ``*2`` convs keep a
    bias."""

    def __init__(self, dim: int, spatial: int):
        super().__init__()
        self.mlp_h = nn.Conv2d(dim, dim, 1, bias=False)
        self.mlp_w = nn.Conv2d(dim, dim, 1, bias=False)
        self.mlp_s = nn.Conv2d(dim, dim, 1, bias=False)
        self.convH = nn.Conv1d(1, 1, 1, bias=False)
        self.convH2 = nn.Conv1d(1, 1, 3, padding=1)
        self.mix_hw = nn.Conv1d(2, 1, 1, bias=False)
        self.mix_hw2 = nn.Conv1d(1, 1, 3, padding=1)
        self.linearH = nn.Linear(spatial, dim)
        self.linearW = nn.Linear(spatial, dim)
        self.mix_hws = nn.Conv1d(3, 1, 1, bias=False)
        self.mix_hws2 = nn.Conv1d(1, 1, 3, padding=1)
        self.mix_all = nn.Conv2d(3 * dim, dim, 1, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.weights = nn.Parameter(torch.ones(2))

    def init_flax(self, generator):
        nn.init.ones_(self.weights)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        # height branch: a gate per row
        hmap = F.gelu(self.mlp_h(x))
        h2 = hmap.mean(dim=(1, 3))[:, None]  # [B, 1, H], pooled over W and C
        h3 = torch.sigmoid(self.convH2(torch.sigmoid(self.convH(h2))))
        h_out = hmap * h3[:, :, :, None]
        # width branch: its gate mixes the H and W statistics (H == W)
        wmap = F.gelu(self.mlp_w(x))
        w2 = wmap.mean(dim=(1, 2))[:, None]  # [B, 1, W]
        mix = torch.sigmoid(self.mix_hw2(torch.sigmoid(self.mix_hw(torch.cat([h2, w2], 1)))))
        w_out = wmap * mix[:, :, None, :]
        # spectral branch: its gate mixes H, W and channel statistics
        smap = F.gelu(self.mlp_s(x))
        s1 = smap.mean(dim=(2, 3))  # [B, C]
        mixs = torch.stack([self.linearH(h2[:, 0]), self.linearW(w2[:, 0]), s1], 1)  # [B, 3, C]
        mixs = torch.sigmoid(self.mix_hws2(torch.sigmoid(self.mix_hws(mixs))))  # [B, 1, C]
        s_out = smap * mixs[:, 0, :, None, None]
        z = self.mix_all(torch.cat([h_out, w_out, s_out], 1))
        z = hwc_to_chw(self.proj(chw_to_hwc(z)))
        return z * self.weights[0] + x * self.weights[1]


class PermutatorBlock(nn.Module):
    def __init__(self, dim: int, spatial: int, mlp_ratio: float = 3.0):
        super().__init__()
        groups = 8 if dim == 440 else 16
        self.norm1 = nn.GroupNorm(groups, dim, eps=1e-5)
        self.attn = EISA(dim, spatial)
        self.norm2 = nn.GroupNorm(groups, dim, eps=1e-5)
        self.mlp = FFNConv(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the reference's quirk: the block replaces x with norm(x), so the
        # residual base is the normed tensor
        x = self.norm1(x)
        x = x + self.attn(x)
        x = self.norm2(x)
        return x + self.mlp(x)


class Downsample(nn.Module):
    def __init__(self, din: int, dout: int, ps: int):
        super().__init__()
        self.proj = nn.Conv2d(din, dout, ps, stride=ps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class DCTN(nn.Module):
    def __init__(self, layers: Tuple[int, ...], bands: int, num_classes: int,
                 embed_dims: Tuple[int, ...], transitions: Tuple[bool, ...],
                 segment_dim: Tuple[int, ...], mlp_ratios: Tuple[float, ...],
                 groups: int = 5, groups_width: int = 64, pool_depth: int = 40):
        super().__init__()
        self.patch_embed = MDCP(bands, embed_dims[0], groups, groups_width, pool_depth)
        spatial = (15 - 3) // 2 + 1  # MDCP pools to 15x15, then a 3x3 conv of stride 2
        network = []
        for i, n_blocks in enumerate(layers):
            network.append(nn.ModuleList([PermutatorBlock(embed_dims[i], spatial, mlp_ratios[i])
                                          for _ in range(n_blocks)]))
            if i < len(layers) - 1 and (transitions[i] or embed_dims[i] != embed_dims[i + 1]):
                ps = 2 if transitions[i] else 1
                network.append(Downsample(embed_dims[i], embed_dims[i + 1], ps))
                spatial = (spatial - ps) // ps + 1
        self.network = nn.ModuleList(network)
        e0, e1 = embed_dims[0], embed_dims[-1]
        for name, cin, cout, grp in (("conv2", e0, 128, 1), ("conv2_2", 128, 128, 128),
                                     ("conv3", 128, 256, 1), ("conv3_2", 256, 256, 1),
                                     ("conv4", 256, e1, 1), ("conv4_2", e1, e1, e1)):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1, groups=grp))
            setattr(self, f"bn{name[4:]}", BatchNorm(cout))
        self.pool = MaxPool2d(2, 2)
        self.down_sample = Downsample(e0, 512, 2)
        self.ConvEnd = nn.Conv2d(2 * e1 + 512, e1, 1)
        self.norm = nn.LayerNorm(e1, eps=1e-5)
        self.head = nn.Linear(e1, num_classes)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(getattr(self, f"bn{name[4:]}")(getattr(self, name)(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        emb = self.patch_embed(x)  # [B, e0, 7, 7]
        z = emb
        for stage in self.network:
            if isinstance(stage, Downsample):
                z = stage(z)
            else:
                for block in stage:
                    z = block(z)
        # the parallel conv path from the embedding
        c = self._conv("conv2_2", self._conv("conv2", emb))
        c = self.pool(self._conv("conv3", c))
        c = self._conv("conv4_2", self._conv("conv4", self._conv("conv3_2", c)))
        e = self.down_sample(emb)
        # all three pooled to the token grid
        hw = tuple(z.shape[2:])
        z = self.ConvEnd(torch.cat([adaptive_avg_pool(c, hw), z, adaptive_avg_pool(e, hw)], 1))
        z = self.norm(z.flatten(2).transpose(1, 2))
        return self.head(z.mean(dim=1))

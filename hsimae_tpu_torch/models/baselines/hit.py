"""HiT: dynamic 3-D conv patch embedding + permute-MLP ("Vision
Permutator") stages.

Counterpart of ``hsimae_tpu/models/baselines/hit.py`` with the reference's
parameter names:

* PatchEmbed: two dynamic 3-D convs, each a per-sample mixture of K = 4
  kernels weighted by a softmax over a squeeze-excite attention, with a
  sigmoid gate on its input (``local``: pool the map, a (3,1,1) conv along
  the spectral axis, BatchNorm with flax momentum 0.99 and eps 1e-3, a
  1x1x1 conv that starts at zero). The per-sample convolution is one
  grouped convolution with ``groups = B``. The (channels, depth) axes of
  the output fold into the token features, c-major;
* ``embed_proj`` (a Linear) where that fold differs from ``embed_dims[0]``
  (the JAX zoo's addition: the reference has no such layer);
* stages of Permutator blocks whose token mixer is ConvPermuteMLP
  (depthwise (1,3) / (3,1) and pointwise branches, softmax-reweighted),
  with a downsampling conv between stages where the width changes or a
  transition is set; the JAX zoo's other mixer, WeightedPermuteMLP
  (``use_conv_mixer=False``), which no registry spec and no converter
  uses, is not ported; ``segment_dim`` is kept for the JAX signature and
  unused, as it is there with the conv mixer;
* LayerNorm, mean over tokens, a linear head.

The reference's ``conv_cls_head`` and the dynamic convs' bias are never
used and are left out.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hsimae_tpu_torch.models.baselines.common import BatchNorm, chw_to_hwc, hwc_to_chw, normal_


class _KernelAttention(nn.Module):
    def __init__(self, in_planes: int, K: int):
        super().__init__()
        hidden = int(in_planes * 4) + 1
        self.fc1 = nn.Conv3d(in_planes, hidden, 1, bias=False)
        self.fc2 = nn.Conv3d(hidden, K, 1, bias=False)


class _LocalGate(nn.Module):
    def __init__(self, in_planes: int):
        super().__init__()
        self.a = nn.Conv3d(in_planes, in_planes * 4, (3, 1, 1), padding=(1, 0, 0))
        self.bn = BatchNorm(in_planes * 4, momentum=0.99, eps=1e-3)
        self.b = nn.Conv3d(in_planes * 4, in_planes, 1, bias=False)

    def init_flax(self, generator):
        nn.init.zeros_(self.b.weight)


class DynamicConv3d(nn.Module):
    """K-kernel dynamic conv over ``[B, Cin, s, h, w]``."""

    def __init__(self, in_planes: int, out_planes: int, kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int], padding: int = 1, K: int = 4,
                 temperature: float = 4.0):
        super().__init__()
        self.stride, self.padding, self.temperature = stride, padding, temperature
        self.attention = _KernelAttention(in_planes, K)
        self.local = _LocalGate(in_planes)
        self.weight = nn.Parameter(torch.empty(K, out_planes, in_planes, *kernel))

    def init_flax(self, generator):
        normal_(self.weight, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, cin = x.shape[:2]
        att = self.attention
        g = x.mean(dim=(2, 3, 4))  # [B, Cin]
        g = F.relu(F.linear(g, att.fc1.weight.flatten(1)))
        att = torch.softmax(F.linear(g, att.fc2.weight.flatten(1)) / self.temperature, dim=-1)
        # local gate: pool the map, conv along the spectral axis
        y = x.mean(dim=(3, 4), keepdim=True)  # [B, Cin, s, 1, 1]
        y = F.relu(self.local.bn(self.local.a(y)))
        x = x * torch.sigmoid(self.local.b(y))
        # per-sample kernel mixtures as one grouped conv (groups = B)
        agg = torch.einsum("bk,koidhw->boidhw", att, self.weight)
        out = F.conv3d(x.reshape(1, b * cin, *x.shape[2:]), agg.reshape(-1, *agg.shape[2:]),
                       stride=self.stride, padding=self.padding, groups=b)
        return out.reshape(b, -1, *out.shape[2:])


class _PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj1_1 = DynamicConv3d(1, 4, (3, 3, 3), (2, 2, 2))
        self.proj2_1 = DynamicConv3d(4, 8, (3, 3, 3), (2, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj2_1(self.proj1_1(x))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ConvPermuteMLP(nn.Module):
    """Depthwise (1,3) / (3,1) / pointwise branches, softmax-reweighted;
    bias-free convs (the reference's ``qkv_bias=False`` reaches them)."""

    def __init__(self, dim: int):
        super().__init__()
        self.mlp_c = nn.Sequential(nn.Conv2d(dim, dim, (1, 3), padding=(0, 1), groups=dim,
                                             bias=False))
        self.mlp_h = nn.Sequential(nn.Conv2d(dim, dim, (3, 1), padding=(1, 0), groups=dim,
                                             bias=False))
        self.mlp_w = nn.Conv2d(dim, dim, 1, bias=False)
        self.reweight = Mlp(dim, dim // 4, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, hh, ww, c = x.shape
        xc = hwc_to_chw(x)
        h, w, cc = self.mlp_c(xc), self.mlp_h(xc), self.mlp_w(xc)  # [B, C, H, W]
        a = self.reweight((h + w + cc).mean(dim=(2, 3)))
        a = torch.softmax(a.reshape(b, c, 3), dim=-1).permute(2, 0, 1)[:, :, :, None, None]
        z = h * a[0] + w * a[1] + cc * a[2]
        # the reference's quirk: the channel-first sum is RESHAPED (not permuted)
        # to [B, H, W, C], a memory scramble that feeds proj a mix of axes
        return self.proj(z.reshape(b, hh, ww, c))


class PermutatorBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 3.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ConvPermuteMLP(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Downsample(nn.Module):
    def __init__(self, din: int, dout: int, ps: int):
        super().__init__()
        self.proj = nn.Conv2d(din, dout, ps, stride=ps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # channels-last in and out
        return chw_to_hwc(self.proj(hwc_to_chw(x)))


def _fold_width(bands: int) -> int:
    """The token width after the two dynamic convs: 8 channels times the
    spectral length (kernel 3, padding 1, strides 2 and 2)."""
    s1 = (bands - 1) // 2 + 1
    return 8 * ((s1 - 1) // 2 + 1)


class HiT(nn.Module):
    def __init__(self, bands: int, num_classes: int, layers: Tuple[int, ...] = (4, 3, 14, 3),
                 embed_dims: Tuple[int, ...] = (480, 480, 512, 512),
                 transitions: Tuple[bool, ...] = (False, True, False, False),
                 segment_dim: Tuple[int, ...] = (8, 8, 4, 4),
                 mlp_ratios: Tuple[float, ...] = (3.0, 3.0, 3.0, 3.0)):
        super().__init__()
        self.patch_embed = _PatchEmbed()
        fold = _fold_width(bands)
        if fold != embed_dims[0]:
            self.embed_proj = nn.Linear(fold, embed_dims[0])
        network = []
        for i, n_blocks in enumerate(layers):
            network.append(nn.ModuleList([PermutatorBlock(embed_dims[i], mlp_ratios[i])
                                          for _ in range(n_blocks)]))
            if i < len(layers) - 1 and (transitions[i] or embed_dims[i] != embed_dims[i + 1]):
                ps = 2 if transitions[i] else 1
                network.append(Downsample(embed_dims[i], embed_dims[i + 1], ps))
        self.network = nn.ModuleList(network)
        self.norm = nn.LayerNorm(embed_dims[-1], eps=1e-5)
        self.head = nn.Linear(embed_dims[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.patch_embed(hwc_to_chw(x).unsqueeze(1))  # [B, 8, s, h, w]
        b, c, s, hh, ww = z.shape
        # (C, D) fold into the token features, c-major: feature = channel * D + d
        z = z.permute(0, 3, 4, 1, 2).reshape(b, hh, ww, c * s)
        if hasattr(self, "embed_proj"):
            z = self.embed_proj(z)
        for stage in self.network:
            if isinstance(stage, Downsample):
                z = stage(z)
            else:
                for block in stage:
                    z = block(z)
        z = self.norm(z.reshape(b, -1, z.shape[-1]))
        return self.head(z.mean(dim=1))

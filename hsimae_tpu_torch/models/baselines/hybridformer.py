"""HybridFormer: conv feature-extraction stem + parallel multi-patch-size
transformer branches with a conv FFN and joint spatial + spectral
attention, fused by a weighted head.

Counterpart of ``hsimae_tpu/models/baselines/hybridformer.py`` with the
reference's parameter names. Its quirks stay:

* the conv FFN adds its own residual and the transformer adds another;
* attention maps pass through a 3x3 conv over the head axis; a second,
  spectral attention over the transposed tokens right-multiplies the block
  output;
* branch weights are softmax(ones), uniform.

The reference's unused parameters (each branch's cls token, the patchify
depthwise conv's ``point_conv``, ``spatial_norm`` / ``spectral_norm``) are
left out, as the JAX zoo leaves them out.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hsimae_tpu_torch.models.baselines.common import (
    BatchNorm,
    Dropout,
    conv_bn_relu,
    hwc_to_chw,
)


class OurFE(nn.Module):
    """Three chained 1x1 conv+BN+ReLU; their concatenation -> 3x3 conv+BN+ReLU."""

    def __init__(self, in_ch: int, channel: int):
        super().__init__()
        self.conv1 = conv_bn_relu(nn.Conv2d(in_ch, channel, 1), channel)
        self.conv2 = conv_bn_relu(nn.Conv2d(channel, channel, 1), channel)
        self.conv3 = conv_bn_relu(nn.Conv2d(channel, channel, 1), channel)
        self.out_conv = conv_bn_relu(nn.Conv2d(3 * channel, channel, 3, padding=1), channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o1 = self.conv1(x)
        o2 = self.conv2(o1)
        o3 = self.conv3(o2)
        return self.out_conv(torch.cat([o1, o2, o3], dim=1))


class _DepthwisePointwise(nn.Module):
    def __init__(self, c: int, out: int):
        super().__init__()
        self.depth_conv = nn.Conv2d(c, c, 3, padding=1, groups=c)
        self.point_conv = nn.Conv2d(c, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.point_conv(self.depth_conv(x))


class ConvFFN(nn.Module):
    """Depthwise 3x3 -> 1x1 to 256 -> BN -> 1x1 to 512 -> GELU -> 1x1 to
    dim -> GELU on the token grid, with an internal residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(_DepthwisePointwise(dim, 256), BatchNorm(256),
                                 nn.Conv2d(256, 512, 1), nn.GELU(), nn.Conv2d(512, dim, 1),
                                 nn.GELU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        w = int(math.sqrt(n))
        # tokens are column-major, so this grid's axes are (col, row), as the reference's
        y = self.net(x.transpose(1, 2).reshape(b, c, w, w))
        return x + y.reshape(b, c, n).transpose(1, 2)


class HybridAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, num_patches: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.hd = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), Dropout(dropout))
        self.spatial_conv = nn.Conv2d(heads, heads, 3, padding=1)
        self.to_qkv_spec = nn.Linear(num_patches, num_patches * 3, bias=False)
        self.spectral_conv = nn.Conv2d(1, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.to_qkv(x).reshape(b, n, 3, self.heads, self.hd).permute(2, 0, 3, 1, 4)
        scale = self.hd ** -0.5
        attn = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
        attn = self.spatial_conv(attn)  # 3x3 over the (n, n) map, heads as channels
        out = (attn @ v).transpose(1, 2).reshape(b, n, self.heads * self.hd)
        out = self.to_out(out)
        # spectral attention over the transposed tokens
        qs, ks, _ = self.to_qkv_spec(x.transpose(1, 2)).chunk(3, dim=-1)  # [b, dim, n] each
        a2 = torch.softmax(qs @ ks.transpose(1, 2) * scale, dim=-1)  # [b, dim, dim]
        a2 = self.spectral_conv(a2.unsqueeze(1)).squeeze(1)
        return out @ a2


class _PatchEmbed(nn.Module):
    """The depthwise patchify conv as the reference's ``to_patch_embedding.0``."""

    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.depth_conv = nn.Conv2d(dim, dim, patch, stride=patch, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.depth_conv(x)


class _Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, num_patches, dropout):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(depth):
            attn = nn.Module()
            attn.norm, attn.fn = nn.LayerNorm(dim, eps=1e-5), HybridAttention(
                dim, heads, dim_head, num_patches, dropout)
            ffn = nn.Module()
            ffn.norm, ffn.fn = nn.LayerNorm(dim, eps=1e-5), ConvFFN(dim)
            self.layers.append(nn.ModuleList([attn, ffn]))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for attn, ffn in self.layers:
            y = attn.fn(attn.norm(y)) + y
            y = ffn.fn(ffn.norm(y)) + y
        return y


class SubNet(nn.Module):
    def __init__(self, dim: int, patch: int, num_patches: int, depth: int, heads: int,
                 dim_head: int, dropout: float, emb_dropout: float):
        super().__init__()
        self.to_patch_embedding = nn.Sequential(_PatchEmbed(dim, patch))
        self.pos_embedding = nn.Parameter(torch.zeros(1, num_patches + 1, dim))
        self.dropout = Dropout(emb_dropout)
        self.transformer = _Transformer(dim, depth, heads, dim_head, num_patches, dropout)

    def init_flax(self, generator):
        nn.init.zeros_(self.pos_embedding)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        y = self.to_patch_embedding(img)  # [B, dim, S, S]
        b, d = y.shape[:2]
        # column-major token order (t = col * S + row), the reference's
        y = y.transpose(2, 3).reshape(b, d, -1).transpose(1, 2)
        y = self.dropout(y + self.pos_embedding[:, :y.shape[1]])
        return self.transformer(y)


class HybridFormer(nn.Module):
    def __init__(self, image_size: int, patch_sizes: Tuple[int, ...], num_classes: int,
                 dim: int = 100, depth: int = 2, heads: int = 4, dim_head: int = 64,
                 channels: int = 103, dropout: float = 0.2, emb_dropout: float = 0.2):
        super().__init__()
        self.ournet = OurFE(channels, channels)
        self.conv4 = nn.Conv2d(channels, dim, 1)
        subs, heads_ = [], []
        for ps in patch_sizes:
            n = (int((image_size - ps) / ps) + 1) ** 2
            subs.append(SubNet(dim, ps, n, depth, heads, dim_head, dropout, emb_dropout))
            heads_.append(nn.Sequential(nn.LayerNorm(n * dim, eps=1e-5),
                                        nn.Linear(n * dim, num_classes)))
        self.net = nn.ModuleList(subs)
        self.mlp_head = nn.ModuleList(heads_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ournet(hwc_to_chw(x))
        x = F.avg_pool2d(x, 3, stride=1, padding=1)  # zeros counted, as flax's
        x = self.conv4(x)
        res = 0.0
        wgt = 1.0 / len(self.net)  # softmax(ones)
        for sub, head in zip(self.net, self.mlp_head):
            y = sub(x)
            res = res + head(y.reshape(y.shape[0], -1)) * wgt
        return res


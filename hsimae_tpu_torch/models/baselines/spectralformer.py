"""SpectralFormer: band-wise ViT with group-wise spectral embedding (GSE)
and cross-layer adaptive fusion (CAF) skips.

Counterpart of ``hsimae_tpu/models/baselines/spectralformer.py`` with the
reference's parameter names:

* tokens are the spectral bands, token features the patch's pixels;
* GSE: a Conv1d across the band axis (kernel ``near_band``, padding
  ``near_band // 2``) projecting pixels -> dim, ``patch_to_embedding.embed``;
* cls token + learned position embedding, a depth-5 transformer;
* CAF: from layer 2 on, the input is a learned 2 -> 1 fusion, a (1, 2)
  Conv2d over the tokens as channels (``transformer.skipcat.{i-2}``), of
  the current features and those from two layers back;
* LayerNorm + linear head on the cls token (``mlp_head``).

Only the CAF mode is ported (the registry's; the JAX zoo's ``mode`` also
takes the plain ViT without the fusion).
"""

from __future__ import annotations

import torch
from torch import nn

from hsimae_tpu_torch.models.baselines.common import (
    Dropout,
    FusedAttention,
    MlpBlock,
    PreNorm,
    Residual,
    normal_,
)


class _GSE(nn.Module):
    def __init__(self, pixels: int, dim: int, near_band: int):
        super().__init__()
        self.embed = nn.Conv1d(pixels, dim, near_band, padding=near_band // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, pixels, bands] -> [B, bands, dim]
        return self.embed(x).transpose(1, 2)


class _CAFTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float, num_tokens: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                Residual(PreNorm(dim, FusedAttention(dim, heads, dim_head, dropout,
                                                     qkv_bias=False, out="to_out"))),
                Residual(PreNorm(dim, MlpBlock(dim, mlp_dim, dropout))),
            ]) for _ in range(depth)])
        self.skipcat = nn.ModuleList([nn.Conv2d(num_tokens, num_tokens, (1, 2))
                                      for _ in range(depth - 2)])

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        outputs = []
        for i, (attn, mlp) in enumerate(self.layers):
            outputs.append(z)
            if i > 1:
                pair = torch.stack([z, outputs[i - 2]], dim=-1)  # [B, n, d, 2], tokens = channels
                z = self.skipcat[i - 2](pair).squeeze(-1)
            z = mlp(attn(z))
        return z


class SpectralFormer(nn.Module):
    def __init__(self, image_size: int, near_band: int, num_bands: int, num_classes: int,
                 dim: int = 64, depth: int = 5, heads: int = 4, mlp_dim: int = 8,
                 dim_head: int = 16, dropout: float = 0.1):
        super().__init__()
        self.num_bands = num_bands
        self.patch_to_embedding = _GSE(image_size * image_size, dim, near_band)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_bands + 1, dim))
        self.dropout = Dropout(dropout)
        self.transformer = _CAFTransformer(dim, depth, heads, dim_head, mlp_dim, dropout,
                                           num_bands + 1)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=1e-5), nn.Linear(dim, num_classes))

    def init_flax(self, generator):
        normal_(self.cls_token, 1.0, generator)
        normal_(self.pos_embedding, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, bands = x.shape
        assert bands == self.num_bands
        z = self.patch_to_embedding(x.reshape(b, h * w, bands))  # tokens = bands
        z = torch.cat([self.cls_token.expand(b, -1, -1), z], dim=1) + self.pos_embedding
        z = self.transformer(self.dropout(z))
        return self.mlp_head(z[:, 0])

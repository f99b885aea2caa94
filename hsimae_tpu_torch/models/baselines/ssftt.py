"""SSFTT: 3-D + 2-D conv stem, learned tokenizer, one transformer layer.

Counterpart of ``hsimae_tpu/models/baselines/ssftt.py`` with the
reference's parameter names and layout:

* Conv3d k3D x (3,3,3) over (spectral, h, w) -> BN/ReLU;
* the (k3D, spectral-2) axes merge into channels c-major, as the reference
  merges them (channel index ``c * S + s``; the JAX zoo merges s-major and
  its converter permutes the Conv2d's input channels to match);
* Conv2d k2D x (3,3) -> BN/ReLU;
* learned tokenization: ``A = softmax((X wA)^T)`` over pixels,
  ``T = A (X wV)``, ``num_tokens`` tokens;
* cls token + learned position embedding, one transformer layer whose
  attention scales by ``dim ** -0.5`` (the reference's quirk, not the head
  width);
* a linear head on the cls token.

It takes PCA-reduced input: ``bands`` (30 in the harness) fixes the
Conv2d's input width, which the JAX zoo reads from its first input.
"""

from __future__ import annotations

import torch
from torch import nn

from hsimae_tpu_torch.models.baselines.common import (
    Dropout,
    TransformerEncoder,
    conv_bn_relu,
    hwc_to_chw,
    normal_,
    variance_scaling_,
)


class SSFTT(nn.Module):
    def __init__(self, num_classes: int, kernel_3d: int = 8, kernel_2d: int = 64,
                 num_tokens: int = 4, dim: int = 64, depth: int = 1, heads: int = 8,
                 mlp_dim: int = 8, dropout: float = 0.1, bands: int = 30):
        super().__init__()
        self.kernel_2d, self.num_tokens, self.dim = kernel_2d, num_tokens, dim
        self.conv3d_features = conv_bn_relu(nn.Conv3d(1, kernel_3d, 3), kernel_3d)
        self.conv2d_features = conv_bn_relu(
            nn.Conv2d(kernel_3d * (bands - 2), kernel_2d, 3), kernel_2d)
        self.token_wA = nn.Parameter(torch.empty(1, num_tokens, kernel_2d))
        self.token_wV = nn.Parameter(torch.empty(1, kernel_2d, dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_tokens + 1, dim))
        self.dropout = Dropout(dropout)
        self.transformer = TransformerEncoder(dim, depth, heads, mlp_dim, dim_head=dim // heads,
                                              dropout=dropout, attn_scale=dim ** -0.5)
        self.nn1 = nn.Linear(dim, num_classes)

    def init_flax(self, generator):
        # xavier_normal on the flax shapes [L, C] and [C, d]: fan_avg
        variance_scaling_(self.token_wA, (self.num_tokens + self.kernel_2d) / 2, generator=generator)
        variance_scaling_(self.token_wV, (self.kernel_2d + self.dim) / 2, generator=generator)
        nn.init.zeros_(self.cls_token)
        normal_(self.pos_embedding, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.conv3d_features(hwc_to_chw(x).unsqueeze(1))  # [B, C, s, h, w]
        _, c, s, h, w = x.shape
        x = self.conv2d_features(x.reshape(b, c * s, h, w))  # c-major merge
        x = x.flatten(2).transpose(1, 2)  # [B, hw, k2D]
        a = torch.softmax(torch.einsum("bpc,tc->btp", x, self.token_wA[0]), dim=-1)
        t = a @ (x @ self.token_wV[0])  # [B, L, dim]
        z = torch.cat([self.cls_token.expand(b, -1, -1), t], dim=1) + self.pos_embedding
        z = self.transformer(self.dropout(z))
        return self.nn1(z[:, 0])


"""RSSAN: 2-D conv residual network with spectral and spatial attention.

Counterpart of ``hsimae_tpu/models/baselines/rssan.py`` with the
reference's parameter names, for the modules the reference forward runs.
Its two quirks stay, as in the JAX zoo: ``SSA_Module`` applies ``conv1``
twice (its ``conv2`` is never called), and the top level runs ``ssa1,
ssa2, ssa1`` (``ssa3`` is never called); the dead ``conv2`` and ``ssa3``
are left out.

Spectral attention: a CBAM-style shared MLP over the average- and
max-pooled channel vectors; spatial attention: a sigmoid conv over the
[mean, max] channel maps. BatchNorm eps 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hsimae_tpu_torch.models.baselines.common import BatchNorm, hwc_to_chw


class SpectralAttention(nn.Module):
    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.SharedMLP = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(),
                                       nn.Linear(hidden, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, h, w] -> [B, C, 1, 1]
        y = self.SharedMLP(x.mean(dim=(2, 3))) + self.SharedMLP(x.amax(dim=(2, 3)))
        return torch.sigmoid(y)[:, :, None, None]


class SpatialAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, h, w] -> [B, 1, h, w]
        y = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv1(y))


class SSAModule(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.bn1 = BatchNorm(features, eps=1e-3)
        self.bn2 = BatchNorm(features, eps=1e-3)
        self.spe_attention = SpectralAttention(features, features // 8)
        self.spa_attention = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.relu(self.bn1(self.conv1(x)))
        x1 = self.bn2(self.conv1(x1))  # the reference applies conv1 twice
        x2 = self.spe_attention(x1) * x1
        x3 = self.spa_attention(x2) * x2
        return F.relu(x3 * x1 + x)


class RSSAN(nn.Module):
    def __init__(self, bands: int, num_classes: int, features: int = 32):
        super().__init__()
        self.attention1 = SpectralAttention(bands, bands // 8)
        self.attention2 = SpatialAttention()
        self.conv1 = nn.Conv2d(bands, features, 3, padding=1)
        self.bn1 = BatchNorm(features, eps=1e-3)
        self.ssa1 = SSAModule(features)
        self.ssa2 = SSAModule(features)
        self.full_connection = nn.Sequential(nn.Linear(features, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = hwc_to_chw(x)
        x = self.attention1(x) * x
        x = self.attention2(x) * x
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.ssa1(self.ssa2(self.ssa1(x)))  # ssa1, ssa2, ssa1: ssa3 is never run
        return self.full_connection(x.mean(dim=(2, 3)))

"""SSRN: spectral-then-spatial 3-D residual network.

Counterpart of ``hsimae_tpu/models/baselines/ssrn.py`` with the reference's
parameter names. The 3-D convolutions run on ``[B, C, h, w, spectral]``
(the JAX zoo's spatial order, channels first):

stage 1 (spectral): Conv3d 24x(1,1,7)/s(1,1,2) -> BN/ReLU -> 2 residual
  blocks with (1,1,7) kernels -> Conv3d 128x(1,1,k) collapsing the spectral
  axis (k = ceil((bands-6)/2)) -> BN/ReLU;
stage 2 (spatial): the 128 channels become the spectral axis of a
  Conv3d 24x(3,3,128) -> BN/ReLU -> 2 residual blocks with (3,3,1) kernels;
head: 5x5 average pool -> dropout(0.5) -> linear.

The head's width follows from the patch size, which the JAX zoo reads
from its first input and this module takes as ``patch_size`` (the
registry's 9 by default).

The residual block is conv-ReLU-BN-ReLU / conv-BN with a post-add ReLU
(the reference's double activation). BatchNorm eps 1e-3 on the stem, 1e-5
in the blocks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hsimae_tpu_torch.models.baselines.common import BatchNorm, Dropout


class Residual3D(nn.Module):
    def __init__(self, features: int, kernel: tuple, padding: tuple, eps: float = 1e-5):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv3d(features, features, kernel, padding=padding),
                                   nn.ReLU())
        self.conv2 = nn.Conv3d(features, features, kernel, padding=padding)
        self.bn1 = BatchNorm(features, eps=eps)
        self.bn2 = BatchNorm(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + x)


def _bn_relu(features: int) -> nn.Sequential:
    return nn.Sequential(BatchNorm(features, eps=1e-3), nn.ReLU())


class SSRN(nn.Module):
    def __init__(self, bands: int, num_classes: int, patch_size: int = 9):
        super().__init__()
        k3d = math.ceil((bands - 6) / 2)
        s = (bands - 7) // 2 + 1 - k3d + 1  # spectral length left after conv2
        self.conv1 = nn.Conv3d(1, 24, (1, 1, 7), stride=(1, 1, 2))
        self.batch_norm1 = _bn_relu(24)
        self.res_net1 = Residual3D(24, (1, 1, 7), (0, 0, 3))
        self.res_net2 = Residual3D(24, (1, 1, 7), (0, 0, 3))
        self.conv2 = nn.Conv3d(24, 128, (1, 1, k3d))
        self.batch_norm2 = _bn_relu(128)
        self.conv3 = nn.Conv3d(1, 24, (3, 3, s * 128))
        self.batch_norm3 = _bn_relu(24)
        self.res_net3 = Residual3D(24, (3, 3, 1), (1, 1, 0))
        self.res_net4 = Residual3D(24, (3, 3, 1), (1, 1, 0))
        pooled = (patch_size - 2) // 5
        self.full_connection = nn.Sequential(Dropout(0.5),
                                             nn.Linear(24 * pooled * pooled, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.unsqueeze(1)  # [B, 1, h, w, bands]
        x = self.batch_norm1(self.conv1(x))
        x = self.res_net2(self.res_net1(x))
        x = self.batch_norm2(self.conv2(x))
        # the 128 channels become the spectral axis (s-major, as the JAX zoo folds)
        _, c, h, w, s = x.shape
        x = x.permute(0, 2, 3, 4, 1).reshape(b, 1, h, w, s * c)
        x = self.batch_norm3(self.conv3(x))
        x = self.res_net4(self.res_net3(x))
        x = F.avg_pool3d(x, (5, 5, 1), stride=(5, 5, 1))
        x = x.permute(0, 2, 3, 4, 1).reshape(b, -1)  # channels-last flatten
        return self.full_connection(x)

"""FDSSC: fast dense spectral-spatial network (PReLU activations).

Counterpart of ``hsimae_tpu/models/baselines/fdssc.py`` in the form the
reference harness runs (``FDSSC_f``): the spectral dense block is Conv1d
over each pixel's spectrum, the spatial one Conv2d, which is what the JAX
zoo's (1,1,k) and (3,3,1) 3-D kernels compute.

* spectral dense block: Conv1d 24x7/s2, then three 12x7 convs with dense
  concatenation (24 -> 60 channels), BN+PReLU before each conv;
* transition: a k-wide conv to 200 features collapsing the spectrum
  (k = ceil((bands-6)/2)), BN(200)+PReLU, the features become the input
  channels of the spatial stage;
* spatial dense block: Conv2d 24x3x3 (valid), then three 12x3x3 convs
  with dense concatenation to 60;
* BN+PReLU, global average pool, dropout 0.5, linear.

BatchNorm eps 1e-3; PReLU with one slope (0.25 at init).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from hsimae_tpu_torch.models.baselines.common import BatchNorm, Dropout, hwc_to_chw


def _bn_prelu(features: int) -> nn.Sequential:
    return nn.Sequential(BatchNorm(features, eps=1e-3), nn.PReLU())


class FDSSC(nn.Module):
    def __init__(self, bands: int, num_classes: int):
        super().__init__()
        k3d = math.ceil((bands - 6) / 2)
        self.conv1 = nn.Conv1d(1, 24, 7, stride=2)
        self.conv2 = nn.Conv1d(24, 12, 7, padding=3)
        self.conv3 = nn.Conv1d(36, 12, 7, padding=3)
        self.conv4 = nn.Conv1d(48, 12, 7, padding=3)
        self.conv5 = nn.Conv1d(60, 200, k3d)
        self.conv6 = nn.Conv2d(200, 24, 3)
        self.conv7 = nn.Conv2d(24, 12, 3, padding=1)
        self.conv8 = nn.Conv2d(36, 12, 3, padding=1)
        self.conv9 = nn.Conv2d(48, 12, 3, padding=1)
        for i, c in enumerate((24, 36, 48, 60, 200, 24, 36, 48, 60), start=1):
            setattr(self, f"batch_norm{i}", _bn_prelu(c))
        self.full_connection = nn.Sequential(Dropout(0.5), nn.Linear(60, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, bands = x.shape
        y = x.reshape(b * h * w, 1, bands)  # each pixel's spectrum
        x1 = self.conv1(y)
        x2 = self.conv2(self.batch_norm1(x1))
        x3 = self.conv3(self.batch_norm2(torch.cat([x1, x2], 1)))
        x4 = self.conv4(self.batch_norm3(torch.cat([x1, x2, x3], 1)))
        y = self.conv5(self.batch_norm4(torch.cat([x1, x2, x3, x4], 1)))  # [Bhw, 200, 1]
        # BN(200)+PReLU before the features fold into the spatial stage's channels
        y = self.batch_norm5(y)
        y = hwc_to_chw(y.reshape(b, h, w, -1))
        x7 = self.conv6(y)
        x8 = self.conv7(self.batch_norm6(x7))
        x9 = self.conv8(self.batch_norm7(torch.cat([x7, x8], 1)))
        x10 = self.conv9(self.batch_norm8(torch.cat([x7, x8, x9], 1)))
        y = self.batch_norm9(torch.cat([x7, x8, x9, x10], 1))
        return self.full_connection(y.mean(dim=(2, 3)))

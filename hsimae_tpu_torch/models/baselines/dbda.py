"""DBDA: double-branch dense 3-D conv network with position (PAM) and
channel (CAM) attention, Mish activations.

Counterpart of ``hsimae_tpu/models/baselines/dbda.py`` with the reference's
parameter names. The 3-D convolutions run on ``[B, C, h, w, spectral]``:

* spectral branch: Conv3d 24x(1,1,7)/s(1,1,2), a 3-step dense block of
  (1,1,7) convs (24 -> 60 channels), a (1,1,k) conv collapsing the spectral
  axis (k = floor((bands-6)/2)); channel attention (CAM) gates the result;
* spatial branch: Conv3d 24x(1,1,bands) collapsing the spectrum at once,
  then a dense block of (3,3,1) convs to 60 channels; position attention
  (PAM) gates the result;
* both attentions are residual (``gamma * attn + x``, gamma 0 at init) and
  multiply their input maps;
* global average pool of each branch -> concat 120 -> dropout 0.5 -> linear.

BatchNorm eps 1e-3.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hsimae_tpu_torch.models.baselines.common import BatchNorm, Dropout


class CAM(nn.Module):
    """Channel attention from the gram matrix of the flattened maps, with
    the max-minus-energy trick."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, ...]
        flat = x.reshape(x.shape[0], x.shape[1], -1)  # [B, C, P]
        energy = flat @ flat.transpose(1, 2)  # [B, C, C]
        energy_new = energy.amax(dim=-1, keepdim=True) - energy
        out = (torch.softmax(energy_new, dim=-1) @ flat).reshape(x.shape)
        return self.gamma * out + x

    def init_flax(self, generator):
        nn.init.zeros_(self.gamma)


class PAM(nn.Module):
    """Position attention: query/key at C//8, softmax over positions."""

    def __init__(self, c: int):
        super().__init__()
        self.query_conv = nn.Conv2d(c, c // 8, 1)
        self.key_conv = nn.Conv2d(c, c // 8, 1)
        self.value_conv = nn.Conv2d(c, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, h, w]
        b, c, h, w = x.shape
        q = self.query_conv(x).reshape(b, -1, h * w).transpose(1, 2)
        k = self.key_conv(x).reshape(b, -1, h * w)
        v = self.value_conv(x).reshape(b, c, h * w)
        attn = torch.softmax(q @ k, dim=-1)  # [B, hw (queries), hw (keys)]
        out = (v @ attn.transpose(1, 2)).reshape(b, c, h, w)
        return self.gamma * out + x

    def init_flax(self, generator):
        nn.init.zeros_(self.gamma)


def _bn(features: int) -> nn.Sequential:
    return nn.Sequential(BatchNorm(features, eps=1e-3))


class DBDA(nn.Module):
    def __init__(self, bands: int, num_classes: int):
        super().__init__()
        k3d = math.floor((bands - 6) / 2)
        sp = (0, 0, 3)
        self.conv11 = nn.Conv3d(1, 24, (1, 1, 7), stride=(1, 1, 2))
        self.conv12 = nn.Conv3d(24, 12, (1, 1, 7), padding=sp)
        self.conv13 = nn.Conv3d(36, 12, (1, 1, 7), padding=sp)
        self.conv14 = nn.Conv3d(48, 12, (1, 1, 7), padding=sp)
        self.conv15 = nn.Conv3d(60, 60, (1, 1, k3d))
        for i, c in ((11, 24), (12, 36), (13, 48), (14, 60), (21, 24), (22, 36), (23, 48)):
            setattr(self, f"batch_norm{i}", _bn(c))
        self.conv21 = nn.Conv3d(1, 24, (1, 1, bands))
        self.conv22 = nn.Conv3d(24, 12, (3, 3, 1), padding=(1, 1, 0))
        self.conv23 = nn.Conv3d(36, 12, (3, 3, 1), padding=(1, 1, 0))
        self.conv24 = nn.Conv3d(48, 12, (3, 3, 1), padding=(1, 1, 0))
        self.attention_spectral = CAM()
        self.attention_spatial = PAM(60)
        self.full_connection = nn.Sequential(Dropout(0.5), nn.Linear(120, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x5 = x.unsqueeze(1)  # [B, 1, h, w, bands]

        # spectral branch (dense (1,1,7) stack)
        x11 = self.conv11(x5)
        x12 = self.conv12(F.mish(self.batch_norm11(x11)))
        x13 = self.conv13(F.mish(self.batch_norm12(torch.cat([x11, x12], 1))))
        x14 = self.conv14(F.mish(self.batch_norm13(torch.cat([x11, x12, x13], 1))))
        x15 = torch.cat([x11, x12, x13, x14], 1)  # 60 channels
        x16 = self.conv15(F.mish(self.batch_norm14(x15)))
        x1 = (self.attention_spectral(x16) * x16).mean(dim=(2, 3, 4))  # [B, 60]

        # spatial branch (dense (3,3,1) stack)
        x21 = self.conv21(x5)
        x22 = self.conv22(F.mish(self.batch_norm21(x21)))
        x23 = self.conv23(F.mish(self.batch_norm22(torch.cat([x21, x22], 1))))
        x24 = self.conv24(F.mish(self.batch_norm23(torch.cat([x21, x22, x23], 1))))
        x25 = torch.cat([x21, x22, x23, x24], 1).squeeze(4)  # [B, 60, h, w]
        x2 = (self.attention_spatial(x25) * x25).mean(dim=(2, 3))  # [B, 60]

        return self.full_connection(torch.cat([x1, x2], dim=-1))

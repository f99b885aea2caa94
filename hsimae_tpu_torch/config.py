"""Configuration dataclasses and named presets.

Port-owned copy of ``hsimae_tpu/config.py`` (``ModelConfig``, ``PRESETS``,
``preset``, ``EvalConfig``). Differences from the JAX package:

* ``compute_dtype`` is a ``torch.dtype``;
* ``use_pallas`` is renamed ``use_kernel`` and defaults to True: on the
  inference path every encoder block goes through
  :func:`hsimae_tpu_torch.ops.fused_block.fused_encoder_block`, which takes
  the plain PyTorch version only for tensors on the CPU;
* ``remat`` is not ported yet; ``EvalConfig`` has no colormap option
  (colormaps are not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the HSIMAE family (encoder + cls head; the MAE decoder
    fields are kept so presets match, the decoder itself is not ported yet).

    * ``num_heads = embed_dim // 16``, ``decoder_num_heads = decoder_dim // 8``.
    * SwiGLU hidden dim is rounded with ``multiple_of == int(mlp_ratio)``.
    * fusion ("joint") blocks exist only when ``s_depth < 12``.
    """

    img_size: int = 9
    patch_size: int = 3
    in_chans: int = 1
    bands: int = 32
    b_patch_size: int = 8

    embed_dim: int = 128
    depth: int = 12
    s_depth: int = 9
    num_heads: Optional[int] = None  # default: embed_dim // 16

    decoder_dim: int = 64
    decoder_depth: int = 8
    decoder_num_heads: Optional[int] = None  # default: decoder_dim // 8

    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    norm_pix_loss: bool = True
    trunc_init: bool = True
    drop_path: float = 0.0
    num_classes: int = 0  # 0: pretraining model (no cls head)
    # 'agg': group the latent by spatial position and concat spectral groups
    # before the mean (cls_head in = embed_dim * T); 'gap': mean over tokens
    head_mode: str = "agg"

    # params in f32, activations in `compute_dtype`
    compute_dtype: torch.dtype = torch.float32

    # run encoder blocks through the fused-block kernel on the inference
    # path (module not training); training uses the Block modules
    use_kernel: bool = True

    def __post_init__(self):
        if self.num_heads is None:
            object.__setattr__(self, "num_heads", self.embed_dim // 16)
        if self.decoder_num_heads is None:
            object.__setattr__(self, "decoder_num_heads", self.decoder_dim // 8)
        if self.img_size % self.patch_size or self.bands % self.b_patch_size:
            raise ValueError("img_size/bands must be multiples of the patch sizes")
        if self.embed_dim % self.num_heads or self.decoder_dim % self.decoder_num_heads:
            raise ValueError("dims must be multiples of their head counts")

    @property
    def t_size(self) -> int:
        """Number of spectral groups T = bands / b_patch_size."""
        return self.bands // self.b_patch_size

    @property
    def grid_size(self) -> int:
        """Spatial grid side H' = W' = img_size / patch_size."""
        return self.img_size // self.patch_size

    @property
    def l_size(self) -> int:
        """Number of spatial positions L = H' * W'."""
        return self.grid_size * self.grid_size

    @property
    def num_patches(self) -> int:
        return self.t_size * self.l_size

    @property
    def pixels_per_patch(self) -> int:
        return self.b_patch_size * self.patch_size**2 * self.in_chans

    @property
    def fusion_depth(self) -> int:
        """Number of joint ('fusion') blocks; 0 when s_depth >= 12."""
        return self.depth - self.s_depth if self.s_depth < 12 else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# [depth, dim, s_depth] = [12, 128, 9] for Base and [12, 256, 9] for Large;
# decoder [depth, dim] = [8, 64].
PRESETS = {
    "HSIMAE-S": ModelConfig(embed_dim=64, depth=12, s_depth=6, decoder_dim=48, decoder_depth=2),
    "HSIMAE-B": ModelConfig(embed_dim=128, depth=12, s_depth=9, decoder_dim=64, decoder_depth=8),
    "HSIMAE-L": ModelConfig(embed_dim=256, depth=12, s_depth=9, decoder_dim=64, decoder_depth=8),
}


def preset(name: str, **overrides) -> ModelConfig:
    return PRESETS[name].replace(**overrides)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Full-scene inference."""

    batch_size: int = 4096  # patches gathered on the device per batch

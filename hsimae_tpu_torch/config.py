"""Configuration dataclasses and named presets.

Port-owned copy of ``hsimae_tpu/config.py`` (``ModelConfig``, ``PRESETS``,
``preset``, ``PretrainConfig``, ``FinetuneConfig``, ``EvalConfig``,
``ProtocolConfig``, ``MeshConfig``). Differences from the JAX package:

* ``compute_dtype`` is a ``torch.dtype``;
* ``use_pallas`` is renamed ``use_kernel`` and defaults to True: on the
  inference path every encoder block goes through
  :func:`hsimae_tpu_torch.ops.fused_block.fused_encoder_block`, which takes
  the plain PyTorch version only for tensors on the CPU;
* ``PretrainConfig`` has no ``fused_steps`` (the TPU ``lax.scan`` dispatch
  path); ``checkpoint_backend`` keeps the JAX names, so a JAX command line
  carries over, but no orbax is used: ``"msgpack"`` is the port's
  synchronous ``ckpt_{step}.pt`` files, ``"orbax"`` the background writer
  with retention of :mod:`hsimae_tpu_torch.checkpoints.async_io`;
  ``adam_mu_dtype`` stays a string.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the HSIMAE family (encoder + MAE decoder + cls head).

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

    # recompute every Block in the backward pass (torch.utils.checkpoint):
    # only block inputs are saved; outputs and gradients are unchanged
    remat: bool = False

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
class PretrainConfig:
    """MAE pretraining hyperparameters (the JAX package's defaults)."""

    mask_ratio: float = 0.5
    lr: float = 5e-3
    weight_decay: float = 5e-2
    batch_size: int = 512
    epochs: int = 100
    warmup_frac: float = 0.05  # fraction of all steps
    lr_min: float = 1e-6
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    # storage dtype of Adam's first moment ("bfloat16"; None = float32); the
    # update math runs in float32 and the second moment stays float32
    adam_mu_dtype: Optional[str] = None
    seed: int = 42
    log_every: int = 50
    checkpoint_every_steps: int = 0  # 0 = only the final parameters
    # "msgpack": synchronous ckpt_{step}.pt files (checkpoints/io.py), all
    # kept; "orbax": the background writer with retention
    # (checkpoints/async_io.py; the JAX package's name, no orbax used)
    checkpoint_backend: str = "msgpack"
    # checkpoints the "orbax" backend keeps on disk (None = keep all)
    ckpt_max_to_keep: Optional[int] = 3


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """Dual-branch fine-tuning hyperparameters (the JAX package's defaults)."""

    mask_ratio: float = 0.8
    lamda: float = 10.0  # loss = lamda * rec + ce
    lr: float = 1e-3
    weight_decay: float = 5e-3
    batch_size: int = 32
    epochs: int = 200
    warmup_frac: float = 0.1  # of epochs; the schedule steps once an epoch
    drop_path: float = 0.2
    train_ratio: float = 0.5  # labeled pool split into train and val
    val_batch_size: int = 512
    seed: int = 3407
    # learning-rate multiplier of every parameter outside cls_head: 1.0 is
    # the reference's uniform rate, 0.0 freezes the encoder
    encoder_lr_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Full-scene inference."""

    batch_size: int = 4096  # patches gathered on the device per batch
    save_colormaps: bool = True


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """The multi-seed protocol: an lr grid scored over the first
    ``selection_seeds`` seeds, then the best lr over the first ``test_seeds``."""

    seeds: Tuple[int, ...] = (3407, 3408, 3409, 3410, 3411)
    selection_seeds: int = 3
    test_seeds: int = 5
    lr_grid: Tuple[float, ...] = (5e-3, 1e-3, 5e-4, 1e-4)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Layout of the (data, model) mesh over the ranks of the process group
    (:func:`hsimae_tpu_torch.parallel.make_mesh`)."""

    data: int = -1  # -1: the ranks the model axis leaves
    model: int = 1  # tensor-parallel axis (attention heads, SwiGLU hidden)

from hsimae_tpu_torch.models.hsimae import (
    HSIMAE,
    build_hsimae,
    build_dual_vit,
    build_hsi_vit,
    patchify,
    unpatchify,
    mae_loss,
    reconstruct,
)
from hsimae_tpu_torch.models.layers import Attention, Block, PatchEmbed, SwiGLU, swiglu_hidden_dim
from hsimae_tpu_torch.models.masking import (
    choose_grid_shape,
    grid_shape_candidates,
    spatial_spectral_mask,
    gather_tokens,
    scatter_tokens,
)
from hsimae_tpu_torch.models.pos_embed import sincos_1d, sincos_2d, sincos_3d

__all__ = [
    "HSIMAE",
    "build_hsimae",
    "build_dual_vit",
    "build_hsi_vit",
    "patchify",
    "unpatchify",
    "mae_loss",
    "reconstruct",
    "Attention",
    "Block",
    "PatchEmbed",
    "SwiGLU",
    "swiglu_hidden_dim",
    "choose_grid_shape",
    "grid_shape_candidates",
    "spatial_spectral_mask",
    "gather_tokens",
    "scatter_tokens",
    "sincos_1d",
    "sincos_2d",
    "sincos_3d",
]

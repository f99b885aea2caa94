"""The HSIMAE encoder and classification head as one ``nn.Module``.

Counterpart of ``hsimae_tpu/models/hsimae.py`` for the inference model
(``build_hsi_vit``: encoder + cls head). The MAE decoder, masking and the
pretrain/dual forwards are not ported yet.

Input layout: ``[N, img, img, bands]`` channels-last; latents ``[N, T*L, C]``.
Parameter names follow the reference ``state_dict`` (``blocks_1.3.attn.q.weight``),
and ``pos_embed`` is a ``[1, T*L, C]`` buffer, so a state dict exported from
the JAX package loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hsimae_tpu_torch.config import ModelConfig
from hsimae_tpu_torch.models.layers import Block, LayerNorm, Linear, PatchEmbed, init_block_, init_trunc_normal
from hsimae_tpu_torch.models.pos_embed import sincos_3d
from hsimae_tpu_torch.ops.fused_block import fused_encoder_block, kernel_weights, params_from_block

CLS_HEAD_NAME = "cls_head"


class HSIMAE(nn.Module):
    """Separable spatial/spectral encoder with an optional classification head."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = PatchEmbed(c.embed_dim, c.patch_size, c.b_patch_size, c.compute_dtype)
        self.register_buffer("pos_embed", torch.empty(1, c.num_patches, c.embed_dim))

        def blocks(n):
            return nn.ModuleList(
                Block(c.embed_dim, c.num_heads, c.mlp_ratio, c.qkv_bias, c.compute_dtype)
                for _ in range(n))

        self.blocks_1 = blocks(c.s_depth)
        self.blocks_2 = blocks(c.s_depth)
        # fusion blocks exist only for s_depth < 12 (reference quirk)
        self.blocks = blocks(c.fusion_depth)
        self.norm = LayerNorm(c.embed_dim)
        # (block-list name, dtype) -> (weights' addresses and versions, kernel weights, weights)
        self._kernel_params: dict = {}
        if c.num_classes > 0:
            head_in = c.embed_dim * c.t_size if c.head_mode == "agg" else c.embed_dim
            self.cls_head = Linear(head_in, c.num_classes, True, torch.float32)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init of every parameter and of the sincos table."""
        c = self.cfg
        proj = self.patch_embed.proj.weight  # [C, 1, u, p, p]
        if c.trunc_init:  # reference quirk: the patch projection draws with std 1
            init_trunc_normal(proj, 1.0, generator)
        else:  # xavier over the Dense kernel's fans (u*p*p in, C out), as JAX draws it
            nn.init.xavier_uniform_(proj.view(proj.shape[0], -1), generator=generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        for blk in (*self.blocks_1, *self.blocks_2, *self.blocks):
            init_block_(blk, generator, c.trunc_init)
        nn.init.ones_(self.norm.weight)
        nn.init.zeros_(self.norm.bias)
        if c.num_classes > 0:
            self.cls_head.reset_parameters_from(generator, c.trunc_init)
        pos = sincos_3d(c.embed_dim, c.t_size, c.grid_size)
        self.pos_embed.copy_(torch.from_numpy(pos)[None])

    # ----------------------------- encoder --------------------------------

    def kernel_params(self, name: str) -> list:
        """The weights of block list ``name`` laid out for the kernel of the
        stream dtype ``cfg.compute_dtype`` (:func:`kernel_weights`): a
        :class:`Tf32Pack` (TF32 hi and lo tiles) for float32 at D 64 and 128,
        :class:`BlockParams` for float32 at D 256, a :class:`BlockPack` (bf16
        tiles) for bfloat16. Built once (the entry is keyed by dtype) and
        rebuilt only after a weight is replaced (``.to``,
        ``load_state_dict``) or changed in place (its version counter)."""
        dtype = self.cfg.compute_dtype
        blocks = getattr(self, name)
        weights = list(blocks.parameters())
        key = [(t.data_ptr(), t._version) for t in weights]
        hit = self._kernel_params.get((name, dtype))
        if hit is None or hit[0] != key:
            # plain tensors even when called under inference_mode; the entry
            # keeps the weights it was built from alive, so no new weight can
            # take one of their addresses while it stands
            with torch.inference_mode(False), torch.no_grad():
                params = [kernel_weights(params_from_block(b), dtype) for b in blocks]
                hit = (key, params, [t.detach() for t in weights])
            self._kernel_params[(name, dtype)] = hit
        return hit[1]

    def _run_blocks(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Apply the Blocks of list ``name``; on the inference path with
        ``cfg.use_kernel`` every block goes through the fused-block kernel."""
        if self.cfg.use_kernel and not self.training:
            # cast ONCE on entry: the kernel computes in the stream dtype, so
            # with compute_dtype=bf16 the residual stream is rounded to bf16
            # where the Block modules keep it f32 (as in the JAX package)
            x = x.to(self.cfg.compute_dtype).contiguous()
            for p in self.kernel_params(name):
                x = fused_encoder_block(x, p, self.cfg.num_heads)
            return x
        for blk in getattr(self, name):
            x = blk(x)
        return x

    def _encode_grid(self, x: torch.Tensor, t: int, l: int) -> torch.Tensor:
        """Run separable + fusion blocks over a dense [N, t, l, C] token grid."""
        c = self.cfg
        n, dim = x.shape[0], x.shape[-1]
        if c.s_depth > 0:
            x1 = self._run_blocks("blocks_1", x.reshape(n * t, l, dim))
            x2 = self._run_blocks("blocks_2", x.transpose(1, 2).reshape(n * l, t, dim))
            x = x1.reshape(n, t, l, dim) + x2.reshape(n, l, t, dim).transpose(1, 2)
        x = self._run_blocks("blocks", x.reshape(n, t * l, dim))
        return self.norm(x)

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        """Unmasked encoding -> [N, T*L, C]."""
        c = self.cfg
        tokens = self.patch_embed(imgs)  # [N, T, L, C]
        pos = self.pos_embed.reshape(1, c.t_size, c.l_size, c.embed_dim)
        x = tokens + pos.to(tokens.dtype)
        return self._encode_grid(x, c.t_size, c.l_size)

    # ------------------------------- heads --------------------------------

    def classify(self, imgs: torch.Tensor) -> torch.Tensor:
        """'agg': group the latent by spatial position, concat spectral
        groups, mean over positions; 'gap': plain mean over all tokens."""
        c = self.cfg
        latent = self.encode(imgs)
        n = latent.shape[0]
        if c.head_mode == "gap":
            x = latent.reshape(n, c.num_patches, c.embed_dim).mean(dim=1)
        else:
            x = latent.reshape(n, c.t_size, c.l_size, c.embed_dim)
            x = x.transpose(1, 2).reshape(n, c.l_size, c.t_size * c.embed_dim).mean(dim=1)
        return self.cls_head(x.float())

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.classify(imgs)


def build_hsi_vit(cfg: ModelConfig, num_classes: int, seed: int = 0,
                  device: str | torch.device = "cuda",
                  state_dict: Optional[dict] = None) -> HSIMAE:
    """Inference model (encoder + cls head), in eval mode on ``device``.

    Weights come from ``state_dict`` (strict) when given, else from a seeded
    init drawn on the CPU (the same weights whatever the device). The modules
    are built on the meta device, so no draw touches torch's global RNG."""
    with torch.device("meta"):
        model = HSIMAE(cfg.replace(num_classes=num_classes, drop_path=0.0))
    model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()

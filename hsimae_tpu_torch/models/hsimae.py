"""The HSIMAE model family as one ``nn.Module``: the separable
spatial/spectral encoder, the MAE decoder and the classification head.

Counterpart of ``hsimae_tpu/models/hsimae.py`` for its three models: the
pretraining model (``build_hsimae``: encoder + decoder + pixel loss), the
fine-tuning model (``build_dual_vit``: encoder + decoder + cls head, with the
dual forward ``forward_dual``) and the inference model (``build_hsi_vit``:
encoder + cls head).

Input layout: ``[N, img, img, bands]`` channels-last; latents ``[N, T*L, C]``.
Parameter names follow the reference ``state_dict`` (``blocks_1.3.attn.q.weight``),
and ``pos_embed``, ``decoder_pos_embed`` and the unused zero ``mask_token``
are buffers, so a state dict exported from the JAX package loads with
``load_state_dict(strict=True)``.

Every random draw of a forward can be injected: the kept grid
(:class:`GridMask`) and the drop-path keep masks. Draws not given come from
the ``generator`` argument. On the inference path (module not training, with
``cfg.use_kernel``) the encoder blocks run the fused-block kernel; training
and the decoder always run the Block modules.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hsimae_tpu_torch.config import ModelConfig
from hsimae_tpu_torch.models.layers import (
    Block,
    LayerNorm,
    Linear,
    PatchEmbed,
    draw_keep,
    init_block_,
    init_trunc_normal,
)
from hsimae_tpu_torch.models.masking import GridMask, scatter_tokens, spatial_spectral_mask
from hsimae_tpu_torch.models.pos_embed import sincos_3d
from hsimae_tpu_torch.ops.fused_block import (
    fused_block_op,
    fused_encoder_block,
    kernel_weights,
    params_from_block,
)

# per block stack, the drop-path keep masks of each block: (attention, MLP),
# or None for a block whose rate is 0
DropKeep = Dict[str, List[Optional[Tuple[torch.Tensor, torch.Tensor]]]]
ENCODER_STACKS = ("blocks_1", "blocks_2", "blocks")

CLS_HEAD_NAME = "cls_head"


def patchify(imgs: torch.Tensor, p: int, u: int) -> torch.Tensor:
    """[N, H, W, bands] -> [N, t*h*w, u*p*p] pixel targets, tokens in (t, h, w)
    order and features in (u, p_row, p_col) order, as PatchEmbed reads them."""
    n, hh, ww, bands = imgs.shape
    h, w, t = hh // p, ww // p, bands // u
    x = imgs.reshape(n, h, p, w, p, t, u).permute(0, 5, 1, 3, 6, 2, 4)
    return x.reshape(n, t * h * w, u * p * p)


def unpatchify(x: torch.Tensor, p: int, u: int, grid: int, t: int) -> torch.Tensor:
    """Inverse of :func:`patchify` -> [N, H, W, bands]."""
    n = x.shape[0]
    x = x.reshape(n, t, grid, grid, u, p, p).permute(0, 2, 5, 3, 6, 1, 4)
    return x.reshape(n, grid * p, grid * p, t * u)


def mae_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             norm_pix: bool = True, sample_weight: Optional[torch.Tensor] = None,
             denom: Optional[torch.Tensor] = None):
    """Masked-token MSE in float32 -> (loss, mean, std). With ``norm_pix``
    each target token is standardised by its own mean and unbiased variance
    (``sqrt(var + 1e-6)``). The token losses are weighted by ``mask`` (times
    ``sample_weight`` per sample) over ``max(sum of weights, 1)``, or over
    ``max(denom, 1)`` when given: a data-parallel rank divides its share by
    the global batch's sum of weights."""
    pred, target = pred.float(), target.float()
    if norm_pix:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=1)
        std = torch.sqrt(var + 1.0e-6)
        target = (target - mean) / std
    else:
        mean = torch.zeros_like(target[..., :1])
        std = torch.ones_like(target[..., :1])
    tok = ((pred - target) ** 2).mean(dim=-1)  # [N, S]
    w = mask if sample_weight is None else mask * sample_weight[:, None]
    total = w.sum() if denom is None else denom
    return (tok * w).sum() / total.clamp(min=1.0), mean, std


class HSIMAE(nn.Module):
    """Separable spatial/spectral encoder, with the MAE decoder when
    ``with_decoder`` and a classification head when ``cfg.num_classes > 0``."""

    def __init__(self, cfg: ModelConfig, with_decoder: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.with_decoder = with_decoder
        self.patch_embed = PatchEmbed(c.embed_dim, c.patch_size, c.b_patch_size, c.compute_dtype)
        self.register_buffer("pos_embed", torch.empty(1, c.num_patches, c.embed_dim))
        dpr = np.linspace(0.0, c.drop_path, c.depth)

        def blocks(dim, heads, rates):
            return nn.ModuleList(
                Block(dim, heads, c.mlp_ratio, c.qkv_bias, c.compute_dtype, float(r))
                for r in rates)

        # block i of blocks_1 and of blocks_2 share rate i; the fusion blocks
        # (only for s_depth < 12, a reference quirk) take [s_depth, depth)
        self.blocks_1 = blocks(c.embed_dim, c.num_heads, dpr[:c.s_depth])
        self.blocks_2 = blocks(c.embed_dim, c.num_heads, dpr[:c.s_depth])
        self.blocks = blocks(c.embed_dim, c.num_heads, dpr[c.s_depth:c.s_depth + c.fusion_depth])
        self.norm = LayerNorm(c.embed_dim)
        # (block-list name, dtype) -> (weights' addresses and versions, kernel weights, weights)
        self._kernel_params: dict = {}
        # block-list name -> [(route, tensors)] while given_kernel_weights holds
        self._given_kernel_weights: Optional[dict] = None
        if with_decoder:
            self.decoder_embed = Linear(c.embed_dim, c.decoder_dim, True, c.compute_dtype)
            self.decoder_blocks = blocks(c.decoder_dim, c.decoder_num_heads,
                                         [0.0] * c.decoder_depth)
            self.decoder_norm = LayerNorm(c.decoder_dim)
            self.decoder_pred = Linear(c.decoder_dim, c.pixels_per_patch, True, c.compute_dtype)
            self.register_buffer("decoder_pos_embed",
                                 torch.empty(1, c.num_patches, c.decoder_dim))
            # the reference's learned mask token is never used (the decoder
            # fills with the mean token); kept as a zero buffer so exported
            # state dicts load strictly
            self.register_buffer("mask_token", torch.empty(1, 1, c.decoder_dim))
        if c.num_classes > 0:
            head_in = c.embed_dim * c.t_size if c.head_mode == "agg" else c.embed_dim
            self.cls_head = Linear(head_in, c.num_classes, True, torch.float32)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init of every parameter and of the sincos tables."""
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
        self.pos_embed.copy_(torch.from_numpy(sincos_3d(c.embed_dim, c.t_size, c.grid_size))[None])
        if self.with_decoder:
            self.decoder_embed.reset_parameters_from(generator, c.trunc_init)
            for blk in self.decoder_blocks:
                init_block_(blk, generator, c.trunc_init)
            nn.init.ones_(self.decoder_norm.weight)
            nn.init.zeros_(self.decoder_norm.bias)
            self.decoder_pred.reset_parameters_from(generator, c.trunc_init)
            pos = sincos_3d(c.decoder_dim, c.t_size, c.grid_size)
            self.decoder_pos_embed.copy_(torch.from_numpy(pos)[None])
            self.mask_token.zero_()
        if c.num_classes > 0:
            self.cls_head.reset_parameters_from(generator, c.trunc_init)

    # ----------------------------- encoder --------------------------------

    def kernel_params(self, name: str) -> list:
        """The weights of block list ``name`` laid out for the kernel of the
        stream dtype ``cfg.compute_dtype`` (:func:`kernel_weights`): a
        :class:`Tf32Pack` (TF32 hi and lo tiles) for float32 at D 64 and 128,
        :class:`BlockParams` for float32 at D 256, a :class:`BlockPack` (bf16
        tiles) for bfloat16. Built once (the entry is keyed by dtype) and
        rebuilt only after a weight is replaced (``.to``,
        ``load_state_dict``) or changed in place (its version counter, which
        an optimizer step bumps)."""
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

    @contextlib.contextmanager
    def given_kernel_weights(self, weights: dict):
        """Within this context the encoder stacks on the kernel path take
        their weights from ``weights``, block-list name -> one
        :func:`pack_tensors` pair ``(route, tensors)`` a block, and run each
        block through the registered op ``torch.ops.hsimae.fused_block``
        in place of :meth:`kernel_params` and the ctypes wrapper: the
        serving export traces the model so, with the weights as the
        program's inputs."""
        self._given_kernel_weights = weights
        try:
            yield self
        finally:
            self._given_kernel_weights = None

    def _run_blocks(self, name: str, x: torch.Tensor,
                    keep: Optional[list] = None) -> torch.Tensor:
        """Apply the Blocks of list ``name``. On the inference path with
        ``cfg.use_kernel`` every block goes through the fused-block kernel;
        otherwise the Block modules run, with ``keep[i]`` as block ``i``'s
        drop-path masks and, in training with ``cfg.remat``, each block
        recomputed in the backward pass."""
        if self.cfg.use_kernel and not self.training and name in ENCODER_STACKS:
            # cast ONCE on entry: the kernel computes in the stream dtype, so
            # with compute_dtype=bf16 the residual stream is rounded to bf16
            # where the Block modules keep it f32 (as in the JAX package)
            x = x.to(self.cfg.compute_dtype).contiguous()
            if self._given_kernel_weights is not None:
                for route, tensors in self._given_kernel_weights[name]:
                    x = fused_block_op(x, tensors, route, self.cfg.num_heads)
                return x
            for p in self.kernel_params(name):
                x = fused_encoder_block(x, p, self.cfg.num_heads)
            return x
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        for i, blk in enumerate(getattr(self, name)):
            k = keep[i] if keep is not None else None
            x = checkpoint(blk, x, k, use_reentrant=False) if remat else blk(x, k)
        return x

    def _encode_grid(self, x: torch.Tensor, t: int, l: int,
                     drop_keep: Optional[DropKeep] = None) -> torch.Tensor:
        """Run separable + fusion blocks over a dense [N, t, l, C] token grid."""
        c = self.cfg
        n, dim = x.shape[0], x.shape[-1]
        keep = drop_keep or {}
        if c.s_depth > 0:
            x1 = self._run_blocks("blocks_1", x.reshape(n * t, l, dim), keep.get("blocks_1"))
            x2 = self._run_blocks("blocks_2", x.transpose(1, 2).reshape(n * l, t, dim),
                                  keep.get("blocks_2"))
            x = x1.reshape(n, t, l, dim) + x2.reshape(n, l, t, dim).transpose(1, 2)
        x = self._run_blocks("blocks", x.reshape(n, t * l, dim), keep.get("blocks"))
        return self.norm(x)

    def _drop_keep(self, drop_keep: Optional[DropKeep], n: int, len_t: int, len_l: int,
                   generator: Optional[torch.Generator], device) -> Optional[DropKeep]:
        """The drop-path keep masks a forward runs with: none out of
        training, else ``drop_keep``, else (with drop-path) a draw."""
        if not self.training:
            return None
        if drop_keep is None and self.cfg.drop_path > 0.0:
            return self.draw_drop_keep(n, len_t, len_l, generator, device)
        return drop_keep

    def encode(self, imgs: torch.Tensor, drop_keep: Optional[DropKeep] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Unmasked encoding -> [N, T*L, C]. In training, ``drop_keep`` (rows
        ``N*T``, ``N*L`` and ``N``) is drawn from ``generator`` when not
        given."""
        c = self.cfg
        tokens = self.patch_embed(imgs)  # [N, T, L, C]
        pos = self.pos_embed.reshape(1, c.t_size, c.l_size, c.embed_dim)
        x = tokens + pos.to(tokens.dtype)
        drop_keep = self._drop_keep(drop_keep, imgs.shape[0], c.t_size, c.l_size, generator,
                                    imgs.device)
        return self._encode_grid(x, c.t_size, c.l_size, drop_keep)

    def draw_drop_keep(self, n: int, len_t: int, len_l: int,
                       generator: Optional[torch.Generator] = None,
                       device: str | torch.device = "cuda") -> DropKeep:
        """Drop-path keep masks for a masked forward of ``n`` samples: per
        encoder stack, per block (attention then MLP), one bool per sequence
        the stack runs (``n*len_t``, ``n*len_l`` and ``n``), drawn in stack
        and block order; None for blocks of rate 0."""
        rows = {"blocks_1": n * len_t, "blocks_2": n * len_l, "blocks": n}
        out: DropKeep = {}
        for name in ENCODER_STACKS:
            out[name] = [
                (draw_keep(rows[name], blk.drop_path_rate, generator, device),
                 draw_keep(rows[name], blk.drop_path_rate, generator, device))
                if blk.drop_path_rate > 0.0 else None
                for blk in getattr(self, name)]
        return out

    def encode_masked(self, imgs: torch.Tensor, len_t: int, len_l: int,
                      grid: Optional[GridMask] = None, drop_keep: Optional[DropKeep] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, GridMask]:
        """Masked encoding of the kept grid -> (latent [N, len_t*len_l, C],
        the grid). Pos is added BEFORE the row and column gathers, so the
        table rides along. ``grid`` and, in training, ``drop_keep`` are drawn
        from ``generator`` when not given."""
        c = self.cfg
        n = imgs.shape[0]
        tokens = self.patch_embed(imgs)  # [N, T, L, C]
        if grid is None:
            grid = spatial_spectral_mask(n, c.t_size, c.l_size, len_t, len_l, generator,
                                         imgs.device)
        drop_keep = self._drop_keep(drop_keep, n, len_t, len_l, generator, imgs.device)
        x = tokens + self.pos_embed.reshape(1, c.t_size, c.l_size, c.embed_dim).to(tokens.dtype)
        dim = x.shape[-1]
        x = torch.gather(x, 1, grid.ids_t[:, :, None, None].expand(-1, -1, c.l_size, dim))
        x = torch.gather(x, 2, grid.ids_l[:, None, :, None].expand(-1, len_t, -1, dim))
        return self._encode_grid(x, len_t, len_l, drop_keep), grid

    # ----------------------------- decoder --------------------------------

    def decode(self, latent: torch.Tensor, ids_keep: torch.Tensor) -> torch.Tensor:
        """MAE decoder: project, scatter the kept tokens among copies of
        their mean token, add pos, run the blocks (always the Block modules:
        head dim 8), predict pixels -> [N, T*L, u*p*p]."""
        c = self.cfg
        x = self.decoder_embed(latent)
        # the mean accumulates in f32 whatever the stream dtype, as XLA does
        mask_token = x.float().mean(dim=1, keepdim=True).to(x.dtype)
        full = scatter_tokens(x, ids_keep, c.num_patches, mask_token)
        full = full + self.decoder_pos_embed.to(full.dtype)
        full = self._run_blocks("decoder_blocks", full)
        return self.decoder_pred(self.decoder_norm(full).to(x.dtype))

    # ------------------------------- heads --------------------------------

    def classify(self, imgs: torch.Tensor, drop_keep: Optional[DropKeep] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """'agg': group the latent by spatial position, concat spectral
        groups, mean over positions; 'gap': plain mean over all tokens.
        ``drop_keep`` / ``generator`` as :meth:`encode` takes them."""
        c = self.cfg
        latent = self.encode(imgs, drop_keep, generator)
        n = latent.shape[0]
        if c.head_mode == "gap":
            x = latent.reshape(n, c.num_patches, c.embed_dim).mean(dim=1)
        else:
            x = latent.reshape(n, c.t_size, c.l_size, c.embed_dim)
            x = x.transpose(1, 2).reshape(n, c.l_size, c.t_size * c.embed_dim).mean(dim=1)
        return self.cls_head(x.float())

    # ----------------------------- forwards -------------------------------

    def forward_pretrain(self, imgs: torch.Tensor, len_t: int, len_l: int,
                         sample_weight: Optional[torch.Tensor] = None,
                         grid: Optional[GridMask] = None, drop_keep: Optional[DropKeep] = None,
                         generator: Optional[torch.Generator] = None,
                         loss_denom: Optional[torch.Tensor] = None):
        """(loss, pred, mask, (mean, std)) of the masked autoencoder; the
        un-normalised image is :func:`reconstruct`'s. ``loss_denom``: the
        loss's sum of weights, when not this batch's (:func:`mae_loss`)."""
        c = self.cfg
        latent, grid = self.encode_masked(imgs, len_t, len_l, grid, drop_keep, generator)
        pred = self.decode(latent, grid.ids_keep)
        target = patchify(imgs, c.patch_size, c.b_patch_size)
        loss, mean, std = mae_loss(pred, target, grid.mask, c.norm_pix_loss, sample_weight,
                                   loss_denom)
        return loss, pred, grid.mask, (mean, std)

    def forward_dual(self, imgs: torch.Tensor, imgs_u: torch.Tensor, len_t: int, len_l: int,
                     sample_weight: Optional[torch.Tensor] = None,
                     grid: Optional[GridMask] = None,
                     drop_keep_cls: Optional[DropKeep] = None,
                     drop_keep_rec: Optional[DropKeep] = None,
                     generator: Optional[torch.Generator] = None,
                     loss_denom: Optional[torch.Tensor] = None):
        """(loss_rec, logits) of dual-branch fine-tuning: the unmasked
        classification of the labeled batch ``imgs [n, ...]``, then the MAE
        loss over labeled and unlabeled, ``cat(imgs, imgs_u)`` of ``n + n_u``
        samples. ``sample_weight [n]`` weighs the labeled rows in the MAE
        loss (0 for padding), the unlabeled rows weigh 1. ``grid`` (over
        ``n + n_u``) and, in training, the drop-path masks of the two encodes
        (``drop_keep_cls`` for the classification, ``drop_keep_rec`` for the
        masked encode) are drawn from ``generator`` when not given, in call
        order: the classification's masks, the grid, the masked encode's.
        ``loss_denom`` as :meth:`forward_pretrain` takes it."""
        c = self.cfg
        logits = self.classify(imgs, drop_keep_cls, generator)
        imgs_all = torch.cat([imgs, imgs_u], dim=0)
        latent, grid = self.encode_masked(imgs_all, len_t, len_l, grid, drop_keep_rec, generator)
        pred = self.decode(latent, grid.ids_keep)
        target = patchify(imgs_all, c.patch_size, c.b_patch_size)
        w = None
        if sample_weight is not None:
            w = torch.cat([sample_weight, sample_weight.new_ones(imgs_u.shape[0])])
        loss_rec = mae_loss(pred, target, grid.mask, c.norm_pix_loss, w, loss_denom)[0]
        return loss_rec, logits

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.classify(imgs)


def reconstruct(pred: torch.Tensor, mask: torch.Tensor, mean, std, cfg: ModelConfig):
    """Un-normalise the predictions and unpatchify them and the mask to
    image space -> (imgs, mask), each [N, H, W, bands]."""
    pred = pred * std + mean
    imgs = unpatchify(pred, cfg.patch_size, cfg.b_patch_size, cfg.grid_size, cfg.t_size)
    m = mask[..., None].repeat_interleave(cfg.pixels_per_patch, dim=-1)
    m = unpatchify(m, cfg.patch_size, cfg.b_patch_size, cfg.grid_size, cfg.t_size)
    return imgs, m


def _build(cfg: ModelConfig, with_decoder: bool, seed: int, device,
           state_dict: Optional[dict]) -> HSIMAE:
    """Build on the meta device (no draw touches torch's global RNG), init
    from ``seed`` on the CPU (the same weights whatever the device), load
    ``state_dict`` strictly when given, move to ``device``."""
    with torch.device("meta"):
        model = HSIMAE(cfg, with_decoder=with_decoder)
    model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device)


def build_hsimae(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda",
                 state_dict: Optional[dict] = None) -> HSIMAE:
    """Pretraining model (encoder + decoder, no head), in training mode."""
    return _build(cfg.replace(num_classes=0), True, seed, device, state_dict)


def build_dual_vit(cfg: ModelConfig, num_classes: int, drop_path: float = 0.2, seed: int = 0,
                   device: str | torch.device = "cuda",
                   state_dict: Optional[dict] = None) -> HSIMAE:
    """Fine-tuning model (encoder + decoder + cls head), in training mode."""
    return _build(cfg.replace(num_classes=num_classes, drop_path=drop_path), True, seed,
                  device, state_dict)


def build_hsi_vit(cfg: ModelConfig, num_classes: int, seed: int = 0,
                  device: str | torch.device = "cuda",
                  state_dict: Optional[dict] = None) -> HSIMAE:
    """Inference model (encoder + cls head), in eval mode on ``device``.

    Weights come from ``state_dict`` (strict) when given, else from a seeded
    init."""
    return _build(cfg.replace(num_classes=num_classes, drop_path=0.0), False, seed, device,
                  state_dict).eval()

"""Transformer primitives as ``nn.Module``s.

Counterparts of ``hsimae_tpu/models/layers.py``. Parameter names and shapes
follow the reference ``state_dict`` (``proj.weight [C, 1, u, p, p]``,
``attn.q.weight [out, in]``, ``norm1.weight``), so weights exported from the
JAX package load with ``load_state_dict(strict=True)``.

Numerics follow the JAX modules: linear layers compute in the configured
compute dtype, LayerNorm (eps 1e-5) and softmax in float32. Drop-path takes
its per-sample keep masks as arguments, so a caller can inject the draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def swiglu_hidden_dim(dim: int, mlp_ratio: float = 4.0) -> int:
    """hidden = multiple_of * ceil(2 * (dim * ratio) / 3 / multiple_of) with
    multiple_of == int(mlp_ratio) (172, 344, 684 for dims 64, 128, 256)."""
    hidden = int(dim * mlp_ratio)
    multiple_of = int(mlp_ratio)
    return int(multiple_of * ((2 * hidden // 3 + multiple_of - 1) // multiple_of))


def init_trunc_normal(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Normal(0, std) truncated at +-2 std."""
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (params stay float32), like a
    flax ``Dense(dtype=...)``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def reset_parameters_from(self, generator: torch.Generator, trunc: bool = True,
                              std: float = 0.02) -> None:
        if trunc:
            init_trunc_normal(self.weight, std, generator)
        else:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 (eps 1e-5); the output is float32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class PatchEmbed(nn.Module):
    """[N, H, W, bands] -> [N, T, L, C] token grid.

    A Conv3d whose kernel equals its stride is a tokenizing reshape plus one
    matmul; token features are the patch pixels in (b_patch, p_row, p_col)
    order, which is the Conv3d weight layout ``[C, 1, b_patch, p, p]``.
    """

    def __init__(self, embed_dim: int, patch_size: int, b_patch_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.b_patch_size = patch_size, b_patch_size
        self.compute_dtype = dtype
        # holds the weights only; forward is the equivalent reshape + matmul
        k = (b_patch_size, patch_size, patch_size)
        self.proj = nn.Conv3d(1, embed_dim, kernel_size=k, stride=k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, bands = x.shape
        p, u = self.patch_size, self.b_patch_size
        h, w, t = hh // p, ww // p, bands // u
        x = x.reshape(n, h, p, w, p, t, u).permute(0, 5, 1, 3, 6, 2, 4)
        x = x.reshape(n, t, h * w, u * p * p)
        dt = self.compute_dtype
        wgt = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return F.linear(x.to(dt), wgt.to(dt), self.proj.bias.to(dt))


class Attention(nn.Module):
    """MHSA with separate q/k/v projections; softmax in float32."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q = Linear(dim, dim, qkv_bias, dtype)
        self.k = Linear(dim, dim, qkv_bias, dtype)
        self.v = Linear(dim, dim, qkv_bias, dtype)
        self.proj = Linear(dim, dim, True, dtype)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, s = x.shape[:2]
        q, k, v = self.q(x), self.k(x), self.v(x)
        # the heads this rank holds: all of them, or num_heads / model when
        # q, k and v are column-split by tensor parallelism
        hd = self.head_dim
        h = q.shape[-1] // hd
        q, k, v = (t.reshape(n, s, h, hd) for t in (q, k, v))
        attn = torch.einsum("nqhd,nkhd->nhqk", q, k) * (hd**-0.5)
        if attn_bias is not None:
            attn = attn + attn_bias
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, s, h * hd)
        return self.proj(out)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = swiglu_hidden_dim(dim, mlp_ratio)
        self.w1 = Linear(dim, hidden, True, dtype)
        self.w3 = Linear(dim, hidden, True, dtype)
        self.w2 = Linear(hidden, dim, True, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def drop_path(x: torch.Tensor, rate: float, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Stochastic depth: sample ``i`` of ``x`` becomes ``x[i] / (1 - rate)``
    where ``keep[i]`` (a bool per sample) holds, else zero. Identity when
    ``rate`` is 0 or no mask is given (inference)."""
    if rate == 0.0 or keep is None:
        return x
    m = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))


def draw_keep(n: int, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A per-sample keep mask: True with probability ``1 - rate``."""
    return torch.rand(n, generator=generator, device=device) < (1.0 - rate)


class Block(nn.Module):
    """Pre-LN transformer block: x + dp(attn(ln x)); x + dp(swiglu(ln x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.drop_path_rate = float(drop_path_rate)
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwiGLU(dim, mlp_ratio, dtype)

    def forward(self, x: torch.Tensor,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """``keep``: the drop-path keep masks of the attention and the MLP
        branch, ``[x.shape[0]]`` bool each; None: no drop-path."""
        k1, k2 = keep if keep is not None else (None, None)
        x = x + drop_path(self.attn(self.norm1(x).to(self.compute_dtype)), self.drop_path_rate, k1)
        return x + drop_path(self.mlp(self.norm2(x).to(self.compute_dtype)), self.drop_path_rate, k2)


def init_block_(block: Block, generator: torch.Generator, trunc: bool = True) -> None:
    """Seeded init of one Block: linear weights trunc-normal(0.02) (or
    xavier-uniform), biases zero, LayerNorms at (1, 0)."""
    for m in block.modules():
        if isinstance(m, Linear):
            m.reset_parameters_from(generator, trunc)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)

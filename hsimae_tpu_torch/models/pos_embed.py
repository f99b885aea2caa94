"""Frozen 3-D (spectral x spatial) sin-cos position embeddings.

Port-owned numpy copy of ``hsimae_tpu/models/pos_embed.py``:

* the embedding dim is split in half: FIRST half encodes the spectral-group
  ("temporal") index, SECOND half the spatial position;
* the spatial half is itself split: first quarter encodes the column (w),
  second quarter the row (h);
* token order is (t, h, w) row-major, matching PatchEmbed's token layout.
"""

from __future__ import annotations

import numpy as np


def sincos_1d(embed_dim: int, pos: np.ndarray, scale: float | None = None) -> np.ndarray:
    """[M] positions -> [M, embed_dim] with [sin | cos] halves."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1).astype(np.float64)
    if scale is not None:
        pos = pos * scale
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size**2, embed_dim]; first half encodes column, second half row."""
    assert embed_dim % 2 == 0
    rows = np.arange(grid_size, dtype=np.float64)
    cols = np.arange(grid_size, dtype=np.float64)
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    emb_c = sincos_1d(embed_dim // 2, cc)
    emb_r = sincos_1d(embed_dim // 2, rr)
    return np.concatenate([emb_c, emb_r], axis=1)


def sincos_3d(
    embed_dim: int, t_size: int, grid_size: int, scale_t: float | None = None
) -> np.ndarray:
    """[t_size * grid_size**2, embed_dim]; temporal half first, then spatial."""
    assert embed_dim % 4 == 0
    spatial = sincos_2d(embed_dim // 2, grid_size)
    temporal = sincos_1d(embed_dim // 2, np.arange(t_size, dtype=np.float64), scale=scale_t)
    hw = grid_size**2
    temporal = np.repeat(temporal[:, None, :], hw, axis=1)
    spatial = np.repeat(spatial[None, :, :], t_size, axis=0)
    out = np.concatenate([temporal, spatial], axis=-1)
    return out.reshape(-1, embed_dim).astype(np.float32)

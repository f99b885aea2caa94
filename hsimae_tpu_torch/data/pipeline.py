"""Scene-resident patch gathering on the device.

Counterpart of the scene-eval part of ``hsimae_tpu/data/pipeline.py``: the
symmetric-padded scene lives on the device once, and each batch of per-pixel
patches is one flat index gather from it. Patch layout is channels-last
``[B, ps, ps, C]``.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch


def _pad_scene(scene: np.ndarray, pad: int) -> np.ndarray:
    """Symmetric pad, as the reference uses for odd patch sizes."""
    return np.pad(scene, ((pad, pad), (pad, pad), (0, 0)), mode="symmetric")


class ScenePatchSource:
    """One scene resident on ``device``; ``gather_pixels(idx)`` returns the
    patch centred on each pixel: pixel (r, c) -> the window starting at
    (r, c) in the scene padded by ``patch_size // 2``."""

    def __init__(self, scene: np.ndarray, patch_size: int = 9,
                 device: str | torch.device = "cuda"):
        self.h, self.w, self.c = scene.shape
        self.patch_size = patch_size
        self.device = torch.device(device)
        padded = _pad_scene(np.asarray(scene, dtype=np.float32), patch_size // 2)
        self.pw = padded.shape[1]
        self._flat_padded = torch.from_numpy(
            np.ascontiguousarray(padded.reshape(-1, self.c))).to(self.device)
        d = torch.arange(patch_size, device=self.device)
        self._offsets = (d[:, None] * self.pw + d[None, :]).reshape(-1)  # [ps*ps]

    def gather_pixels(self, pixel_idx) -> torch.Tensor:
        idx = torch.as_tensor(pixel_idx, dtype=torch.int64).to(self.device)
        base = (idx // self.w) * self.pw + idx % self.w  # window start in the padded scene
        flat = (base[:, None] + self._offsets[None, :]).reshape(-1)
        ps = self.patch_size
        return self._flat_padded.index_select(0, flat).reshape(idx.shape[0], ps, ps, self.c)


def batch_indices(
    n: int,
    batch_size: int,
    rng=None,
    shuffle: bool = True,
    pad_to_full: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(index_batch, valid_mask)`` covering ``range(n)`` once.

    The final partial batch is padded (wrapping) to a full batch;
    ``valid_mask`` marks real rows so callers can drop the padding.
    """
    order = (rng or np.random).permutation(n) if shuffle else np.arange(n)
    for i in range(0, n, batch_size):
        chunk = order[i : i + batch_size]
        valid = np.ones(len(chunk), dtype=bool)
        if len(chunk) < batch_size and pad_to_full:
            need = batch_size - len(chunk)
            fill = np.resize(order, need)  # tile if the pool is tiny
            chunk = np.concatenate([chunk, fill])
            valid = np.concatenate([valid, np.zeros(need, dtype=bool)])
        yield chunk, valid

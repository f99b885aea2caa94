"""Scene-resident patch gathering on the device.

Counterpart of ``hsimae_tpu/data/pipeline.py``: scenes live on the device
once, and each batch of patches is one index gather from them.

* ``ScenePatchSource``: one scene, symmetric-padded for per-pixel patches
  (classification, the labeled pool) and unpadded for window cuts (the
  unlabeled pool of fine-tuning);
* ``MultiScenePatchSource``: many scenes of different shapes in one flat
  buffer; pretraining cuts by ``(row, col, scene_id)``, normalised per scene;
* ``augment_flips``: per-sample horizontal and vertical flips, with
  injectable flip masks.

Patch layout is channels-last ``[B, ps, ps, C]``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch


def _pad_scene(scene: np.ndarray, pad: int) -> np.ndarray:
    """Symmetric pad, as the reference uses for odd patch sizes."""
    return np.pad(scene, ((pad, pad), (pad, pad), (0, 0)), mode="symmetric")


class ScenePatchSource:
    """One scene resident on ``device``, padded and unpadded.

    * ``gather_pixels(idx)``: the patch centred on each pixel: pixel (r, c)
      -> the window starting at (r, c) in the scene padded by
      ``patch_size // 2``;
    * ``gather_windows(starts)``: windows of the unpadded scene at
      ``[B, 2]`` (row, col) starts.
    """

    def __init__(self, scene: np.ndarray, patch_size: int = 9,
                 device: str | torch.device = "cuda"):
        self.h, self.w, self.c = scene.shape
        self.patch_size = patch_size
        self.device = torch.device(device)
        padded = _pad_scene(np.asarray(scene, dtype=np.float32), patch_size // 2)
        self.pw = padded.shape[1]
        self._flat_padded = torch.from_numpy(
            np.ascontiguousarray(padded.reshape(-1, self.c))).to(self.device)
        self._flat = torch.from_numpy(
            np.ascontiguousarray(scene, dtype=np.float32).reshape(-1, self.c)).to(self.device)
        d = torch.arange(patch_size, device=self.device)
        self._offsets = (d[:, None] * self.pw + d[None, :]).reshape(-1)  # [ps*ps]
        self._offsets_unpadded = (d[:, None] * self.w + d[None, :]).reshape(-1)

    def _take(self, flat: torch.Tensor, base: torch.Tensor, offsets: torch.Tensor):
        ps = self.patch_size
        idx = (base[:, None] + offsets[None, :]).reshape(-1)
        return flat.index_select(0, idx).reshape(base.shape[0], ps, ps, self.c)

    def gather_pixels(self, pixel_idx) -> torch.Tensor:
        idx = torch.as_tensor(pixel_idx, dtype=torch.int64).to(self.device)
        base = (idx // self.w) * self.pw + idx % self.w  # window start in the padded scene
        return self._take(self._flat_padded, base, self._offsets)

    def gather_windows(self, starts) -> torch.Tensor:
        starts = torch.as_tensor(starts, dtype=torch.int64).to(self.device)
        return self._take(self._flat, starts[:, 0] * self.w + starts[:, 1],
                          self._offsets_unpadded)


def gather_multiscene(flat: torch.Tensor, widths: torch.Tensor, bases: torch.Tensor,
                      mins: torch.Tensor, maxs: torch.Tensor, locs: torch.Tensor,
                      ps: int) -> torch.Tensor:
    """``ps``-wide windows at ``locs [B, 3]`` (row, col, scene_id) from the
    concatenated scenes ``flat [sum(h*w), C]``, upcast to float32 after the
    gather, then ``(x - min) / (max - min)`` with the scene's constants
    -> ``[B, ps, ps, C]``."""
    locs = locs.long()
    r, c, sid = locs[:, 0], locs[:, 1], locs[:, 2]
    w = widths[sid]
    base = bases[sid] + r * w + c
    d = torch.arange(ps, device=flat.device)
    idx = base[:, None, None] + d[None, :, None] * w[:, None, None] + d[None, None, :]
    x = flat[idx].float()
    mn = mins[sid][:, None, None, None]
    mx = maxs[sid][:, None, None, None]
    return (x - mn) / (mx - mn)


class MultiScenePatchSource:
    """Many scenes (one band count, any sizes) in one flat buffer on
    ``device``, stored in ``storage_dtype`` (float32 or bfloat16: half the
    memory and upload of a big corpus; patches are upcast after the gather).
    ``gather(locs)`` takes rows of a :class:`PretrainCutIndex`."""

    def __init__(self, scenes: Sequence[np.ndarray], patch_size: int = 9,
                 scene_min: Optional[np.ndarray] = None,
                 scene_max: Optional[np.ndarray] = None,
                 storage_dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        self.patch_size = patch_size
        self.device = torch.device(device)
        c = scenes[0].shape[-1]
        if any(s.shape[-1] != c for s in scenes):
            raise ValueError("all scenes must have the same band count")
        self.c = c
        widths, bases, offset = [], [], 0
        for s in scenes:
            widths.append(s.shape[1])
            bases.append(offset)
            offset += s.shape[0] * s.shape[1]
        # cast per scene on the host, then one upload
        self._flat = torch.cat([
            torch.from_numpy(np.ascontiguousarray(s, dtype=np.float32).reshape(-1, c)).to(storage_dtype)
            for s in scenes]).to(self.device)
        self._widths = torch.tensor(widths, dtype=torch.int64, device=self.device)
        self._bases = torch.tensor(bases, dtype=torch.int64, device=self.device)
        n = len(scenes)
        self._min = torch.as_tensor(scene_min if scene_min is not None else np.zeros(n),
                                    dtype=torch.float32).to(self.device)
        self._max = torch.as_tensor(scene_max if scene_max is not None else np.ones(n),
                                    dtype=torch.float32).to(self.device)

    def gather(self, locs) -> torch.Tensor:
        """Patches at ``locs [B, 3]`` (a host array or a tensor on the device)."""
        locs = torch.as_tensor(locs, dtype=torch.int64).to(self.device)
        return gather_multiscene(self._flat, self._widths, self._bases, self._min, self._max,
                                 locs, self.patch_size)


def draw_flips(n: int, generator: Optional[torch.Generator] = None,
               device: str | torch.device = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (horizontal, vertical) flip masks, each True with
    probability 0.5."""
    fh = torch.rand(n, generator=generator, device=device) < 0.5
    fv = torch.rand(n, generator=generator, device=device) < 0.5
    return fh, fv


def augment_flips(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  flips: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Per-sample random flips of ``[B, h, w, C]`` patches: horizontal flips
    the width axis, vertical the height axis, horizontal first. ``flips``
    gives the ``(fh, fv)`` masks; without it they are drawn from
    ``generator``."""
    fh, fv = flips if flips is not None else draw_flips(x.shape[0], generator, x.device)
    x = torch.where(fh[:, None, None, None], x.flip(2), x)
    return torch.where(fv[:, None, None, None], x.flip(1), x)


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

"""Sliding-window geometry and the lazy pretraining cut index.

Port-owned numpy copy of ``hsimae_tpu/data/windows.py`` (same inputs, same
tables). Scenes stay resident on the device, so this module computes index
tables (window start offsets), never pixels.

``window_starts`` reproduces the reference's ``get_inital_seq``: ``stride``
is an overlap DIVISOR (the step between windows is ``size // stride``) and
the last window is clamped flush to the end.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


def window_starts(length: int, size: int, stride: int = 1) -> np.ndarray:
    """Start offsets of ``size``-wide windows, every ``size // stride``,
    covering the whole extent, the last clamped to ``length - size``."""
    assert size <= length
    step = int(size // stride)
    n1 = length // size
    l_r = length - n1 * size
    n2 = l_r // step
    l_rr = l_r - n2 * step
    num = int((n1 - 1) * stride + n2 + (1 if l_rr == 0 else 2))
    seq = np.arange(0, num * step, step)
    seq[-1] = length - size
    return seq


def patch_grid_indices(h: int, w: int, size: int, stride: int = 1) -> np.ndarray:
    """Row-major ``[n, 2]`` (row, col) window starts (rows outer)."""
    rs = window_starts(h, size, stride)
    cs = window_starts(w, size, stride)
    rr, cc = np.meshgrid(rs, cs, indexing="ij")
    return np.stack([rr.reshape(-1), cc.reshape(-1)], axis=-1)


@dataclasses.dataclass
class PretrainCutIndex:
    """Patch index over a list of scenes: ``locs`` rows are (row, col,
    scene_id) int32; per-scene normalisation constants in ``scene_max`` /
    ``scene_min`` (1 / 0 when not normalising, the reference default)."""

    locs: np.ndarray  # [n, 3] int32
    scene_max: np.ndarray  # [n_scenes] float32
    scene_min: np.ndarray  # [n_scenes] float32

    def __len__(self) -> int:
        return len(self.locs)


def build_pretrain_cut_index(
    scene_shapes: Sequence[tuple],
    patch_size: int = 9,
    norm: bool = False,
    scene_ranges: Optional[Sequence[tuple]] = None,
    ratio: float = 1.0,
    coarse_from: int = 14,
    rng: Optional[np.random.Generator] = None,
) -> PretrainCutIndex:
    """The HSIHybrid-style cut index: scenes with id < ``coarse_from`` get
    overlapping step-``size // 3`` windows, shuffled and subsampled to
    ``ratio``; later scenes get non-overlapping windows."""
    rng = rng or np.random.default_rng(0)
    all_locs: List[np.ndarray] = []
    maxs, mins = [], []
    for sid, shape in enumerate(scene_shapes):
        h, w = shape[0], shape[1]
        if sid >= coarse_from:
            grid = patch_grid_indices(h, w, patch_size, stride=1)
        else:
            grid = patch_grid_indices(h, w, patch_size, stride=3)
            perm = rng.permutation(len(grid))
            grid = grid[perm][: int(len(grid) * ratio)]
        locs = np.concatenate(
            [grid, np.full((len(grid), 1), sid, dtype=np.int64)], axis=-1
        ).astype(np.int32)
        all_locs.append(locs)
        mn, mx = scene_ranges[sid] if norm and scene_ranges is not None else (0.0, 1.0)
        maxs.append(mx)
        mins.append(mn)
    return PretrainCutIndex(
        locs=np.concatenate(all_locs, axis=0),
        scene_max=np.array(maxs, dtype=np.float32),
        scene_min=np.array(mins, dtype=np.float32),
    )

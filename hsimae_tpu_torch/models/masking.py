"""Spatial-spectral grid masking.

Counterpart of ``hsimae_tpu/models/masking.py``. The kept set of a sample is
the cross product of ``len_t`` random spectral rows and ``len_l`` random
spatial columns of its ``[T, L]`` token grid, with the kept ids in row-major
``(t, l)`` order. ``(len_t, len_l)`` is drawn on the host per batch; the rows
and columns are drawn on the device, or given (``GridMask.from_ids``), which
is how a caller injects draws made elsewhere.
"""

from __future__ import annotations

import random as _pyrandom
from typing import NamedTuple, Optional, Tuple

import torch


def _best_shapes(t_size: int, l_size: int, mask_ratio: float):
    target = (1.0 - mask_ratio) * t_size * l_size
    cands = [(t, l) for t in range(2, t_size + 1) for l in range(2, l_size + 1)]
    diffs = [abs(target - t * l) for t, l in cands]
    best = min(diffs)
    return [c for c, d in zip(cands, diffs) if d == best]


def choose_grid_shape(t_size: int, l_size: int, mask_ratio: float,
                      rng: Optional[_pyrandom.Random] = None) -> Tuple[int, int]:
    """Kept-grid shape ``(len_t, len_l)``: among ``2 <= len_t <= T,
    2 <= len_l <= L``, those closest to ``(1 - ratio) * T * L`` kept tokens,
    the tie broken uniformly by ``rng``."""
    rng = rng or _pyrandom
    ties = _best_shapes(t_size, l_size, mask_ratio)
    return ties[rng.randrange(len(ties))]


def grid_shape_candidates(t_size: int, l_size: int, mask_ratio: float):
    """Every ``(len_t, len_l)`` that :func:`choose_grid_shape` can return."""
    return _best_shapes(t_size, l_size, mask_ratio)


def group_by_shape(items, t_size: int, l_size: int, mask_ratio: float, rng):
    """One kept-grid shape per item, items grouped by shape:
    ``{(len_t, len_l): [items...]}`` in first-drawn order."""
    by = {}
    for it in items:
        s = choose_grid_shape(t_size, l_size, mask_ratio, rng)
        by.setdefault(s, []).append(it)
    return by


class GridMask(NamedTuple):
    ids_keep: torch.Tensor  # [N, len_t * len_l] int64, row-major over the kept grid
    mask: torch.Tensor  # [N, T * L] float32: 0 = keep, 1 = masked
    ids_t: torch.Tensor  # [N, len_t] kept spectral rows, ascending
    ids_l: torch.Tensor  # [N, len_l] kept spatial columns, ascending

    @classmethod
    def from_ids(cls, ids_t: torch.Tensor, ids_l: torch.Tensor, t_size: int,
                 l_size: int) -> "GridMask":
        """The mask of the given kept rows and columns (each ascending)."""
        ids_t, ids_l = ids_t.long(), ids_l.long()
        n = ids_t.shape[0]
        ids_keep = (ids_t[:, :, None] * l_size + ids_l[:, None, :]).reshape(n, -1)
        mask = torch.ones(n, t_size * l_size, dtype=torch.float32, device=ids_t.device)
        mask.scatter_(1, ids_keep, 0.0)
        return cls(ids_keep=ids_keep, mask=mask, ids_t=ids_t, ids_l=ids_l)


def _pick(n: int, size: int, count: int, generator: Optional[torch.Generator],
          device) -> torch.Tensor:
    """Per row, the ``count`` positions of the smallest uniform noise, ascending."""
    noise = torch.rand(n, size, generator=generator, device=device)
    return torch.topk(noise, count, dim=1, largest=False).indices.sort(dim=1).values


def spatial_spectral_mask(n: int, t_size: int, l_size: int, len_t: int, len_l: int,
                          generator: Optional[torch.Generator] = None,
                          device: str | torch.device = "cuda") -> GridMask:
    """Draw a per-sample kept grid: rows from the first noise draw, columns
    from the second."""
    ids_t = _pick(n, t_size, len_t, generator, device)
    ids_l = _pick(n, l_size, len_l, generator, device)
    return GridMask.from_ids(ids_t, ids_l, t_size, l_size)


def gather_tokens(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Tokens ``x [N, S, C]`` at per-sample ids ``[N, K]`` -> ``[N, K, C]``."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def scatter_tokens(kept: torch.Tensor, ids_keep: torch.Tensor, seq_len: int,
                   fill: torch.Tensor) -> torch.Tensor:
    """``kept [N, K, C]`` placed at ``ids_keep`` in a length-``seq_len``
    sequence whose other slots hold ``fill [N, 1, C]``. An index scatter: a
    kept slot holds ``kept`` exactly (the JAX package's one-hot product
    gives ``(kept - fill) + fill`` there)."""
    n, _, c = kept.shape
    full = fill.expand(n, seq_len, c)
    return torch.scatter(full, 1, ids_keep[..., None].expand(-1, -1, c), kept)

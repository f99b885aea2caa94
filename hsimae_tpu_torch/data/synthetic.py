"""Synthetic hyperspectral scenes for tests and benchmarks.

Port-owned copy of ``make_synthetic_scene``, ``make_textured_scene`` and
their pretraining corpora (``make_synthetic_pretrain_scenes``,
``make_textured_pretrain_scenes``) from ``hsimae_tpu/data/synthetic.py``
(numpy only; same seeds, same scenes).

No public HSI dataset ships with this environment, so end-to-end tests and
throughput benchmarks run on generated scenes: a Voronoi segmentation of the
plane into classes, each class with a smooth random spectral signature,
plus band-correlated noise and per-pixel illumination scaling. The result is
linearly separable enough that a correct model visibly learns (OA >> chance)
while remaining non-trivial.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_synthetic_scene(
    h: int = 64,
    w: int = 64,
    bands: int = 103,
    n_classes: int = 6,
    noise: float = 0.05,
    background_frac: float = 0.1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return ``(scene [h, w, bands] float32, gt [h, w] int32)``.

    ``gt`` uses the reference convention: 0 = background (unlabeled), classes
    are 1..n_classes.
    """
    rng = np.random.default_rng(seed)

    # smooth per-class signatures: random low-frequency Fourier mixtures
    x = np.linspace(0, 1, bands)
    sigs = np.zeros((n_classes, bands))
    for k in range(n_classes):
        for f in range(1, 6):
            sigs[k] += rng.normal() * np.sin(2 * np.pi * f * x + rng.uniform(0, 2 * np.pi)) / f
        sigs[k] = sigs[k] - sigs[k].min() + 0.2 + 0.3 * rng.random()

    # Voronoi class layout
    n_seeds = n_classes * 4
    pts = rng.uniform(0, 1, (n_seeds, 2)) * np.array([h, w])
    owners = rng.integers(1, n_classes + 1, n_seeds)
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d2 = (rr[..., None] - pts[:, 0]) ** 2 + (cc[..., None] - pts[:, 1]) ** 2
    gt = owners[np.argmin(d2, axis=-1)].astype(np.int32)

    # background: random blobs set to 0
    n_bg = max(1, int(background_frac * n_seeds))
    bg_pts = rng.uniform(0, 1, (n_bg, 2)) * np.array([h, w])
    bg_r = rng.uniform(0.05, 0.15, n_bg) * min(h, w)
    for p, r in zip(bg_pts, bg_r):
        m = (rr - p[0]) ** 2 + (cc - p[1]) ** 2 < r**2
        gt[m] = 0

    illum = 1.0 + 0.2 * rng.standard_normal((h, w, 1))
    scene = sigs[np.maximum(gt, 1) - 1] * illum
    scene = scene + noise * rng.standard_normal((h, w, bands))
    # background pixels get a distinct flat spectrum
    scene[gt == 0] = 0.1 + noise * rng.standard_normal((int((gt == 0).sum()), bands))
    return scene.astype(np.float32), gt


def _smooth_spectrum(rng: np.random.Generator, bands: int) -> np.ndarray:
    """Random low-frequency Fourier mixture, offset positive."""
    x = np.linspace(0, 1, bands)
    s = np.zeros(bands)
    for f in range(1, 6):
        s += rng.normal() * np.sin(2 * np.pi * f * x + rng.uniform(0, 2 * np.pi)) / f
    return s - s.min() + 0.2 + 0.3 * rng.random()


# class index (1-based) -> binary texture over (row, col) with phase (pr, pc).
# All textures use the SAME two materials in the SAME 50/50 proportion;
# orientation pairs are flip-safe (H/V flips map each class to itself, so the
# reference's flip augmentation cannot corrupt labels).
_TEXTURES = [
    lambda r, c, pr, pc: (r + c + pr) % 2,                       # checker p1
    lambda r, c, pr, pc: ((r + pr) // 2 + (c + pc) // 2) % 2,    # checker p2
    lambda r, c, pr, pc: ((r + pr) // 2) % 2,                    # h-stripes p2
    lambda r, c, pr, pc: ((c + pc) // 2) % 2,                    # v-stripes p2
    None,                                                        # iid speckle
    lambda r, c, pr, pc: ((r + pr) // 3 + (c + pc) // 3) % 2,    # checker p3
]


def make_textured_scene(
    h: int = 64,
    w: int = 64,
    bands: int = 103,
    n_classes: int = 6,
    noise: float = 0.05,
    background_frac: float = 0.1,
    seed: int = 0,
    speckle_flip: float = 0.08,
    cells_per_class: int = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """A scene whose class identity lives ONLY in joint spatial-spectral
    structure — the benchmark HSIMAE exists for.

    Every class is built from the SAME two material spectra in the SAME
    50/50 proportion; classes differ only in the spatial ARRANGEMENT of the
    materials inside a neighborhood (pixel/2/3-period checkerboards, stripe
    orientations, iid speckle — ``_TEXTURES``). The per-pixel spectral
    marginal is therefore IDENTICAL across classes: a 1x1-pixel classifier
    (SVM-RBF, the per-pixel winner on :func:`make_synthetic_scene`) is at
    chance by construction, while any 9x9 patch away from a boundary
    determines the class. ``speckle_flip`` flips each pixel's material with
    equal probability in every class (keeps marginals equal, degrades naive
    template matching). Texture phase is randomized per Voronoi cell so
    absolute position carries no label information.

    ``cells_per_class``: when set, the layout uses exactly
    ``n_classes * cells_per_class`` Voronoi cells with owners drawn as a
    shuffled balanced repeat — every class is guaranteed present, and small
    cell counts give LARGE texture regions (few 9x9 windows straddle a
    boundary). The default (None) keeps the original geometry
    (``4 * n_classes`` cells, iid random owners), whose many small cells
    leave only ~20 % of test pixels with a single-class window — boundary
    ambiguity, not texture identity, then dominates the task. The shared
    texture *benchmark* scene is 96x96 with ``cells_per_class=2``
    (pure-window fraction ~0.63, all classes >=750 px).

    Same conventions as :func:`make_synthetic_scene`: returns
    ``(scene [h, w, bands] float32, gt [h, w] int32)``, gt 0 = background.
    """
    assert 2 <= n_classes <= len(_TEXTURES)
    rng = np.random.default_rng(seed)

    sig_a = _smooth_spectrum(rng, bands)
    sig_b = _smooth_spectrum(rng, bands)

    # Voronoi class layout + per-cell texture phase
    if cells_per_class is not None:
        n_seeds = n_classes * cells_per_class
        pts = rng.uniform(0, 1, (n_seeds, 2)) * np.array([h, w])
        owners = rng.permutation(
            np.repeat(np.arange(1, n_classes + 1), cells_per_class))
    else:
        n_seeds = n_classes * 4
        pts = rng.uniform(0, 1, (n_seeds, 2)) * np.array([h, w])
        owners = rng.integers(1, n_classes + 1, n_seeds)
    phases = rng.integers(0, 6, (n_seeds, 2))
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d2 = (rr[..., None] - pts[:, 0]) ** 2 + (cc[..., None] - pts[:, 1]) ** 2
    cell = np.argmin(d2, axis=-1)
    gt = owners[cell].astype(np.int32)

    # per-pixel binary material map from the class texture
    mat = np.zeros((h, w), np.int64)
    for k in range(1, n_classes + 1):
        m = gt == k
        if not m.any():
            continue
        tex = _TEXTURES[k - 1]
        if tex is None:  # iid speckle
            mat[m] = rng.integers(0, 2, int(m.sum()))
        else:
            pr = phases[cell, 0]
            pc = phases[cell, 1]
            mat[m] = tex(rr, cc, pr, pc)[m]
    if speckle_flip > 0:
        flip = rng.random((h, w)) < speckle_flip
        mat = np.where(flip, 1 - mat, mat)

    # background blobs (class 0): distinct flat spectrum, excluded by metrics
    n_bg = max(1, int(background_frac * n_seeds))
    bg_pts = rng.uniform(0, 1, (n_bg, 2)) * np.array([h, w])
    bg_r = rng.uniform(0.05, 0.15, n_bg) * min(h, w)
    for p, r in zip(bg_pts, bg_r):
        gt[(rr - p[0]) ** 2 + (cc - p[1]) ** 2 < r**2] = 0

    illum = 1.0 + 0.2 * rng.standard_normal((h, w, 1))
    sigs = np.stack([sig_a, sig_b])
    scene = sigs[mat] * illum + noise * rng.standard_normal((h, w, bands))
    nbg = int((gt == 0).sum())
    scene[gt == 0] = 0.1 + noise * rng.standard_normal((nbg, bands))
    return scene.astype(np.float32), gt


def make_textured_pretrain_scenes(
    n_scenes: int = 3,
    size_range=(48, 80),
    bands: int = 103,
    seed: int = 0,
    cells_per_class: Optional[int] = None,
):
    """Unlabeled texture-family corpus for MAE pretraining: scenes of
    :func:`make_textured_scene` with seeds ``seed + 200 + i`` and random
    sizes in ``size_range``."""
    rng = np.random.default_rng(seed)
    scenes = []
    for i in range(n_scenes):
        h = int(rng.integers(*size_range))
        w = int(rng.integers(*size_range))
        s, _ = make_textured_scene(h, w, bands, seed=seed + 200 + i,
                                   cells_per_class=cells_per_class)
        scenes.append(s)
    return scenes


def make_synthetic_pretrain_scenes(
    n_scenes: int = 3,
    size_range=(40, 80),
    bands: int = 103,
    seed: int = 0,
):
    """A small HSIHybrid-like corpus: scenes of :func:`make_synthetic_scene`
    (5 classes, seeds ``seed + 100 + i``) with random sizes in ``size_range``."""
    rng = np.random.default_rng(seed)
    scenes = []
    for i in range(n_scenes):
        h = int(rng.integers(*size_range))
        w = int(rng.integers(*size_range))
        s, _ = make_synthetic_scene(h, w, bands, n_classes=5, seed=seed + 100 + i)
        scenes.append(s)
    return scenes

"""GroupWise PCA: reduce an HSI cube to a fixed band count, group by group.

Port-owned copy of ``hsimae_tpu/data/gwpca.py`` (numpy only).

Behavioral spec (the reference's ``Utils/GroupWisePCA.py``):

1. Flatten the cube to ``[h*w, c]`` and min-max normalize by the GLOBAL min/max
   of the whole cube (not per band).
2. Recursively halve the band axis log2(group) times, producing ``group``
   contiguous band groups. With odd widths the halving nests (e.g. c=103,
   group=4 -> widths 25, 26, 26, 26), which a flat equal partition would get
   wrong — the recursion is preserved here.
3. Per group: PCA to ``nc/group`` whitened components (sklearn semantics,
   ``random_state=42``), then concatenate -> ``[h, w, nc]``.

The PCA itself is re-implemented on top of an eigendecomposition of the
``f x f`` band covariance (f ~ c/group is tiny), which is exact and much
cheaper than an SVD over all pixels; sklearn's deterministic sign convention
(``svd_flip``) is reproduced so that features feeding the published pretrained
checkpoints match. sklearn picks its sign convention from the solver it
auto-selects, so both conventions are implemented and chosen the same way.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def split_band_groups(c: int, group: int = 4) -> List[Tuple[int, int]]:
    """Band-group boundaries by recursive halving (matches ``split_data``)."""
    assert group >= 1 and (group & (group - 1)) == 0, "group must be a power of 2"
    spans = [(0, c)]
    while len(spans) < group:
        nxt = []
        for lo, hi in spans:
            mid = lo + (hi - lo) // 2
            nxt.append((lo, mid))
            nxt.append((mid, hi))
        spans = nxt
    return spans


def pca_fit_transform(
    x: np.ndarray, n_components: int, whiten: bool = True, sign_convention: str = "v"
) -> np.ndarray:
    """Exact PCA fit_transform of ``x [n, f]`` -> ``[n, k]``.

    ``sign_convention``:
      * ``"v"``  — flip so each component row's max-|.| entry is positive.
        This is what modern sklearn uses for every PCA solver
        (``svd_flip(U, Vt, u_based_decision=False)``), so it is the default.
      * ``"u"``  — flip so each score column's max-|.| entry is positive
        (historical sklearn full-SVD convention).
    """
    x = np.asarray(x, dtype=np.float64)
    n, f = x.shape
    k = int(n_components)
    assert 1 <= k <= f

    mean = x.mean(axis=0)
    xc = x - mean
    cov = (xc.T @ xc) / (n - 1)
    evals, evecs = np.linalg.eigh(cov)  # ascending
    order = np.argsort(evals)[::-1][:k]
    evals = np.maximum(evals[order], 0.0)  # [k] explained variance
    comps = evecs[:, order]  # [f, k]

    scores = xc @ comps  # [n, k] == U * S

    if sign_convention == "u":
        picks = np.argmax(np.abs(scores), axis=0)
        signs = np.sign(scores[picks, np.arange(k)])
    else:
        picks = np.argmax(np.abs(comps), axis=0)
        signs = np.sign(comps[picks, np.arange(k)])
    signs[signs == 0] = 1.0
    scores = scores * signs

    if whiten:
        scale = np.sqrt(np.maximum(evals, 1e-30))
        scores = scores / scale
    return scores


def apply_gwpca(
    cube: np.ndarray,
    nc: int = 32,
    group: int = 4,
    whiten: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """GroupWise PCA of an ``[h, w, c]`` cube to ``[h, w, nc]``."""
    h, w, c = cube.shape
    assert nc % group == 0
    x = np.asarray(cube, dtype=np.float64).reshape(-1, c)
    lo, hi = x.min(), x.max()
    x = (x - lo) / (hi - lo)

    outs = []
    for b0, b1 in split_band_groups(c, group):
        outs.append(pca_fit_transform(x[:, b0:b1], nc // group, whiten=whiten))
    out = np.concatenate(outs, axis=-1)
    return out.reshape(h, w, nc).astype(dtype)

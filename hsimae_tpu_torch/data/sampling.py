"""Per-class few-shot samplers and the labeled/unlabeled split of a scene.

Port-owned numpy copy of ``hsimae_tpu/data/sampling.py`` (same inputs and
generator, same index tables). Samplers return pixel indices into the
scene, and the unlabeled pool is a table of window starts; pixels are
gathered on the device by :mod:`hsimae_tpu_torch.data.pipeline`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from hsimae_tpu_torch.data.gwpca import apply_gwpca
from hsimae_tpu_torch.data.windows import patch_grid_indices


def _rng(rng) -> np.random.Generator:
    """``rng``, or numpy's global generator when None (the reference
    samples from the globally seeded ``np.random``)."""
    return np.random if rng is None else rng


def sample_per_class(gt_flat: np.ndarray, num: Optional[int] = None,
                     percent: Optional[float] = None,
                     rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pick ``num`` (or ``ceil(percent * count)``) training pixels per class
    -> ``(train_index, test_gt_flat)``, the latter ``gt_flat`` with the
    training pixels zeroed. Class 0 is background and never sampled. A class
    whose population is exactly ``num`` gives ``num - 5`` samples (a
    reference quirk that keeps its test set non-empty)."""
    r = _rng(rng)
    gt_flat = np.asarray(gt_flat).reshape(-1)
    n_classes = int(gt_flat.max()) + 1

    shuffled = r.permutation(len(gt_flat))
    labels = gt_flat[shuffled]

    if percent is not None:
        counts = np.array([(gt_flat == l).sum() for l in range(n_classes)])
        quota = np.ceil(counts * percent)
    elif num is not None:
        quota = np.full(n_classes, float(num))
        counts = np.bincount(gt_flat, minlength=n_classes)
        quota[counts == num] = num - 5
    else:
        raise ValueError("one of num / percent required")

    taken = np.zeros(n_classes)
    train_index = []
    test_gt = gt_flat.copy()
    for pos, lab in zip(shuffled, labels):
        if lab == 0:
            continue
        taken[lab] += 1
        if taken[lab] <= quota[lab]:
            train_index.append(pos)
            test_gt[pos] = 0
    return np.array(train_index, dtype=np.int64), test_gt


def train_val_split(indices: np.ndarray, labels: np.ndarray, training_ratio: float = 0.5,
                    rng=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stratified split of a labeled pool (labels 1-based) -> ``(train_idx,
    train_y, val_idx, val_y)``: per class, the first ``count * (1 - ratio)``
    met in shuffled order go to val, the rest to train. With ratio 1 the
    val set is the first fifth of the train set."""
    r = _rng(rng)
    indices = np.asarray(indices)
    labels = np.asarray(labels)
    n_classes = int(labels.max())

    order = r.permutation(len(labels))
    counts = np.array([(labels == l + 1).sum() for l in range(n_classes)])
    val_quota = counts * (1.0 - training_ratio)
    taken = np.zeros(n_classes)

    tr, va = [], []
    for i in order:
        c = labels[i] - 1
        taken[c] += 1
        (va if taken[c] <= val_quota[c] else tr).append(i)
    if training_ratio == 1:
        va = tr[: int(len(tr) * 0.2)]
    tr, va = np.array(tr, dtype=np.int64), np.array(va, dtype=np.int64)
    return indices[tr], labels[tr], indices[va], labels[va]


@dataclasses.dataclass
class DualSceneSplit:
    """What dual-branch fine-tuning needs from one scene, as index tables:

    * ``scene``: ``[h, w, c]`` preprocessed cube (GWPCA'd, normalised);
    * ``labeled_index``: row-major pixel ids of the labeled pool;
    * ``labels``: the gt at those pixels (1-based);
    * ``unlabeled_starts``: ``[m, 2]`` starts of the non-overlapping windows
      of the unpadded scene (the unlabeled pool);
    * ``test_gt``: the gt with the labeled pixels zeroed, ``[h, w]``;
    * ``gt``: the raw gt, ``[h, w]``.
    """

    scene: np.ndarray
    labeled_index: np.ndarray
    labels: np.ndarray
    unlabeled_starts: np.ndarray
    test_gt: np.ndarray
    gt: np.ndarray

    @property
    def n_classes(self) -> int:
        return int(self.gt.max()) + 1


def dual_scene_split(scene: np.ndarray, gt: np.ndarray, patch_size: int = 9,
                     num: Optional[int] = None, percent: Optional[float] = None,
                     norm: bool = False, gwpca: bool = True, nc: int = 32,
                     rng=None) -> DualSceneSplit:
    """Scene preprocessing (GWPCA to ``nc`` bands, optional min-max norm)
    and the labeled/unlabeled split."""
    scene = np.asarray(scene)
    gt = np.asarray(gt)
    if scene.shape[:2] != gt.shape:
        raise ValueError(f"scene {scene.shape[:2]} and gt {gt.shape} differ in size")

    if gwpca:
        scene = apply_gwpca(scene, nc=nc, group=4, whiten=True)
    if norm:
        mn, mx = scene.min(), scene.max()
        scene = (scene - mn) / (mx - mn)
    scene = np.ascontiguousarray(scene, dtype=np.float32)

    h, w, _ = scene.shape
    # the unlabeled pool: non-overlapping windows (step = patch size)
    unlabeled_starts = patch_grid_indices(h, w, patch_size, stride=1)

    train_index, test_gt = sample_per_class(gt.reshape(-1), num=num, percent=percent, rng=rng)
    labels = gt.reshape(-1)[train_index]

    return DualSceneSplit(
        scene=scene,
        labeled_index=train_index,
        labels=labels.astype(np.int32),
        unlabeled_starts=unlabeled_starts.astype(np.int32),
        test_gt=test_gt.reshape(gt.shape),
        gt=gt,
    )

"""Named dataset registry and loaders.

Port-owned numpy copy of ``hsimae_tpu/data/datasets.py``. A dataset lives
under a root-relative layout:

    <root>/<dir>/data.npy    [h, w, bands] float
    <root>/<dir>/gt.npy      [h, w] int, 0 = background

or as the original MATLAB downloads in the same directory. The root
defaults to ``$HSIMAE_DATA_ROOT`` (or ``./datasets``). Band and class counts
are validated on load. A pretraining corpus is a directory of scene ``.npy``
cubes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    name: str
    dirname: str
    bands: int
    n_classes: int  # including background class 0


REGISTRY = {
    "Salinas": DatasetInfo("Salinas", "Salinas", 204, 17),
    "PaviaU": DatasetInfo("PaviaU", "PaviaU", 103, 10),
    "Houston2013": DatasetInfo("Houston2013", "Houston2013", 144, 16),
    "LongKou": DatasetInfo("LongKou", "WHU-Hi-LongKou", 270, 10),
}


def data_root(root: Optional[str] = None) -> str:
    return root or os.environ.get("HSIMAE_DATA_ROOT", "datasets")


def get_data_path(name: str, root: Optional[str] = None) -> Tuple[str, str]:
    info = REGISTRY[name]
    base = os.path.join(data_root(root), info.dirname)
    return os.path.join(base, "data.npy"), os.path.join(base, "gt.npy")


def _mat_arrays(path: str) -> dict:
    """Non-metadata numeric arrays of a MATLAB file (v5 via scipy, v7.3 via
    h5py). Keys like ``__header__`` are dropped."""
    try:
        from scipy.io import loadmat

        md = loadmat(path)
        return {k: np.asarray(v) for k, v in md.items()
                if not k.startswith("__") and getattr(v, "ndim", 0) >= 2}
    except NotImplementedError:  # MATLAB v7.3 = HDF5
        import h5py

        out = {}
        with h5py.File(path, "r") as f:
            for k in f.keys():
                v = f[k]
                if hasattr(v, "shape") and len(v.shape) >= 2:
                    # MATLAB/HDF5 stores column-major: transpose back
                    out[k] = np.asarray(v).T
        return out


def resolve_mat_scene(base: str) -> Tuple[np.ndarray, np.ndarray]:
    """Find (scene, gt) in a dataset directory holding the original MATLAB
    downloads (e.g. ``Salinas_corrected.mat`` + ``Salinas_gt.mat``,
    ``PaviaU.mat`` + ``PaviaU_gt.mat``, ``WHU_Hi_LongKou.mat``). The scene is
    the unique 3-D array; gt is the 2-D non-negative integer-valued array
    matching its spatial shape."""
    arrays: dict = {}
    for f in sorted(os.listdir(base)):
        if f.endswith(".mat"):
            for k, v in _mat_arrays(os.path.join(base, f)).items():
                arrays[f"{f}:{k}"] = v
    scenes = {k: v for k, v in arrays.items() if v.ndim == 3}
    if len(scenes) != 1:
        raise FileNotFoundError(
            f"{base}: expected exactly one 3-D cube across the .mat files, "
            f"found {sorted(scenes)} (all arrays: {sorted(arrays)})")
    (sk, scene), = scenes.items()
    gts = {k: v for k, v in arrays.items()
           if v.ndim == 2 and v.shape == scene.shape[:2]
           and np.issubdtype(v.dtype, np.number)
           and np.all(v >= 0) and np.all(v == np.round(v))}
    if len(gts) != 1:
        raise FileNotFoundError(
            f"{base}: expected exactly one [h, w] integer ground-truth map "
            f"matching {sk}'s spatial shape, found {sorted(gts)}")
    (_, gt), = gts.items()
    return scene, gt


def load_dataset(name: str, root: Optional[str] = None,
                 validate: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """-> (scene [h, w, bands] float32, gt [h, w] int32).

    Prefers the reference's pre-converted ``data.npy``/``gt.npy`` layout;
    falls back to the original MATLAB downloads dropped in the same
    directory (see resolve_mat_scene)."""
    info = REGISTRY[name]
    dp, gp = get_data_path(name, root)
    if os.path.exists(dp):
        scene, gt = np.load(dp), np.load(gp)
    else:
        scene, gt = resolve_mat_scene(os.path.dirname(dp))
    scene = np.asarray(scene, np.float32)
    gt = np.asarray(gt).astype(np.int32)
    if validate:
        assert scene.ndim == 3 and scene.shape[:2] == gt.shape, (scene.shape, gt.shape)
        assert scene.shape[-1] == info.bands, (
            f"{name}: expected {info.bands} bands, got {scene.shape[-1]}")
        assert int(gt.max()) + 1 <= info.n_classes
    return scene, gt


def load_pretrain_corpus(directory: str, limit: Optional[int] = None) -> List[np.ndarray]:
    """Load every ``*.npy`` scene cube in a directory (HSIHybrid layout)."""
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npy"))
    if limit:
        files = files[:limit]
    return [np.load(os.path.join(directory, f)) for f in files]

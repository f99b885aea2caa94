"""Port parity for fine-tuning's data: the few-shot samplers, the
train/val split and the dual scene split (``hsimae_tpu_torch.data.sampling``)
and ``ScenePatchSource.gather_windows``, against ``hsimae_tpu``. Everything
here is bit-equal: the port's copies run the same numpy code on the same
inputs and generators, and the gathers move data only."""

import numpy as np
import pytest
import torch

from hsimae_tpu.data import pipeline as jpipe
from hsimae_tpu.data import sampling as js
from hsimae_tpu.data.synthetic import make_synthetic_scene
from hsimae_tpu_torch.data import pipeline as tpipe
from hsimae_tpu_torch.data import sampling as ts


def gt_of(seed, h=30, w=28, classes=5):
    """A label map with a background share and one class of exactly 10
    pixels (the ``num - 5`` quirk's case at num 10)."""
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, classes, (h, w))
    gt[gt == classes - 1] = 1
    gt.reshape(-1)[rng.choice(h * w, 10, replace=False)] = classes - 1
    return gt


@pytest.mark.parametrize("kw", [dict(num=10), dict(num=3), dict(percent=0.05),
                                dict(percent=0.3)], ids=["num10", "num3", "pct5", "pct30"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_per_class_equal(kw, seed):
    gt = gt_of(seed).reshape(-1)
    got = ts.sample_per_class(gt, rng=np.random.default_rng(seed), **kw)
    want = js.sample_per_class(gt, rng=np.random.default_rng(seed), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if kw.get("num") == 10:  # the class of exactly 10 pixels gives 10 - 5
        assert (gt[got[0]] == 4).sum() == 5


def test_sample_per_class_needs_num_or_percent():
    with pytest.raises(ValueError, match="num / percent"):
        ts.sample_per_class(np.arange(4))


@pytest.mark.parametrize("ratio", [0.5, 0.7, 1.0])
def test_train_val_split_equal(ratio):
    rng = np.random.default_rng(5)
    labels = rng.integers(1, 6, 73)
    idx = rng.permutation(1000)[:73]
    got = ts.train_val_split(idx, labels, ratio, rng=np.random.default_rng(9))
    want = js.train_val_split(idx, labels, ratio, rng=np.random.default_rng(9))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if ratio == 1.0:  # val is the first fifth of train
        np.testing.assert_array_equal(got[2], got[0][:len(got[0]) // 5])


@pytest.mark.parametrize("gwpca,norm", [(True, False), (False, True)])
def test_dual_scene_split_equal(gwpca, norm):
    scene, gt = make_synthetic_scene(31, 29, bands=40, n_classes=5, seed=2)
    kw = dict(patch_size=9, num=6, gwpca=gwpca, norm=norm, nc=16)
    got = ts.dual_scene_split(scene, gt, rng=np.random.default_rng(4), **kw)
    want = js.dual_scene_split(scene, gt, rng=np.random.default_rng(4), **kw)
    for f in ("scene", "labeled_index", "labels", "unlabeled_starts", "test_gt", "gt"):
        a, b = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.dtype == b.dtype, f
    assert got.n_classes == want.n_classes == 6  # background and 5 classes
    # non-overlapping windows of the unpadded scene, the last flush to its edge
    assert got.unlabeled_starts.max(axis=0).tolist() == [31 - 9, 29 - 9]


def test_dual_scene_split_checks_sizes():
    with pytest.raises(ValueError, match="differ in size"):
        ts.dual_scene_split(np.zeros((5, 6, 8)), np.zeros((5, 5), int), gwpca=False, num=1)


@pytest.mark.parametrize("ps", [9, 7, 4])
def test_gather_windows_and_pixels_equal(ps):
    scene = np.random.default_rng(ps).standard_normal((23, 19, 6)).astype(np.float32)
    rng = np.random.default_rng(1)
    starts = np.stack([rng.integers(0, 23 - ps + 1, 17), rng.integers(0, 19 - ps + 1, 17)], -1)
    pixels = rng.integers(0, 23 * 19, 17)
    src_t = tpipe.ScenePatchSource(scene, ps, device="cpu")
    src_j = jpipe.ScenePatchSource(scene, ps)
    np.testing.assert_array_equal(src_t.gather_windows(starts).numpy(),
                                  np.asarray(src_j.gather_windows(starts.astype(np.int32))))
    np.testing.assert_array_equal(src_t.gather_pixels(torch.from_numpy(pixels)).numpy(),
                                  np.asarray(src_j.gather_pixels(pixels)))
    r, c = starts[3]
    np.testing.assert_array_equal(src_t.gather_windows(starts)[3].numpy(),
                                  scene[r:r + ps, c:c + ps])

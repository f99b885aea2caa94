"""Port parity for the named-dataset loaders: ``hsimae_tpu_torch.data.datasets``
against ``hsimae_tpu.data.datasets`` on layouts written to a temporary
root (the pre-converted ``.npy`` pair and the original MATLAB files), the
same errors on malformed directories, the pretraining corpus, and the
``--dataset`` flag of the port's CLIs. Everything here is exact."""

import argparse

import numpy as np
import pytest
import scipy.io

from hsimae_tpu.data import datasets as jds
from hsimae_tpu_torch.cli import common as tcommon
from hsimae_tpu_torch.data import datasets as tds


def test_registries_equal():
    assert set(tds.REGISTRY) == set(jds.REGISTRY)
    for name, info in jds.REGISTRY.items():
        t = tds.REGISTRY[name]
        assert (t.name, t.dirname, t.bands, t.n_classes) == (
            info.name, info.dirname, info.bands, info.n_classes)


def test_data_root_and_paths(monkeypatch, tmp_path):
    monkeypatch.delenv("HSIMAE_DATA_ROOT", raising=False)
    assert tds.data_root() == jds.data_root() == "datasets"
    monkeypatch.setenv("HSIMAE_DATA_ROOT", str(tmp_path))
    for name in jds.REGISTRY:
        assert tds.get_data_path(name) == jds.get_data_path(name)
        assert tds.get_data_path(name, "x") == jds.get_data_path(name, "x")


def paviau(seed=0, h=12, w=10):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, 103)).astype(np.float64),
            rng.integers(0, 10, (h, w)).astype(np.uint8))


def assert_same_load(root, name="PaviaU"):
    ts, tg = tds.load_dataset(name, str(root))
    js, jg = jds.load_dataset(name, str(root))
    assert ts.dtype == np.float32 and tg.dtype == np.int32
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tg, jg)
    return ts, tg


def test_load_npy_layout(tmp_path):
    scene, gt = paviau()
    d = tmp_path / "PaviaU"
    d.mkdir()
    np.save(d / "data.npy", scene)
    np.save(d / "gt.npy", gt)
    ts, tg = assert_same_load(tmp_path)
    np.testing.assert_array_equal(tg, gt)


def test_load_mat_layout(tmp_path):
    scene, gt = paviau(1)
    d = tmp_path / "PaviaU"
    d.mkdir()
    scipy.io.savemat(d / "PaviaU.mat", {"paviaU": scene})
    scipy.io.savemat(d / "PaviaU_gt.mat", {"paviaU_gt": gt})
    ts, _ = assert_same_load(tmp_path)
    np.testing.assert_array_equal(ts, scene.astype(np.float32))


def test_two_cubes_raise_in_both(tmp_path):
    scene, gt = paviau(2)
    d = tmp_path / "PaviaU"
    d.mkdir()
    scipy.io.savemat(d / "a.mat", {"a": scene, "gt": gt})
    scipy.io.savemat(d / "b.mat", {"b": scene})
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError, match="exactly one 3-D cube"):
            mod.load_dataset("PaviaU", str(tmp_path))


def test_band_mismatch_raises_in_both(tmp_path):
    scene, gt = paviau(3)
    d = tmp_path / "PaviaU"
    d.mkdir()
    np.save(d / "data.npy", scene[..., :100])
    np.save(d / "gt.npy", gt)
    for mod in (tds, jds):
        with pytest.raises(AssertionError, match="expected 103 bands"):
            mod.load_dataset("PaviaU", str(tmp_path))


def test_pretrain_corpus_equal(tmp_path):
    rng = np.random.default_rng(4)
    for i in range(3):
        np.save(tmp_path / f"s{i}.npy", rng.random((5 + i, 6, 7)).astype(np.float32))
    (tmp_path / "notes.txt").write_text("not a cube")
    for limit in (None, 2):
        got = tds.load_pretrain_corpus(str(tmp_path), limit)
        want = jds.load_pretrain_corpus(str(tmp_path), limit)
        assert len(got) == len(want) == (limit or 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_dataset_flag_reaches_load_labeled_scene(tmp_path):
    scene, gt = paviau(5)
    d = tmp_path / "PaviaU"
    d.mkdir()
    np.save(d / "data.npy", scene)
    np.save(d / "gt.npy", gt)
    p = argparse.ArgumentParser()
    tcommon.add_data_args(p, labeled=True)
    args = p.parse_args(["--dataset", "PaviaU", "--data-root", str(tmp_path)])
    got_scene, got_gt = tcommon.load_labeled_scene(args)
    np.testing.assert_array_equal(got_scene, scene.astype(np.float32))
    np.testing.assert_array_equal(got_gt, gt)
    with pytest.raises(SystemExit, match="--dataset"):
        tcommon.load_labeled_scene(p.parse_args([]))

"""Port parity for the pretraining data path: the cut index
(``data/windows.py``), the synthetic pretraining corpora, the multi-scene
gather (float32 and bfloat16 storage) and the flips of
``hsimae_tpu_torch`` against ``hsimae_tpu``. Everything here is exact: the
same numpy code, the same gathers and the same float32 normalisation."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu.cli import common as jcommon
from hsimae_tpu.data import pipeline as jp
from hsimae_tpu.data import synthetic as jsyn
from hsimae_tpu.data import windows as jw
from hsimae_tpu_torch.cli import common as tcommon
from hsimae_tpu_torch.data import pipeline as tp
from hsimae_tpu_torch.data import synthetic as tsyn
from hsimae_tpu_torch.data import windows as tw


@pytest.mark.parametrize("length,size,stride", [(64, 9, 1), (64, 9, 3), (145, 9, 3), (9, 9, 3),
                                                (50, 7, 7), (31, 9, 9)])
def test_window_geometry_equal(length, size, stride):
    np.testing.assert_array_equal(tw.window_starts(length, size, stride),
                                  jw.window_starts(length, size, stride))
    np.testing.assert_array_equal(tw.patch_grid_indices(length, length + 3, size, stride),
                                  jw.patch_grid_indices(length, length + 3, size, stride))


@pytest.mark.parametrize("kw", [dict(), dict(coarse_from=1, ratio=0.5),
                                dict(norm=True, scene_ranges=[(0.1, 2.0), (0.0, 3.0), (-1.0, 1.0)])])
def test_cut_index_equal(kw):
    shapes = [(40, 33, 8), (25, 61, 8), (9, 9, 8)]
    got = tw.build_pretrain_cut_index(shapes, 9, rng=np.random.default_rng(4), **kw)
    want = jw.build_pretrain_cut_index(shapes, 9, rng=np.random.default_rng(4), **kw)
    assert len(got) == len(want)
    for f in ("locs", "scene_max", "scene_min"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype


@pytest.mark.parametrize("gen,kw", [("make_synthetic_pretrain_scenes", dict()),
                                    ("make_textured_pretrain_scenes", dict(cells_per_class=2))])
def test_pretrain_corpora_equal(gen, kw):
    got = getattr(tsyn, gen)(2, (20, 30), bands=24, seed=5, **kw)
    want = getattr(jsyn, gen)(2, (20, 30), bands=24, seed=5, **kw)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("textured", [False, True])
def test_load_pretrain_scenes_equal(textured):
    args = argparse.Namespace(synthetic=True, synthetic_texture=textured, synthetic_scenes=2,
                              synthetic_size=30, synthetic_bands=16, synthetic_seed=None, seed=3,
                              synthetic_cells_per_class=None, scenes=None)
    for a, b in zip(tcommon.load_pretrain_scenes(args), jcommon.load_pretrain_scenes(args)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(6)
    scenes = [rng.random((h, w, 16)).astype(np.float32) * 3 for h, w in ((20, 30), (35, 12), (9, 9))]
    index = jw.build_pretrain_cut_index([s.shape for s in scenes], 9, coarse_from=2,
                                        rng=np.random.default_rng(1))
    mins = np.array([0.1, 0.0, 0.5], np.float32)
    maxs = np.array([2.9, 3.0, 2.0], np.float32)
    return scenes, index.locs, mins, maxs


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_multiscene_gather_equal(corpus, storage):
    scenes, locs, mins, maxs = corpus
    sel = np.random.default_rng(2).permutation(len(locs))[:48]
    src_j = jp.MultiScenePatchSource(scenes, 9, scene_min=mins, scene_max=maxs,
                                     storage_dtype=getattr(jnp, storage))
    src_t = tp.MultiScenePatchSource(scenes, 9, scene_min=mins, scene_max=maxs,
                                     storage_dtype=getattr(torch, storage), device="cpu")
    assert src_t._flat.dtype == getattr(torch, storage)
    want = np.asarray(src_j.gather(locs[sel]))
    got = src_t.gather(locs[sel])
    assert got.dtype == torch.float32 and got.shape == (48, 9, 9, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # a window of the scene, normalised with that scene's constants
    r, c, s = locs[sel[0]]
    raw = torch.from_numpy(scenes[s][r:r + 9, c:c + 9]).to(getattr(torch, storage)).float()
    np.testing.assert_array_equal(got[0].numpy(), ((raw - mins[s]) / (maxs[s] - mins[s])).numpy())


def test_flips_equal():
    x = np.random.default_rng(3).random((16, 9, 9, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jp.augment_flips(jnp.asarray(x), key))
    kh, kv = jax.random.split(key)  # augment_flips' own draws
    fh = np.array(jax.random.bernoulli(kh, 0.5, (16,)))
    fv = np.array(jax.random.bernoulli(kv, 0.5, (16,)))
    assert (fh & fv).any() and (fh & ~fv).any() and (~fh & fv).any()
    got = tp.augment_flips(torch.from_numpy(x), flips=(torch.from_numpy(fh), torch.from_numpy(fv)))
    np.testing.assert_array_equal(got.numpy(), want)
    # horizontal flips the width axis, vertical the height axis
    i = int(np.flatnonzero(fh & ~fv)[0])
    np.testing.assert_array_equal(got[i].numpy(), x[i, :, ::-1])


def test_flip_draws_come_from_the_generator():
    x = torch.rand(32, 9, 9, 4)
    a = tp.augment_flips(x, generator=torch.Generator().manual_seed(1))
    b = tp.augment_flips(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, x)

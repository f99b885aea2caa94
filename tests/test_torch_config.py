"""Port parity: config (the presets, ``FinetuneConfig``, ``EvalConfig``,
``ProtocolConfig``), sincos tables,
SwiGLU widths and the numpy copies (GWPCA, synthetic scenes, metrics) of
``hsimae_tpu_torch`` against ``hsimae_tpu``. Everything here is exact: the
port's copies run the same numpy code on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.data import gwpca as jgwpca
from hsimae_tpu.data import synthetic as jsyn
from hsimae_tpu.models import layers as jlayers
from hsimae_tpu.models import pos_embed as jpos
from hsimae_tpu.utils import metrics as jmetrics
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.data import gwpca as tgwpca
from hsimae_tpu_torch.data import synthetic as tsyn
from hsimae_tpu_torch.models import layers as tlayers
from hsimae_tpu_torch.models import pos_embed as tpos
from hsimae_tpu_torch.utils import metrics as tmetrics

RENAMED = {"use_pallas": "use_kernel"}  # JAX name -> port name
DROPPED = set()  # every JAX field is ported
DERIVED = ("t_size", "grid_size", "l_size", "num_patches", "pixels_per_patch", "fusion_depth")
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_field_for_field(name):
    j, t = jcfg.PRESETS[name], tcfg.PRESETS[name]
    jf = {f.name for f in dataclasses.fields(j)}
    tf = {f.name for f in dataclasses.fields(t)}
    assert tf == (jf - DROPPED - set(RENAMED)) | set(RENAMED.values())
    for f in jf - DROPPED - set(RENAMED) - {"compute_dtype"}:
        assert getattr(t, f) == getattr(j, f), f
    assert DTYPES[j.compute_dtype] == t.compute_dtype
    # use_pallas is off by default in JAX; the port's use_kernel is on
    assert j.use_pallas is False and t.use_kernel is True
    for p in DERIVED:
        assert getattr(t, p) == getattr(j, p), p


@pytest.mark.parametrize("s_depth", [0, 6, 9, 12])
def test_derived_geometry_and_fusion_depth(s_depth):
    j = jcfg.preset("HSIMAE-B", s_depth=s_depth, bands=64, img_size=12)
    t = tcfg.preset("HSIMAE-B", s_depth=s_depth, bands=64, img_size=12)
    for p in DERIVED + ("num_heads", "decoder_num_heads"):
        assert getattr(t, p) == getattr(j, p), p
    assert t.fusion_depth == (0 if s_depth >= 12 else 12 - s_depth)


def test_finetune_config_field_for_field():
    j, t = jcfg.FinetuneConfig(), tcfg.FinetuneConfig()
    jf = {f.name for f in dataclasses.fields(j)}
    assert {f.name for f in dataclasses.fields(t)} == jf
    for f in jf:
        assert getattr(t, f) == getattr(j, f), f


def test_eval_config_default():
    assert tcfg.EvalConfig().batch_size == jcfg.EvalConfig().batch_size == 4096


# per config, the JAX fields the port leaves out by design: none
DROPPED_FIELDS = {}


@pytest.mark.parametrize("name", ["EvalConfig", "ProtocolConfig", "PretrainConfig", "MeshConfig"])
def test_config_field_for_field(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    jf = {f.name for f in dataclasses.fields(j)} - DROPPED_FIELDS.get(name, set())
    assert {f.name for f in dataclasses.fields(t)} == jf
    for f in jf:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("dim,t_size,grid", [(32, 4, 3), (128, 4, 3), (256, 8, 5)])
def test_sincos_3d_equal(dim, t_size, grid):
    np.testing.assert_array_equal(tpos.sincos_3d(dim, t_size, grid), jpos.sincos_3d(dim, t_size, grid))
    np.testing.assert_array_equal(tpos.sincos_2d(dim, grid), jpos.sincos_2d(dim, grid))


@pytest.mark.parametrize("dim,want", [(48, 128), (64, 172), (128, 344), (256, 684)])
def test_swiglu_hidden_dim(dim, want):
    assert tlayers.swiglu_hidden_dim(dim) == jlayers.swiglu_hidden_dim(dim) == want


@pytest.mark.parametrize("c,group", [(103, 4), (200, 4), (31, 8)])
def test_gwpca_copy_equal(c, group):
    assert tgwpca.split_band_groups(c, group) == jgwpca.split_band_groups(c, group)
    cube = np.random.default_rng(c).random((10, 12, c)).astype(np.float32)
    np.testing.assert_array_equal(tgwpca.apply_gwpca(cube, nc=2 * group, group=group),
                                  jgwpca.apply_gwpca(cube, nc=2 * group, group=group))


@pytest.mark.parametrize("gen,kw", [
    ("make_synthetic_scene", dict(bands=40, n_classes=5)),
    ("make_textured_scene", dict(bands=30, n_classes=6)),
    ("make_textured_scene", dict(bands=30, n_classes=4, cells_per_class=2)),
])
def test_synthetic_copy_equal(gen, kw):
    ts, tg = getattr(tsyn, gen)(20, 24, seed=3, **kw)
    js, jg = getattr(jsyn, gen)(20, 24, seed=3, **kw)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_copy_equal(seed):
    rng = np.random.default_rng(seed)
    c = int(rng.integers(3, 9))
    y, p = rng.integers(0, c, 400), rng.integers(0, c, 400)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(y, p, c), jmetrics.confusion_matrix(y, p, c))
    got, want = tmetrics.classification_metrics(y, p), jmetrics.classification_metrics(y, p)
    assert (got.oa, got.aa, got.kappa, got.mean3) == (want.oa, want.aa, want.kappa, want.mean3)
    np.testing.assert_array_equal(got.per_class, want.per_class)

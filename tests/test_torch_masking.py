"""Port parity for grid masking: ``hsimae_tpu_torch.models.masking`` against
``hsimae_tpu.models.masking``.

The host-side shape draws are bit-equal for the same ``random.Random`` seed.
From the rows and columns of a ``GridMask`` that JAX draws, the port builds
an equal mask and ``ids_keep``; its gather is exact and its index scatter
equals the JAX one-hot scatter within the rounding of ``(kept - fill) +
fill`` (float32: 2e-7 relative; bfloat16: one bf16 step, 2^-7 relative, of
the values involved)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu.models import masking as jm
from hsimae_tpu_torch.models import masking as tm

GRIDS = [(4, 9, 0.5), (4, 9, 0.75), (8, 25, 0.5), (13, 9, 0.8), (2, 4, 0.5)]


@pytest.mark.parametrize("t,l,ratio", GRIDS)
def test_shape_draws_bit_equal(t, l, ratio):
    assert tm.grid_shape_candidates(t, l, ratio) == jm.grid_shape_candidates(t, l, ratio)
    a, b = random.Random(11), random.Random(11)
    assert [tm.choose_grid_shape(t, l, ratio, a) for _ in range(40)] == \
        [jm.choose_grid_shape(t, l, ratio, b) for _ in range(40)]
    items = list(range(23))
    got = tm.group_by_shape(items, t, l, ratio, random.Random(5))
    want = jm.group_by_shape(items, t, l, ratio, random.Random(5))
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("len_t,len_l", [(2, 9), (3, 6), (4, 2)])
def test_mask_from_jax_ids_equal(len_t, len_l):
    gm = jm.spatial_spectral_mask(jax.random.PRNGKey(len_t * 10 + len_l), 7, 4, 9, len_t, len_l)
    got = tm.GridMask.from_ids(torch.from_numpy(np.array(gm.ids_t)),
                               torch.from_numpy(np.array(gm.ids_l)), 4, 9)
    np.testing.assert_array_equal(got.ids_keep.numpy(), np.asarray(gm.ids_keep))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(gm.mask))
    assert got.ids_keep.dtype == torch.int64 and got.mask.dtype == torch.float32


@pytest.mark.parametrize("len_t,len_l", [(2, 9), (3, 6)])
def test_port_draw_is_a_sorted_grid(len_t, len_l):
    g = torch.Generator().manual_seed(3)
    gm = tm.spatial_spectral_mask(64, 4, 9, len_t, len_l, g, "cpu")
    assert gm.ids_t.shape == (64, len_t) and gm.ids_l.shape == (64, len_l)
    for ids, size in ((gm.ids_t, 4), (gm.ids_l, 9)):
        assert (ids.diff(dim=1) > 0).all() and ids.min() >= 0 and ids.max() < size
    assert (gm.mask.sum(1) == 36 - len_t * len_l).all()
    assert (gm.mask.gather(1, gm.ids_keep) == 0).all()
    # every row and column is drawn somewhere; the same seed draws the same grid
    assert set(gm.ids_t.unique().tolist()) == set(range(4))
    again = tm.spatial_spectral_mask(64, 4, 9, len_t, len_l, torch.Generator().manual_seed(3),
                                     "cpu")
    assert torch.equal(again.ids_keep, gm.ids_keep)


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-7), ("bfloat16", 2 ** -7)])
def test_gather_and_scatter_match_jax(dtype, rtol):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    gm = jm.spatial_spectral_mask(jax.random.PRNGKey(1), 6, 4, 9, 3, 6)
    ids = np.array(gm.ids_keep)
    x = rng.standard_normal((6, 36, 16)).astype(np.float32)
    want = np.asarray(jm.gather_tokens(jnp.asarray(x, jdt), jnp.asarray(ids)).astype(jnp.float32))
    kept = tm.gather_tokens(torch.from_numpy(x).to(tdt), torch.from_numpy(ids).long())
    np.testing.assert_array_equal(kept.float().numpy(), want)

    fill = rng.standard_normal((6, 1, 16)).astype(np.float32)
    want = jm.scatter_tokens(jnp.asarray(want, jdt), jnp.asarray(ids), 36, jnp.asarray(fill, jdt))
    got = tm.scatter_tokens(kept, torch.from_numpy(ids).long(), 36, torch.from_numpy(fill).to(tdt))
    assert got.dtype == tdt and got.shape == (6, 36, 16)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.maximum(np.abs(x).max(), np.abs(fill).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=rtol * scale)
    # exact in the port: kept slots hold the kept tokens, the rest the fill
    masked = np.asarray(gm.mask, bool)
    np.testing.assert_array_equal(got.float().numpy()[masked],
                                  np.broadcast_to(torch.from_numpy(fill).to(tdt).float().numpy(),
                                                  (6, 36, 16))[masked])

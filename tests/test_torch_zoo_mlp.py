"""Port parity for the baseline zoo's permutator nets (HiT, DCTN) against
``hsimae_tpu.models.baselines``, on the CPU: the checks of
``tests/test_torch_zoo_conv.py`` (every flax leaf covered through the JAX
converter, every port key read, eval logits at 2e-4, ``from_jax_zoo`` bit
for bit, one train-mode forward and the BatchNorm statistics at 1e-5).

DCTN runs at ``tests/test_baselines.py``'s size (64 bands, one block a
stage, PaviaU's widths); it goes through the replication pad, the pooled
3-D path and the GroupNorm maps. HiT runs at the size of the reference
parity test (30 bands, widths 64): there the patch embedding's fold equals
``embed_dims[0]``, as in the reference, which has no projection between
them. At ``tests/test_baselines.py``'s size (64 bands, widths 480) the JAX
zoo adds ``embed_proj``, a layer the reference and so the JAX converter
lack; that case is held with the converter's tree plus ``embed_proj``
added by hand.

HiT's other token mixer, WeightedPermuteMLP (``use_conv_mixer=False``),
runs through the same checks at the same size and patch 15. JAX's
``convert_hit`` covers only the conv mixer, so the weighted mixer's three
Dense kernels are mapped by hand (:func:`convert_weighted_hit`). At patch 15
every stage's ``hh * s`` happens to equal the width; the mixer alone on a
non-square 5 x 7 grid and the whole net at patch 13 (and 11 x 13) hold the
widths where it does not, and catch an H / W mix-up that a square grid
hides."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu.models import baselines as jzoo
from hsimae_tpu.models.baselines import convert as jcvt
from hsimae_tpu_torch.models import baselines as tzoo
from hsimae_tpu_torch.models.baselines.convert import from_jax_zoo
from test_torch_zoo_conv import CHECKS, Case, check_train_forward, seeded_state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAYERS, TRANS = (1, 1, 1, 1), (False, True, False, False)
DCTN_DIMS, HIT_DIMS = (320, 320, 512, 512), (64, 64, 64, 64)
DCTN_KW = dict(layers=LAYERS, bands=64, num_classes=7, embed_dims=DCTN_DIMS, transitions=TRANS,
               segment_dim=(8, 8, 4, 4), mlp_ratios=(3.0, 3.0, 3.0, 3.0))
HIT_KW = dict(bands=30, num_classes=7, layers=LAYERS, embed_dims=HIT_DIMS, transitions=TRANS)


def convert_weighted_hit(sd, layers=LAYERS, transitions=TRANS, embed_dims=HIT_DIMS) -> dict:
    """Port HiT ``state_dict`` with WeightedPermuteMLP mixers -> flax
    variables: JAX's ``convert_hit`` on every other key (zeros standing in
    for the conv mixer's kernels it expects), then each block's
    ``mlp_h`` / ``mlp_w`` / ``mlp_c`` Linear weight as a Dense kernel
    (transposed), by hand."""
    rx = re.compile(r"(network\.\d+\.\d+)\.attn\.mlp_c\.weight")
    prefixes = sorted({m.group(1) for k in sd if (m := rx.fullmatch(k))},
                      key=lambda p: tuple(int(i) for i in p.split(".")[1:]))
    plain = {k: sd[k] for k in sd if ".attn.mlp_" not in k}
    dense = {k: sd[k] for k in sd if ".attn.mlp_" in k}
    for p in prefixes:
        c = dense[f"{p}.attn.mlp_c.weight"].shape[0]
        plain.update({f"{p}.attn.mlp_c.0.weight": torch.zeros(c, 1, 1, 3),
                      f"{p}.attn.mlp_h.0.weight": torch.zeros(c, 1, 3, 1),
                      f"{p}.attn.mlp_w.weight": torch.zeros(c, c, 1, 1)})
    out = jcvt.convert_hit(plain, layers, transitions, embed_dims)
    blocks = sorted((k for k in out["params"] if k.startswith("block_")),
                    key=lambda b: tuple(int(i) for i in b.split("_")[1:]))
    assert len(blocks) == len(prefixes)
    for p, blk in zip(prefixes, blocks):
        for m in ("mlp_h", "mlp_w", "mlp_c"):
            out["params"][blk]["attn"][m] = {"kernel": dense[f"{p}.attn.{m}.weight"].numpy().T}
    return out


WEIGHTED = dict(use_conv_mixer=False)
CASES = [
    Case("HiT", lambda: jzoo.HiT(**HIT_KW), lambda: tzoo.HiT(**HIT_KW),
         lambda sd: jcvt.convert_hit(sd, LAYERS, TRANS, HIT_DIMS), 15, 30),
    Case("DCTN", lambda: jzoo.DCTN(**DCTN_KW), lambda: tzoo.DCTN(**DCTN_KW),
         lambda sd: jcvt.convert_dctn(sd, LAYERS, TRANS, DCTN_DIMS), 15, 64),
    Case("HiT", lambda: jzoo.HiT(**HIT_KW, **WEIGHTED),
         lambda: tzoo.HiT(**HIT_KW, **WEIGHTED, patch_size=15), convert_weighted_hit, 15, 30),
]
CASE_IDS = ["HiT", "DCTN", "HiT-weighted"]


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_zoo_net_matches_jax(case, check):
    CHECKS[check](case)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_zoo_net_train_forward_matches_jax(case, monkeypatch):
    check_train_forward(case, monkeypatch)


def test_hit_embed_proj_at_the_zoo_test_size():
    """HiT at 64 bands, default widths: the fold (8 x 16 = 128) differs from
    480, so both packages add ``embed_proj``; the JAX converter's tree plus
    that Linear loads into flax, the logits agree, and ``from_jax_zoo`` maps
    ``embed_proj`` back."""
    kw = dict(bands=64, num_classes=7, layers=LAYERS)
    model = tzoo.HiT(**kw)
    sd = seeded_state(model)
    rest = {k: v for k, v in sd.items() if not k.startswith("embed_proj.")}
    dims = (480, 480, 512, 512)
    converted = jcvt.convert_hit(rest, LAYERS, TRANS, dims)
    converted["params"]["embed_proj"] = {"kernel": sd["embed_proj.weight"].numpy().T,
                                         "bias": sd["embed_proj.bias"].numpy()}
    x = np.random.default_rng(1).standard_normal((2, 15, 15, 64)).astype(np.float32)
    jm = jzoo.HiT(**kw)
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v, False), jnp.asarray(x))
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(converted)), "the trees differ"
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(converted, x))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    back = from_jax_zoo("HiT", converted)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def flax_weighted_mixer(model) -> dict:
    """A port ``WeightedPermuteMLP``'s weights as the flax module's params."""
    lin = lambda m: {"kernel": m.weight.detach().numpy().T,  # noqa: E731
                     **({"bias": m.bias.detach().numpy()} if m.bias is not None else {})}
    return {"mlp_h": lin(model.mlp_h), "mlp_w": lin(model.mlp_w), "mlp_c": lin(model.mlp_c),
            "reweight": {"Dense_0": lin(model.reweight.fc1), "Dense_1": lin(model.reweight.fc2)},
            "proj": lin(model.proj)}


def test_weighted_mixer_where_the_grid_differs_from_the_width():
    """Where ``hh * s`` and ``ww * s`` differ from the width:

    * the mixer alone on a 5 x 7 grid of width 64 (patch 13's 7 rows at the
      first stage, a narrower second side) at segment dims 4 and 16:
      ``mlp_h`` is ``5 s`` wide and ``mlp_w`` ``7 s``; outputs against
      flax's module at 2e-4, and the transposed grid refused;
    * the weighted HiT at patch 13 (grids 7 x 7 then 3 x 3, so ``hh * s`` is
      56 and 48 against width 64) and at 11 x 13: eval logits against
      flax's on the hand-mapped tree at 2e-4, and ``from_jax_zoo`` gives the
      port's state back bit for bit."""
    from hsimae_tpu.models.baselines.hit import WeightedPermuteMLP as JMixer
    from hsimae_tpu_torch.models.baselines.common import init_like_flax
    from hsimae_tpu_torch.models.baselines.hit import WeightedPermuteMLP

    b, hh, ww, c = 2, 5, 7, 64
    for segment_dim in (4, 16):
        s = c // segment_dim
        model = init_like_flax(WeightedPermuteMLP(c, segment_dim, hh, ww),
                               torch.Generator().manual_seed(segment_dim))
        with torch.no_grad():
            model.proj.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
        assert model.mlp_h.weight.shape == (hh * s, hh * s) and model.mlp_w.weight.shape == (
            ww * s, ww * s) and hh * s != c != ww * s
        x = np.random.default_rng(segment_dim).standard_normal((b, hh, ww, c)).astype(np.float32)
        ref = JMixer(c, segment_dim).apply({"params": flax_weighted_mixer(model)}, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=2e-4,
                                   err_msg=f"segment_dim {segment_dim}")
        with pytest.raises(ValueError, match="5x7"):
            model(torch.from_numpy(x).transpose(1, 2).contiguous())

    jm = jzoo.HiT(**HIT_KW, **WEIGHTED)
    for patch in (13, (11, 13)):
        hp, wp = (patch, patch) if isinstance(patch, int) else patch
        model = tzoo.HiT(**HIT_KW, **WEIGHTED, patch_size=patch)
        sd = seeded_state(model)
        assert model.network[0][0].attn.mlp_h.weight.shape[0] == (hp + 1) // 2 * 8
        converted = convert_weighted_hit(sd)
        x = np.random.default_rng(3).standard_normal((2, hp, wp, 30)).astype(np.float32)
        shapes = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v, False),
                                jnp.asarray(x))
        assert (jax.tree_util.tree_structure(shapes)
                == jax.tree_util.tree_structure(converted)), "the trees differ"
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, b: a.shape == b.shape, shapes, converted))
        ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(converted, x))
        model.eval()
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, err_msg=f"patch {patch}")
        back = from_jax_zoo("HiT", converted)
        assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
        tzoo.HiT(**HIT_KW, **WEIGHTED, patch_size=patch).load_state_dict(back, strict=True)


def test_adaptive_avg_pool_equals_the_jax_zoo_pooling_matrices():
    """DCTN's pooling: torch's ``adaptive_avg_pool*`` against the JAX zoo's
    per-axis pooling matrices, on sizes that divide and sizes that do not
    (overlapping bins), an axis already at its size included."""
    from hsimae_tpu.models.baselines.dctn import adaptive_avg_pool as jpool
    from hsimae_tpu_torch.models.baselines.dctn import adaptive_avg_pool as tpool

    rng = np.random.default_rng(0)
    for shape, sizes in [((2, 3, 85, 15, 15), (40, 15, 15)), ((2, 3, 46, 17, 13), (40, 15, 15)),
                         ((2, 5, 7, 7), (3, 3)), ((1, 4, 15, 15), (7, 15))]:
        x = rng.standard_normal(shape).astype(np.float32)
        axes = tuple(range(2, len(shape)))
        ref = np.asarray(jpool(jnp.asarray(x), axes, sizes))
        got = tpool(torch.from_numpy(x), sizes).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_max_pool_routing_records_and_injects():
    """DCTN's ``MaxPool2d``: plain it is ``F.max_pool2d``; ``record`` keeps
    the argmax of each window; routed through its own argmax it gives the
    same values and gradient; routed to another element of a window, that
    element takes the window's gradient and ``route_gap`` is how far it
    falls below the window's maximum."""
    from hsimae_tpu_torch.models.baselines.common import MaxPool2d

    x = torch.randn(2, 3, 7, 7, generator=torch.Generator().manual_seed(0), requires_grad=True)
    pool = MaxPool2d(2, 2)
    ref = torch.nn.functional.max_pool2d(x, 2, 2)
    assert torch.equal(pool(x), ref) and pool.last_route is None
    pool.record = True
    y = pool(x)
    route = pool.last_route
    assert torch.equal(y, ref) and route.shape == ref.shape
    (g_ref,) = torch.autograd.grad(y.sum(), x)
    pool.record, pool.route = False, route
    y = pool(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(y, ref) and torch.equal(g, g_ref) and pool.route_gap == 0.0
    flipped = route.clone()
    own = int(route[0, 0, 0, 0])
    flipped[0, 0, 0, 0] = own + 1 if own % 7 == 0 else own - 1  # the window's other column
    pool.route = flipped
    y = pool(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    other = int(flipped[0, 0, 0, 0])
    assert g[0, 0].flatten()[other] == 1 and g[0, 0].flatten()[own] == 0
    assert pool.route_gap == pytest.approx(float(x[0, 0].flatten()[own] - x[0, 0].flatten()[other]))


def test_channels_first_layout_is_contiguous():
    """The zoo's nets permute channels-last input once, into a contiguous
    channels-first tensor (no channels-last strides reach the layers)."""
    from hsimae_tpu_torch.models.baselines.common import hwc_to_chw

    x = torch.randn(2, 5, 5, 3)
    y = hwc_to_chw(x)
    assert y.is_contiguous() and torch.equal(y, x.permute(0, 3, 1, 2))

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
added by hand."""

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
CASES = [
    Case("HiT", lambda: jzoo.HiT(**HIT_KW), lambda: tzoo.HiT(**HIT_KW),
         lambda sd: jcvt.convert_hit(sd, LAYERS, TRANS, HIT_DIMS), 15, 30),
    Case("DCTN", lambda: jzoo.DCTN(**DCTN_KW), lambda: tzoo.DCTN(**DCTN_KW),
         lambda sd: jcvt.convert_dctn(sd, LAYERS, TRANS, DCTN_DIMS), 15, 64),
]


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_zoo_net_matches_jax(case, check):
    CHECKS[check](case)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
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

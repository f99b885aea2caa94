"""Port parity for the pretraining model: ``patchify``/``unpatchify``,
``mae_loss``, ``reconstruct``, ``drop_path`` and ``HSIMAE.forward_pretrain``
of ``hsimae_tpu_torch`` against ``hsimae_tpu``, with JAX weights carried
across by ``from_jax_params`` and the JAX draws (kept grid, drop-path keep
masks) injected into the port.

Models are narrow (embed 32, depth 3, s_depth 2, decoder 16 x 1, 2 heads
each). Tolerances, float32: 2e-6 for pure data movement and the loss
formula on equal inputs; 1e-5 relative on the loss and 2e-5 on pred for a
whole forward (three encoder blocks, one decoder block and the loss, each
summing in another order than XLA); gradients within 1e-4 relative plus
1e-6 of the model's largest gradient. bfloat16: 2e-2 relative on the
loss and 6e-2 on pred (a bf16 step is 2^-8 and the two stacks round at
different places)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.checkpoints.io import load_params
from hsimae_tpu.data.gwpca import apply_gwpca
from hsimae_tpu.data.synthetic import make_textured_scene
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu.models import layers as jl
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.models.layers import drop_path
from hsimae_tpu_torch.models.masking import GridMask
from hsimae_tpu_torch.ops import fused_block as tfb

SMALL = dict(embed_dim=32, num_heads=2, depth=3, s_depth=2, decoder_dim=16, decoder_num_heads=2,
             decoder_depth=1)
BANKED = "artifacts/texture/HSIMAE-B@v2@enc0@dec2x48_params_final.msgpack"


def configs(**kw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dtype = kw.pop("dtype", "float32")
    return (jcfg.preset("HSIMAE-S", **SMALL, compute_dtype=jdt[dtype], **kw),
            tcfg.preset("HSIMAE-S", **SMALL, compute_dtype=tdt[dtype], **kw))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params(jc, seed=0):
    return to_numpy(jh.init_model(jh.build_hsimae(jc), seed=seed)["params"])


def imgs(n, seed=1, bands=32, img=9):
    return np.random.default_rng(seed).random((n, img, img, bands)).astype(np.float32)


def ids_from_mask(mask, t_size, l_size):
    """Kept rows and columns of each sample's [T, L] grid (mask 0 = kept)."""
    keep = np.asarray(mask).reshape(-1, t_size, l_size) == 0
    ids_t = np.stack([np.flatnonzero(k.any(axis=1)) for k in keep])
    ids_l = np.stack([np.flatnonzero(k.any(axis=0)) for k in keep])
    return ids_t, ids_l


def pretrain_fn(jc, len_t, len_l, train):
    """``(params, x, w, key) -> forward_pretrain outputs`` of the JAX model."""
    model = jh.build_hsimae(jc)

    def f(params, x, w, key):
        km, kd = jax.random.split(key)
        return model.apply({"params": params}, x, len_t, len_l, train, w,
                           rngs={"mask": km, "droppath": kd}, method=jh.HSIMAE.forward_pretrain)

    return f


@functools.lru_cache(maxsize=None)
def jitted(jc, len_t, len_l, train):
    return jax.jit(pretrain_fn(jc, len_t, len_l, train))


def jax_forward(jc, params, x, len_t, len_l, w=None, seed=0, train=True):
    """(loss, pred, mask, (mean, std)) as numpy; ``w`` None weighs every
    sample 1, as the port's ``sample_weight=None`` does."""
    w = np.ones(len(x), np.float32) if w is None else w
    out = jitted(jc, len_t, len_l, train)(params, x, w, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, out)


def port_model(tc, params, train=True):
    model = th.build_hsimae(tc, device="cpu", state_dict=from_jax_params(params, tc))
    return model.train(train)


def grid_of(mask, tc):
    ids_t, ids_l = ids_from_mask(mask, tc.t_size, tc.l_size)
    return GridMask.from_ids(torch.from_numpy(ids_t), torch.from_numpy(ids_l),
                             tc.t_size, tc.l_size)


@pytest.fixture(scope="module")
def case():
    jc, tc = configs()
    return jc, tc, jax_params(jc)


def test_jax_pretrain_tree_loads_strict(case):
    jc, tc, params = case
    sd = from_jax_params(params, tc)
    assert {"decoder_pos_embed", "mask_token", "decoder_blocks.0.attn.q.weight"} <= set(sd)
    model = th.build_hsimae(tc, device="cpu")
    model.load_state_dict(sd, strict=True)  # raises on any missing or unexpected key
    assert model.mask_token.abs().sum() == 0


@pytest.mark.parametrize("p,u,img,bands", [(3, 8, 9, 32), (3, 4, 6, 16)])
def test_patchify_unpatchify_reconstruct_equal(p, u, img, bands):
    x = imgs(3, 2, bands, img)
    want = np.asarray(jh.patchify(jnp.asarray(x), p, u))
    got = th.patchify(torch.from_numpy(x), p, u).numpy()
    np.testing.assert_array_equal(got, want)
    grid, t = img // p, bands // u
    np.testing.assert_array_equal(th.unpatchify(torch.from_numpy(got), p, u, grid, t).numpy(), x)
    cfg_kw = dict(img_size=img, bands=bands, patch_size=p, b_patch_size=u)
    jc, tc = jcfg.preset("HSIMAE-S", **cfg_kw), tcfg.preset("HSIMAE-S", **cfg_kw)
    rng = np.random.default_rng(3)
    pred = rng.standard_normal(want.shape).astype(np.float32)
    mask = (rng.random(want.shape[:2]) < 0.5).astype(np.float32)
    mean = rng.standard_normal(want.shape[:2] + (1,)).astype(np.float32)
    std = rng.random(want.shape[:2] + (1,)).astype(np.float32) + 0.5
    jw = jh.reconstruct(jnp.asarray(pred), jnp.asarray(mask), jnp.asarray(mean),
                        jnp.asarray(std), jc)
    tw = th.reconstruct(*(torch.from_numpy(a) for a in (pred, mask, mean, std)), tc)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("norm_pix", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_mae_loss_equal(norm_pix, weighted):
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((6, 36, 72)).astype(np.float32)
    target = rng.random((6, 36, 72)).astype(np.float32)
    mask = (rng.random((6, 36)) < 0.5).astype(np.float32)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    want = jh.mae_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask), norm_pix,
                       None if w is None else jnp.asarray(w))
    got = th.mae_loss(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask),
                      norm_pix, None if w is None else torch.from_numpy(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=2e-6)


def test_mae_loss_all_weights_zero_divides_by_one():
    z = torch.zeros(2, 4, 8)
    loss, _, _ = th.mae_loss(z + 1.0, z, torch.zeros(2, 4), norm_pix=False)
    assert loss.item() == 0.0


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_with_jax_keep_masks(rate):
    x = np.random.default_rng(5).standard_normal((32, 9, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jl.drop_path(jnp.asarray(x), rate, key, True))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, (32, 1, 1))).reshape(32)
    assert 0 < keep.sum() < 32
    got = drop_path(torch.from_numpy(x), rate, torch.from_numpy(keep)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(drop_path(torch.from_numpy(x), rate, None).numpy(), x)


def test_drop_path_rates_follow_the_jax_setup():
    _, tc = configs(drop_path=0.3)
    model = th.build_hsimae(tc, device="cpu")
    dpr = np.linspace(0.0, 0.3, tc.depth)
    assert [b.drop_path_rate for b in model.blocks_1] == pytest.approx(dpr[:tc.s_depth])
    assert [b.drop_path_rate for b in model.blocks_2] == pytest.approx(dpr[:tc.s_depth])
    assert [b.drop_path_rate for b in model.blocks] == pytest.approx(dpr[tc.s_depth:])
    assert all(b.drop_path_rate == 0.0 for b in model.decoder_blocks)


@pytest.mark.parametrize("len_t,len_l", [(2, 9), (3, 6)])
def test_forward_pretrain_matches_jax(case, len_t, len_l):
    jc, tc, params = case
    x = imgs(5)
    loss, pred, mask, (mean, std) = jax_forward(jc, params, x, len_t, len_l)
    model = port_model(tc, params)
    got = model.forward_pretrain(torch.from_numpy(x), len_t, len_l, grid=grid_of(mask, tc))
    np.testing.assert_array_equal(got[2].numpy(), mask)
    np.testing.assert_allclose(got[0].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(got[1].detach().numpy(), pred, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[3][0].numpy(), mean, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got[3][1].numpy(), std, rtol=2e-6, atol=2e-6)


def test_forward_pretrain_sample_weight_matches_jax(case):
    jc, tc, params = case
    x, w = imgs(5, 8), np.array([1, 1, 1, 0, 0], np.float32)
    loss, _, mask, _ = jax_forward(jc, params, x, 2, 9, w=w, seed=3)
    got = port_model(tc, params).forward_pretrain(torch.from_numpy(x), 2, 9,
                                                  sample_weight=torch.from_numpy(w),
                                                  grid=grid_of(mask, tc))[0]
    np.testing.assert_allclose(got.item(), loss, rtol=1e-5)


def test_forward_pretrain_with_drop_path_matches_jax(case, monkeypatch):
    """drop_path 0.3: the JAX forward's own bernoulli keep masks, recorded
    in call order (blocks_1, blocks_2, fusion; attention then MLP; blocks of
    rate 0 draw nothing), go into the port's ``drop_keep``."""
    _, _, params = case  # drop-path adds no parameter
    jc, tc = configs(drop_path=0.3)
    recorded = []

    def recording(y, rate, rng, train):
        keep = jax.random.bernoulli(rng, 1.0 - rate, (y.shape[0],) + (1,) * (y.ndim - 1))
        jax.debug.callback(lambda k: recorded.append(np.array(k).reshape(-1)), keep,
                           ordered=True)
        return jnp.where(keep, y / (1.0 - rate), jnp.zeros_like(y))

    monkeypatch.setattr(jl, "drop_path", recording)
    x = imgs(5, 9)
    out = jax.jit(pretrain_fn(jc, 2, 9, True))(params, x, np.ones(5, np.float32),
                                                jax.random.PRNGKey(5))
    loss, pred, mask, _ = jax.tree_util.tree_map(np.asarray, out)
    jax.effects_barrier()
    model = port_model(tc, params)
    masks = iter(recorded)
    drop_keep = {name: [(torch.from_numpy(next(masks)), torch.from_numpy(next(masks)))
                        if b.drop_path_rate > 0 else None for b in getattr(model, name)]
                 for name in ("blocks_1", "blocks_2", "blocks")}
    assert next(masks, None) is None and len(recorded) == 2 * (1 + 1 + 1)
    assert not all(m.all() for m in recorded)  # some samples were dropped
    got = model.forward_pretrain(torch.from_numpy(x), 2, 9, grid=grid_of(mask, tc),
                                 drop_keep=drop_keep)
    np.testing.assert_allclose(got[0].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(got[1].detach().numpy(), pred, rtol=2e-5, atol=2e-5)


def gradients_agree(model, jgrads, tc):
    want = from_jax_params(to_numpy(jgrads), tc)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(jgrads))
    # the absolute floor is scaled by the largest gradient of the model:
    # some gradients are zero in exact arithmetic (the key bias: softmax
    # ignores a shift along the keys) and hold only rounding noise
    scale = max(float(np.abs(want[n].numpy()).max()) for n in names)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


_GRADS = {}


def jax_grads(case):
    """x, w, (loss, mask) and the gradient tree of one JAX forward_pretrain
    at grid (3, 6), computed once for the module."""
    if not _GRADS:
        jc, _, params = case
        x, w = imgs(5, 10), np.array([1, 1, 1, 0, 1], np.float32)
        f = pretrain_fn(jc, 3, 6, True)

        def loss_fn(p):
            loss, _, mask, _ = f(p, x, w, jax.random.PRNGKey(4))
            return loss, mask

        (loss, mask), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        _GRADS["v"] = (x, w, (float(loss), np.asarray(mask)), grads)
    return _GRADS["v"]


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax_grad(case, remat):
    """The gradient of the loss for every parameter against ``jax.grad``;
    with ``remat`` (blocks recomputed in the backward) the same loss and
    gradients."""
    jc, tc, params = case
    x, w, (jloss, mask), jgrads = jax_grads(case)
    model = port_model(tc.replace(remat=remat), params)
    loss = model.forward_pretrain(torch.from_numpy(x), 3, 6, sample_weight=torch.from_numpy(w),
                                  grid=grid_of(mask, tc))[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    gradients_agree(model, jgrads, tc)


def test_bf16_forward_pretrain_matches_jax(case):
    _, _, params = case  # the parameters stay float32
    jc, tc = configs(dtype="bfloat16")
    x = imgs(5, 11)
    loss, pred, mask, _ = jax_forward(jc, params, x, 2, 9, seed=6)
    got = port_model(tc, params).forward_pretrain(torch.from_numpy(x), 2, 9,
                                                  grid=grid_of(mask, tc))
    assert got[1].dtype == torch.bfloat16 and pred.dtype == jnp.bfloat16
    np.testing.assert_allclose(got[0].item(), loss, rtol=2e-2)
    np.testing.assert_allclose(got[1].float().detach().numpy(), pred.astype(np.float32),
                               rtol=6e-2, atol=6e-2)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_eval_forward_matches_jax_inference_path(case, use_kernel):
    """Eval mode: with ``use_kernel`` the encoder goes through the fused-block
    wrapper (its plain version on the CPU, no launch); either way the result
    equals JAX's ``train=False`` forward with ``use_pallas``."""
    jc, tc, params = case
    x = imgs(5, 12)
    loss, pred, mask, _ = jax_forward(jc.replace(use_pallas=True), params, x, 3, 6, train=False)
    model = port_model(tc.replace(use_kernel=use_kernel), params, train=False)
    before = (tfb.TF32X3_D256_LAUNCHES, tfb.TF32X3_LAUNCHES, tfb.WGMMA_LAUNCHES)
    with torch.inference_mode():
        got = model.forward_pretrain(torch.from_numpy(x), 3, 6, grid=grid_of(mask, tc))
    assert (tfb.TF32X3_D256_LAUNCHES, tfb.TF32X3_LAUNCHES, tfb.WGMMA_LAUNCHES) == before
    assert bool(model._kernel_params) == use_kernel  # the encoder stacks, never the decoder
    assert all(name in th.ENCODER_STACKS for name, _ in model._kernel_params)
    np.testing.assert_allclose(got[0].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), pred, rtol=2e-5, atol=2e-5)


def test_banked_hsimae_b_checkpoint_loss_matches_jax():
    """The banked HSIMAE-B pretrain (decoder 48 x 2), loaded through the JAX
    package's reader, on patches of a textured scene cut to 32 bands."""
    params = to_numpy(load_params(BANKED))
    kw = dict(decoder_dim=48, decoder_depth=2)
    jc, tc = jcfg.preset("HSIMAE-B", **kw), tcfg.preset("HSIMAE-B", **kw)
    scene, _ = make_textured_scene(40, 40, bands=103, seed=3)
    scene = apply_gwpca(scene, nc=32)  # as the pretraining corpus was cut to 32 bands
    rng = np.random.default_rng(13)
    starts = rng.integers(0, 40 - 9, (8, 2))
    x = np.stack([scene[r:r + 9, c:c + 9] for r, c in starts]).astype(np.float32)
    loss, pred, mask, _ = jax_forward(jc, params, x, 2, 9, seed=8)
    model = port_model(tc, params)
    got = model.forward_pretrain(torch.from_numpy(x), 2, 9, grid=grid_of(mask, tc))
    np.testing.assert_allclose(got[0].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(got[1].detach().numpy(), pred, rtol=1e-4, atol=1e-4)
    assert loss < 1.0  # trained weights reconstruct better than the mean (norm-pix loss 1)

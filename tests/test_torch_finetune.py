"""Port parity for dual-branch fine-tuning: the confusion op and metrics,
``finetune_optimizer``, ``cross_entropy_ignore0``, ``HSIMAE.forward_dual``,
``make_dual_step``, ``make_eval_metrics_step``, the epoch loop
``dual_branch_finetune`` and the fine-tune CLI of ``hsimae_tpu_torch``
against ``hsimae_tpu``, on the CPU, with JAX weights carried across by
``from_jax_params`` and JAX's draws (flips re-split from the step key, the
kept grid and drop-path keep masks recorded in call order) injected.

Models are narrow (embed 32, depth 3, s_depth 2, decoder 16 x 1, 2 heads
each; drop-path 0.2 on blocks of rate 0.1 and 0.2). Tolerances, float32:
confusion counts and the metrics derived from them exact; schedules within
1e-6 of the base rate (JAX evaluates them in float32); the CE and a whole
dual forward within 1e-5 relative (logits 2e-5); three dual steps as
``tests/test_torch_pretrain.py`` holds pretraining (losses 1e-5 relative,
parameters 1e-5 relative plus ``1e-4 * sum of the learning rates``).
bfloat16: 2e-2 relative on the loss and 6e-2 on the logits, as the bf16
pretraining forward. The loop is held to JAX's host-side choices with both
dual steps replaced by recorders: the same patches, labels, weights,
unlabeled windows, kept-grid shapes and learning rates, step by step."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.data import sampling as jsampling
from hsimae_tpu.data.pipeline import augment_flips as jax_flips
from hsimae_tpu.data.synthetic import make_synthetic_scene
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu.models import layers as jl
from hsimae_tpu.ops.metrics_ops import confusion_matrix_op as jax_cm
from hsimae_tpu.ops.metrics_ops import update_confusion as jax_update
from hsimae_tpu.parallel.mesh import make_mesh
from hsimae_tpu.train import finetune as jft
from hsimae_tpu.train import optim as jo
from hsimae_tpu.utils.metrics import classification_metrics
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints import io as tio
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.data import sampling as tsampling
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.models.masking import GridMask, spatial_spectral_mask
from hsimae_tpu_torch.ops import fused_block as tfb
from hsimae_tpu_torch.ops import metrics_ops as tops
from hsimae_tpu_torch.train import finetune as tft
from hsimae_tpu_torch.train import optim as to
from hsimae_tpu_torch.utils import metrics as tmetrics

SMALL = dict(embed_dim=32, num_heads=2, depth=3, s_depth=2, decoder_dim=16, decoder_num_heads=2,
             decoder_depth=1)
NC = 5  # classes, background included
DROP = 0.2
STACKS = ("blocks_1", "blocks_2", "blocks")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the fast tier runs six
    pytest workers on the machine's cores, and torch's default pool (a
    thread per core in each worker) oversubscribes them. Restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dtype = kw.pop("dtype", "float32")
    return (jcfg.preset("HSIMAE-S", **SMALL, compute_dtype=jdt[dtype], **kw),
            tcfg.preset("HSIMAE-S", **SMALL, compute_dtype=tdt[dtype], **kw))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def imgs(n, seed, bands=32, img=9):
    return np.random.default_rng(seed).random((n, img, img, bands)).astype(np.float32)


def ids_from_mask(mask, t_size, l_size):
    keep = np.asarray(mask).reshape(-1, t_size, l_size) == 0
    return (np.stack([np.flatnonzero(k.any(axis=1)) for k in keep]),
            np.stack([np.flatnonzero(k.any(axis=0)) for k in keep]))


def grid_of(mask, tc):
    ids_t, ids_l = ids_from_mask(mask, tc.t_size, tc.l_size)
    return GridMask.from_ids(torch.from_numpy(ids_t), torch.from_numpy(ids_l),
                             tc.t_size, tc.l_size)


@pytest.fixture(scope="module")
def case():
    jc, tc = configs()
    params = to_numpy(jh.init_model(jh.build_dual_vit(jc, NC, drop_path=DROP), seed=0)["params"])
    return jc, tc, params


def port_model(tc, params, drop_path=DROP):
    return th.build_dual_vit(tc, NC, drop_path=drop_path, device="cpu",
                             state_dict=from_jax_params(params, tc))


def keep_tree(model, masks):
    """The port's drop-path masks of one encode from JAX's, in call order."""
    return {name: [(torch.from_numpy(next(masks)), torch.from_numpy(next(masks)))
                   if b.drop_path_rate > 0 else None for b in getattr(model, name)]
            for name in STACKS}


def jax_dual_draws(jc, params, x, xu, len_t, len_l, w, km, kd, monkeypatch):
    """One JAX ``forward_dual`` (training) with rngs ``{mask: km, droppath:
    kd}`` -> (loss_rec, logits, mask, drop-path masks in call order). The
    same rngs give the same draws inside ``make_dual_step``."""
    recorded, grids = [], []
    orig_mask = jh.spatial_spectral_mask

    def recording_drop_path(y, rate, rng, train):
        keep = jax.random.bernoulli(rng, 1.0 - rate, (y.shape[0],) + (1,) * (y.ndim - 1))
        jax.debug.callback(lambda k: recorded.append(np.array(k).reshape(-1)), keep,
                           ordered=True)
        return jnp.where(keep, y / (1.0 - rate), jnp.zeros_like(y))

    def recording_mask(key, *shape):
        gm = orig_mask(key, *shape)
        jax.debug.callback(lambda m: grids.append(np.array(m)), gm.mask, ordered=True)
        return gm

    model = jh.build_dual_vit(jc, NC, drop_path=DROP)
    with monkeypatch.context() as m:
        m.setattr(jl, "drop_path", recording_drop_path)
        m.setattr(jh, "spatial_spectral_mask", recording_mask)
        out = jax.jit(lambda p: model.apply(
            {"params": p}, x, xu, len_t, len_l, True, w, rngs={"mask": km, "droppath": kd},
            method=jh.HSIMAE.forward_dual))(params)
        loss_rec, logits = to_numpy(out)
        jax.effects_barrier()
    assert len(grids) == 1
    return loss_rec, logits, grids[0], recorded


# ------------------------------ metrics ------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_confusion_matrix_op_matches_jax(weighted):
    rng = np.random.default_rng(3)
    y, p = rng.integers(0, 7, 300), rng.integers(0, 7, 300)
    w = (rng.random(300) < 0.7).astype(np.float32) if weighted else None
    want = np.asarray(jax_cm(jnp.asarray(y), jnp.asarray(p), 7,
                             None if w is None else jnp.asarray(w)))
    tw = None if w is None else torch.from_numpy(w)
    got = tops.confusion_matrix_op(torch.from_numpy(y), torch.from_numpy(p), 7, tw)
    assert got.dtype == torch.float32 and got.shape == (7, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    again = tops.update_confusion(got, torch.from_numpy(y), torch.from_numpy(p), tw)
    np.testing.assert_array_equal(again.numpy(), np.asarray(jax_update(
        jnp.asarray(want), jnp.asarray(y), jnp.asarray(p), None if w is None else jnp.asarray(w))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raw_confusion_metrics_equal_the_host_path(seed):
    """Background rows left out, background predictions an always-wrong
    bucket: the same numbers as the per-sample host path."""
    rng = np.random.default_rng(seed)
    c = int(rng.integers(3, 9))
    y, p = rng.integers(0, c, 500), rng.integers(0, c, 500)
    cm = tops.confusion_matrix_op(torch.from_numpy(y), torch.from_numpy(p), c).numpy()
    got = tmetrics.metrics_from_raw_confusion(cm)
    want = classification_metrics(y, p)
    assert (got.oa, got.aa, got.kappa) == pytest.approx((want.oa, want.aa, want.kappa), rel=1e-12)
    np.testing.assert_allclose(got.per_class[:len(want.per_class)], want.per_class, rtol=1e-12)
    from hsimae_tpu.utils.metrics import metrics_from_raw_confusion as jax_raw

    j = jax_raw(cm)
    assert (got.oa, got.aa, got.kappa) == (j.oa, j.aa, j.kappa)
    np.testing.assert_array_equal(got.per_class, j.per_class)


# ------------------------------ optimizer ----------------------------------


@pytest.mark.parametrize("epochs,spe", [(3, 3), (20, 4)])
def test_finetune_schedule_matches_jax(epochs, spe):
    _, want = jo.finetune_optimizer(1e-3, 5e-3, epochs, spe)
    opt, got = to.finetune_optimizer(torch.nn.Linear(2, 2), 1e-3, 5e-3, epochs, spe)
    ts = np.arange(epochs * spe)
    np.testing.assert_allclose([got(t) for t in ts], np.asarray(want(ts)), rtol=0, atol=1e-6 * 1e-3)
    assert got(0) == got(2 * spe - 1) == pytest.approx(1e-5)  # epochs 0 and 1 at lr * 0.01
    assert (opt.b1, opt.b2) == (0.9, 0.999) and len(opt.param_groups) == 2


def test_encoder_lr_scale_zero_trains_only_the_head(case):
    _, tc, params = case
    model = port_model(tc, params)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt, sched = to.finetune_optimizer(model, 1e-2, 1e-3, epochs=2, steps_per_epoch=2,
                                       encoder_lr_scale=0.0)
    rates = {g["lr_scale"] for g in opt.param_groups}
    assert rates == {0.0, 1.0} and len(opt.param_groups) == 4
    step = tft.make_dual_step(model, opt, sched, lamda=10.0)
    x, xu = torch.from_numpy(imgs(6, 1)), torch.from_numpy(imgs(4, 2))
    y, w = torch.tensor([1, 2, 3, 4, 1, 2]), torch.ones(6)
    for _ in range(3):
        step(x, y, w, xu, 2, 4)
    for name, p in model.named_parameters():
        if name.startswith("cls_head."):
            assert not torch.equal(p, before[name]), name
        else:
            assert torch.equal(p, before[name]), name


# ------------------------------ losses -------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_ignore0_matches_jax(weighted):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((12, NC)).astype(np.float32) * 3
    y = rng.integers(0, NC, 12)
    w = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0], np.float32) if weighted else None
    want = float(jft.cross_entropy_ignore0(jnp.asarray(logits), jnp.asarray(y),
                                           None if w is None else jnp.asarray(w)))
    got = tft.cross_entropy_ignore0(torch.from_numpy(logits), torch.from_numpy(y),
                                    None if w is None else torch.from_numpy(w)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    zero = tft.cross_entropy_ignore0(torch.from_numpy(logits), torch.zeros(12, dtype=torch.int64))
    assert zero.item() == 0.0  # every row ignored: divided by 1


# ------------------------------ model --------------------------------------


def test_jax_dual_vit_tree_loads_strict(case):
    _, tc, params = case
    sd = from_jax_params(params, tc)
    assert {"cls_head.weight", "decoder_pos_embed", "mask_token"} <= set(sd)
    model = th.build_dual_vit(tc, NC, device="cpu")
    model.load_state_dict(sd, strict=True)  # raises on any missing or unexpected key
    assert model.training and model.cfg.drop_path == DROP


def test_partial_restore_of_a_pretrain_leaves_the_head_at_init(case):
    _, tc, _ = case
    pre = th.build_hsimae(tc, seed=4, device="cpu").state_dict()
    model = th.build_dual_vit(tc, NC, seed=5, device="cpu")
    head = model.cls_head.weight.detach().clone()
    loaded, skipped = tio.partial_restore(model, {**pre, "extra.weight": torch.zeros(2)})
    assert set(loaded) == set(pre) and skipped == ["extra.weight"]
    assert torch.equal(model.cls_head.weight, head)
    for k, v in pre.items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_dual_matches_jax(case, dtype, monkeypatch):
    """Training mode with drop-path: JAX's kept grid and keep masks (the
    classification encode's, then the masked encode's) go into the port."""
    _, _, params = case
    jc, tc = configs(dtype=dtype)
    x, xu, w = imgs(5, 3), imgs(4, 4), np.array([1, 1, 1, 1, 0], np.float32)
    km, kd = jax.random.split(jax.random.PRNGKey(11))
    loss_rec, logits, mask, recorded = jax_dual_draws(jc, params, x, xu, 2, 4, w, km, kd,
                                                      monkeypatch)
    model = port_model(tc, params)
    masks = iter(recorded)
    keep_cls, keep_rec = keep_tree(model, masks), keep_tree(model, masks)
    assert next(masks, None) is None and len(recorded) == 2 * 2 * 3
    assert keep_cls["blocks_1"][1][0].shape == (5 * 4,) and keep_rec["blocks"][0][0].shape == (9,)
    assert not all(m.all() for m in recorded)  # some samples were dropped
    got_rec, got_logits = model.forward_dual(torch.from_numpy(x), torch.from_numpy(xu), 2, 4,
                                             torch.from_numpy(w), grid_of(mask, tc),
                                             keep_cls, keep_rec)
    if dtype == "float32":
        np.testing.assert_allclose(got_rec.item(), loss_rec, rtol=1e-5)
        np.testing.assert_allclose(got_logits.detach().numpy(), logits, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got_rec.item(), loss_rec, rtol=2e-2)
        np.testing.assert_allclose(got_logits.detach().numpy(), logits, rtol=6e-2, atol=6e-2)


def test_padded_labeled_rows_change_neither_loss(case):
    """Two padded rows (label 0, weight 0) between the labeled and the
    unlabeled batch, on the same kept grid for every real row: the MAE and
    the CE loss equal the batch without them."""
    _, tc, params = case
    model = port_model(tc, params, drop_path=0.0)
    x, xu = torch.from_numpy(imgs(4, 5)), torch.from_numpy(imgs(3, 6))
    y = torch.tensor([1, 2, 3, 4])
    grid = spatial_spectral_mask(7, tc.t_size, tc.l_size, 2, 4,
                                    torch.Generator().manual_seed(0), "cpu")
    rows = torch.tensor([0, 1, 2, 3, 0, 1, 4, 5, 6])  # pad rows repeat 0 and 1
    padded = GridMask(*(t[rows] for t in grid))
    rec, logits = model.forward_dual(x, xu, 2, 4, torch.ones(4), grid)
    rec_p, logits_p = model.forward_dual(torch.cat([x, x[:2]]), xu, 2, 4,
                                         torch.tensor([1.0, 1, 1, 1, 0, 0]), padded)
    np.testing.assert_allclose(rec_p.item(), rec.item(), rtol=1e-6)
    ce = tft.cross_entropy_ignore0(logits, y, torch.ones(4))
    ce_p = tft.cross_entropy_ignore0(logits_p, torch.cat([y, torch.zeros(2, dtype=y.dtype)]),
                                     torch.tensor([1.0, 1, 1, 1, 0, 0]))
    np.testing.assert_allclose(ce_p.item(), ce.item(), rtol=1e-6)


# ------------------------------ steps --------------------------------------


def test_three_dual_steps_track_jax(case, monkeypatch):
    jc, tc, params = case
    lr, wd, epochs, spe = 1e-3, 5e-3, 3, 1
    jm = jh.build_dual_vit(jc, NC, drop_path=DROP)
    tx, jsched = jo.finetune_optimizer(lr, wd, epochs, spe)
    state = jft.TrainState.create(apply_fn=jm.apply, params=jax.tree_util.tree_map(
        jnp.asarray, params), tx=tx)
    step_j = jft.make_dual_step(jm, 10.0)
    model = port_model(tc, params)
    opt, sched = to.finetune_optimizer(model, lr, wd, epochs, spe)
    step_t = tft.make_dual_step(model, opt, sched, 10.0)

    n, n_u = 6, 5
    y = np.array([1, 2, 3, 4, 0, 0])  # a padded tail
    w = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for k, (lt, ll) in enumerate([(2, 4), (4, 2), (2, 4)]):
        x, xu = imgs(n, 20 + k), imgs(n_u, 30 + k)
        key = jax.random.PRNGKey(100 + k)
        kf, ku, km, kd = jax.random.split(key, 4)  # make_dual_step's own split

        def flips(kk, m):  # augment_flips' own split and draws
            kh, kv = jax.random.split(kk)
            return tuple(torch.from_numpy(np.array(jax.random.bernoulli(q, 0.5, (m,))))
                         for q in (kh, kv))

        fx = np.asarray(jax_flips(jnp.asarray(x), kf))
        fxu = np.asarray(jax_flips(jnp.asarray(xu), ku))
        _, _, mask, recorded = jax_dual_draws(jc, params, fx, fxu, lt, ll, w, km, kd, monkeypatch)
        masks = iter(recorded)
        draws = tft.DualDraws(flips(kf, n), flips(ku, n_u), grid_of(mask, tc),
                              keep_tree(model, masks), keep_tree(model, masks))
        state, jloss, jrec, jlogits = step_j(state, jnp.asarray(x), jnp.asarray(y),
                                             jnp.asarray(w), jnp.asarray(xu),
                                             jnp.ones(n_u, jnp.float32), key, lt, ll)
        loss, rec, logits = step_t(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
                                   torch.from_numpy(xu), lt, ll, draws=draws)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(rec.item(), float(jrec), rtol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=2e-5)
    assert opt.count == int(state.step) == 3
    lrs = [sched(k) for k in range(3)]
    np.testing.assert_allclose(lrs, np.asarray(jsched(np.arange(3))), rtol=1e-6)
    want = from_jax_params(to_numpy(state.params), tc)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-4 * sum(lrs), err_msg=name)


def test_dual_step_draws_follow_seed_and_step(case):
    _, tc, params = case
    x, xu = torch.from_numpy(imgs(4, 7)), torch.from_numpy(imgs(3, 8))
    y, w = torch.tensor([1, 2, 3, 4]), torch.ones(4)
    losses = []
    for seed in (5, 5, 6):
        model = port_model(tc, params)
        opt, sched = to.finetune_optimizer(model, 1e-3, 5e-3, 2, 2)
        step = tft.make_dual_step(model, opt, sched, 10.0, seed=seed)
        losses.append([step(x, y, w, xu, 2, 4)[0].item() for _ in range(2)])
    assert losses[0] == losses[1] and losses[0] != losses[2]
    d = tft.draw_dual(model, 4, 3, 2, 4, torch.Generator().manual_seed(0), "cpu")
    assert d.flips[0].shape == (4,) and d.flips_u[0].shape == (3,)
    assert d.grid.mask.shape == (7, tc.num_patches)
    assert d.drop_keep_cls["blocks_1"][1][0].shape == (4 * tc.t_size,)
    assert d.drop_keep_rec["blocks_2"][1][0].shape == (7 * 4,)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_route", "block_modules"])
def test_eval_metrics_step_matches_jax(case, use_kernel):
    jc, tc, params = case
    x = imgs(9, 12)
    y = np.array([1, 2, 3, 4, 1, 2, 0, 3, 4])
    w = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    jev = jft.make_eval_metrics_step(jh.build_dual_vit(jc.replace(use_pallas=use_kernel), NC), NC)
    want = to_numpy(jev(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    model = port_model(tc.replace(use_kernel=use_kernel), params)
    before = (tfb.TF32X3_D256_LAUNCHES, tfb.TF32X3_LAUNCHES, tfb.WGMMA_LAUNCHES)
    cm, ce, cnt = tft.make_eval_metrics_step(model, NC)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    assert (tfb.TF32X3_D256_LAUNCHES, tfb.TF32X3_LAUNCHES, tfb.WGMMA_LAUNCHES) == before
    assert not model.training and bool(model._kernel_params) == use_kernel
    np.testing.assert_array_equal(cm.numpy(), want[0])
    np.testing.assert_allclose(ce.item(), want[1], rtol=1e-5)
    assert cnt.item() == want[2] == 6.0


def test_steps_switch_modes_and_validation_repacks(case):
    """A dual step trains the Block modules (no kernel weights are built),
    the eval step runs the kernel route in eval mode, and after the next
    update the kernel weights are rebuilt."""
    _, tc, params = case
    model = port_model(tc, params)
    opt, sched = to.finetune_optimizer(model, 1e-3, 5e-3, 2, 2)
    step = tft.make_dual_step(model, opt, sched, 10.0)
    ev = tft.make_eval_metrics_step(model, NC)
    x, xu = torch.from_numpy(imgs(4, 13)), torch.from_numpy(imgs(3, 14))
    y, w = torch.tensor([1, 2, 3, 4]), torch.ones(4)
    step(x, y, w, xu, 2, 4)
    assert model.training and model._kernel_params == {}
    ev(x, y, w)
    first = model.kernel_params("blocks_1")
    step(x, y, w, xu, 4, 2)
    assert model.training
    ev(x, y, w)
    assert not model.training and model.kernel_params("blocks_1")[0].wq is not first[0].wq


# ------------------------------ the loop -----------------------------------


@pytest.fixture(scope="module")
def split():
    scene, gt = make_synthetic_scene(40, 37, bands=40, n_classes=NC - 1, seed=3)
    return scene, gt


def test_loop_feeds_the_step_what_jax_feeds_it(case, split, monkeypatch):
    """Two epochs of both loops with their dual steps replaced by recorders
    (the weights stay put, so both validation passes score the same
    weights): per step the same labeled patches, labels, weights,
    unlabeled windows, kept-grid shape and learning rate; then the same
    validation curves."""
    jc, tc, params = case
    scene, gt = split
    ft_kw = dict(epochs=2, batch_size=8, mask_ratio=0.8, drop_path=DROP, seed=9)
    js = jsampling.dual_scene_split(scene, gt, 9, num=6, nc=32, rng=np.random.default_rng(1))
    ts = tsampling.dual_scene_split(scene, gt, 9, num=6, nc=32, rng=np.random.default_rng(1))
    jrec, trec = [], []

    def jax_recorder(model, lamda, flip):
        def step(state, x, y, w, x_u, w_u, rng, len_t, len_l):
            jrec.append((np.asarray(x), np.asarray(y), np.asarray(w), np.asarray(x_u),
                         (len_t, len_l), int(state.step)))
            return (state.replace(step=state.step + 1), jnp.float32(0), jnp.float32(0),
                    jnp.zeros((x.shape[0], NC), jnp.float32))
        return step

    def port_recorder(model, optimizer, sched, lamda, flip_augment=True, seed=0, mesh=None):
        assert mesh is None  # one process: the loop runs without a mesh

        def step(x, y, w, x_u, len_t, len_l, draws=None):
            trec.append((x.numpy(), y.numpy(), w.numpy(), x_u.numpy(), (len_t, len_l),
                         sched(optimizer.count)))
            optimizer.count += 1
            z = torch.zeros(())
            return z, z, torch.zeros(x.shape[0], NC)
        return step

    monkeypatch.setattr(jft, "_cached_dual_step", jax_recorder)
    monkeypatch.setattr(tft, "make_dual_step", port_recorder)
    jres = jft.dual_branch_finetune(js, jc, jcfg.FinetuneConfig(**ft_kw), pretrained=params,
                                    mesh=make_mesh(data=1))
    tres = tft.dual_branch_finetune(ts, tc, tcfg.FinetuneConfig(**ft_kw),
                                    pretrained=from_jax_params(params, tc), device="cpu")

    n_tr = len(jsampling.train_val_split(js.labeled_index, js.labels, 0.5,
                                         rng=np.random.default_rng(9))[0])
    spe = int(np.ceil(n_tr / 8))
    assert len(trec) == len(jrec) == 2 * spe
    _, jsched = jo.finetune_optimizer(1e-3, 5e-3, 2, spe)
    shapes = set()
    for (tx, ty, tw, txu, tshape, tlr), (jx, jy, jw, jxu, jshape, jstep) in zip(trec, jrec):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(txu, jxu)
        assert tshape == jshape
        np.testing.assert_allclose(tlr, float(jsched(jstep)), rtol=1e-6)
        shapes.add(tshape)
    assert len(shapes) == 2 and any((r[2] == 0).any() for r in jrec)  # both grids; padding
    for k in ("val_oa", "val_aa", "val_kappa", "val_epoch", "train_aa", "loss", "loss_rec"):
        assert tres.history[k] == jres.history[k], k
    np.testing.assert_allclose(tres.history["val_loss"], jres.history["val_loss"], rtol=1e-5)
    assert tres.num_classes == jres.num_classes == NC


def test_cli_finetune_on_cpu(tmp_path):
    """A port pretrain state dict in, fine-tuned weights, the scene's test
    metrics and its colormaps out."""
    from hsimae_tpu_torch.cli import finetune as cli

    mcfg = tcfg.preset("HSIMAE-S", compute_dtype=torch.float32)
    pre = str(tmp_path / "params_final.pt")
    tio.save_params(pre, th.build_hsimae(mcfg, seed=2, device="cpu"))
    argv = ["--synthetic", "--synthetic-size", "24", "--synthetic-bands", "40",
            "--synthetic-classes", "4", "--model", "HSIMAE-S", "--no-bf16", "--epochs", "2",
            "--samples-per-class", "5", "--batch-size", "8", "--device", "cpu",
            "--eval-every", "2", "--seed", "1"]
    res, ev = cli.main(argv + ["--pretrained", pre, "--eval", "--workdir", str(tmp_path / "ft")])
    assert {"finetuned.pt", "train_log.npy", "train.jsonl", "scene_pred.png",
            "scene_pred_masked.png"} <= set(os.listdir(tmp_path / "ft"))
    assert res.history["val_epoch"] == [1] and len(res.history["loss"]) == 2
    assert np.isfinite(res.history["loss"]).all() and np.isfinite(res.history["val_loss"]).all()
    assert ev.pred_map.shape == (24, 24) and ev.pred_map.min() >= 1
    assert 0.0 <= ev.metrics.oa <= 1.0 and res.params["cls_head.weight"].shape[0] == 5
    sd = torch.load(tmp_path / "ft" / "finetuned.pt", weights_only=True)
    th.build_dual_vit(mcfg, 5, device="cpu", state_dict=sd)  # loads strictly

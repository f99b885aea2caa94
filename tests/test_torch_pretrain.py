"""Port parity for the pretraining loop: ``make_pretrain_step``,
``run_pretraining``, the checkpoints and the pretrain CLI of
``hsimae_tpu_torch`` against ``hsimae_tpu``, on the CPU.

* Three steps of the port from the same init, batches and draws as three
  steps of the JAX ``make_pretrain_step`` (flips from its own key, the kept
  grid read back from its mask): losses within 1e-5 relative, parameters
  within 1e-5 relative plus ``1e-4 * sum of the learning rates``. Adam
  divides each gradient by its own running size, so a gradient that is
  zero in exact arithmetic (the key bias) moves its parameter by its
  rounding noise over ``sqrt(nu) + eps``; eps keeps that far below the
  rate.
* The padded tail with weight 0 gives the loss and gradients of the batch
  without those rows (1e-6 relative).
* A run stopped after two epochs and resumed equals an uninterrupted run
  (rtol 1e-5, as ``tests/test_resume.py`` holds the JAX loop).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.data.pipeline import augment_flips as jax_flips
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu.train import pretrain as jpt
from hsimae_tpu.train.optim import pretrain_optimizer as jax_optimizer
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints import io as tio
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.data.gwpca import apply_gwpca
from hsimae_tpu_torch.data.pipeline import MultiScenePatchSource
from hsimae_tpu_torch.data.synthetic import make_synthetic_pretrain_scenes
from hsimae_tpu_torch.data.windows import build_pretrain_cut_index
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.models.masking import GridMask
from hsimae_tpu_torch.train import pretrain as tpt
from hsimae_tpu_torch.train.optim import pretrain_optimizer

TINY = dict(depth=2, s_depth=1, decoder_depth=1, embed_dim=32, num_heads=2, decoder_dim=16,
            decoder_num_heads=2)
LR, WD, TOTAL = 1e-3, 0.05, 10


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ids_from_mask(mask, t_size, l_size):
    keep = np.asarray(mask).reshape(-1, t_size, l_size) == 0
    return (np.stack([np.flatnonzero(k.any(axis=1)) for k in keep]),
            np.stack([np.flatnonzero(k.any(axis=0)) for k in keep]))


def test_three_steps_track_jax():
    jc, tc = jcfg.preset("HSIMAE-S", **TINY), tcfg.preset("HSIMAE-S", **TINY)
    jm = jh.build_hsimae(jc)
    params = jh.init_model(jm, seed=0)["params"]
    tx, jsched = jax_optimizer(LR, WD, TOTAL)
    state = jpt.TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    model = th.build_hsimae(tc, device="cpu", state_dict=from_jax_params(to_numpy(params), tc))
    opt, sched = pretrain_optimizer(model, LR, WD, TOTAL)
    step_t = tpt.make_pretrain_step(model, opt, sched)
    step_j = jpt.make_pretrain_step(jm)  # jitted, donates the state
    mask_of = jax.jit(lambda x, km, kd: jm.apply(
        {"params": params}, x, 3, 6, True, rngs={"mask": km, "droppath": kd},
        method=jh.HSIMAE.forward_pretrain)[2])

    rng = np.random.default_rng(0)
    for k in range(3):
        x = rng.random((8, 9, 9, 32)).astype(np.float32)
        key = jax.random.PRNGKey(100 + k)
        kf, km, kd = jax.random.split(key, 3)  # make_pretrain_step's own split
        kh, kv = jax.random.split(kf)  # augment_flips' own split
        fh = np.array(jax.random.bernoulli(kh, 0.5, (8,)))
        fv = np.array(jax.random.bernoulli(kv, 0.5, (8,)))
        mask = mask_of(jax_flips(jnp.asarray(x), kf), km, kd)
        ids_t, ids_l = ids_from_mask(mask, tc.t_size, tc.l_size)
        draws = tpt.PretrainDraws(
            (torch.from_numpy(fh), torch.from_numpy(fv)),
            GridMask.from_ids(torch.from_numpy(ids_t), torch.from_numpy(ids_l), tc.t_size,
                              tc.l_size), None)
        state, jloss = step_j(state, jnp.asarray(x), key, 3, 6)
        loss = step_t(torch.from_numpy(x), 3, 6, draws=draws)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert opt.count == int(state.step) == 3
    want = from_jax_params(to_numpy(state.params), tc)
    lrs = sum(sched(k) for k in range(3))
    assert lrs > 0 and sched(0) == sched(1) == 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-4 * lrs, err_msg=name)


def constant_lr(k):
    return LR


def small_model(seed=0, **kw):
    tc = tcfg.preset("HSIMAE-S", **TINY, **kw)
    model = th.build_hsimae(tc, seed=seed, device="cpu")
    opt, _ = pretrain_optimizer(model, LR, WD, TOTAL)
    return model, opt


def test_padded_tail_equals_dropping_the_rows():
    x = torch.rand(6, 9, 9, 32, generator=torch.Generator().manual_seed(1))
    w = torch.tensor([1.0, 1, 1, 1, 0, 0])
    full, opt_a = small_model()
    part, opt_b = small_model()
    draws = tpt.draw_pretrain(full, 6, 2, 9, torch.Generator().manual_seed(2), "cpu")
    head = tpt.PretrainDraws(tuple(f[:4] for f in draws.flips),
                             GridMask(*(t[:4] for t in draws.grid)), None)
    a = tpt.make_pretrain_step(full, opt_a, constant_lr)(x, 2, 9, w=w, draws=draws)
    b = tpt.make_pretrain_step(part, opt_b, constant_lr)(x[:4], 2, 9, draws=head)
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)
    for (name, p), q in zip(full.named_parameters(), part.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-6, atol=1e-9, msg=name)


def test_step_draws_follow_seed_and_step():
    """Without injected draws the step draws from (seed, updates applied):
    two runs from one init agree; another seed draws another grid."""
    x = torch.rand(8, 9, 9, 32, generator=torch.Generator().manual_seed(3))
    losses = []
    for seed in (5, 5, 6):
        model, opt = small_model(drop_path=0.2)
        step = tpt.make_pretrain_step(model, opt, constant_lr, seed=seed)
        losses.append([step(x, 2, 9).item() for _ in range(2)])
    assert losses[0] == losses[1] and losses[0] != losses[2]
    g = tpt.step_generator(5, 1, "cpu")
    a = tpt.draw_pretrain(model, 8, 2, 9, g, "cpu")
    assert a.drop_keep is not None and a.drop_keep["blocks_1"][0] is None  # rate 0 at block 0
    assert a.drop_keep["blocks"][0][0].shape == (8,)


def test_train_step_builds_no_kernel_pack_and_eval_repacks():
    model, opt = small_model()
    x = torch.rand(4, 9, 9, 32)
    step = tpt.make_pretrain_step(model, opt, constant_lr)
    step(x, 2, 9)
    assert model._kernel_params == {}  # training runs the Block modules only
    model.eval()
    with torch.no_grad():
        model.forward_pretrain(x, 2, 9, generator=torch.Generator().manual_seed(0))
    first = model.kernel_params("blocks_1")
    step(x, 2, 9)  # the optimizer updates the weights in place
    assert model.kernel_params("blocks_1")[0].wq is not first[0].wq


@pytest.fixture(scope="module")
def corpus():
    scenes = [apply_gwpca(s, 32) for s in
              make_synthetic_pretrain_scenes(2, (30, 40), bands=48, seed=3)]
    src = MultiScenePatchSource(scenes, patch_size=9, device="cpu")
    idx = build_pretrain_cut_index([s.shape for s in scenes], 9, coarse_from=1)
    return src, idx.locs


def test_resume_equals_uninterrupted(tmp_path, corpus):
    src, locs = corpus
    mcfg = tcfg.preset("HSIMAE-S", **TINY)
    cfg = tcfg.PretrainConfig(epochs=3, batch_size=32, log_every=10**9, checkpoint_every_steps=1)
    full, hist_full = tpt.run_pretraining(src, locs, mcfg, cfg, resume=False, device="cpu")
    wd = str(tmp_path)
    tpt.run_pretraining(src, locs, mcfg, cfg, workdir=wd, resume=False, stop_after_epochs=2,
                        device="cpu")
    res, hist_res = tpt.run_pretraining(src, locs, mcfg, cfg, workdir=wd, resume=True,
                                        device="cpu")
    assert len(hist_full["epoch_loss"]) == 3 and len(hist_res["epoch_loss"]) == 1
    np.testing.assert_allclose(hist_res["epoch_loss"][0], hist_full["epoch_loss"][2], rtol=1e-5)
    for (name, a), b in zip(full.state_dict().items(), res.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    steps_per_epoch = int(np.ceil(len(locs) / 32))
    assert tio.latest_checkpoint(wd).endswith(f"ckpt_{3 * steps_per_epoch}.pt")
    log = np.load(os.path.join(wd, "train_log.npy"), allow_pickle=True)
    assert list(log[0]) == hist_res["epoch_loss"]


def test_checkpoint_files_and_restore(tmp_path):
    model, opt = small_model()
    opt = pretrain_optimizer(model, LR, WD, TOTAL, mu_dtype=torch.bfloat16)[0]
    step = tpt.make_pretrain_step(model, opt, constant_lr)
    step(torch.rand(4, 9, 9, 32), 2, 9)
    for s in (3, 12):
        tio.save_checkpoint(str(tmp_path), s, model, opt, metadata={"note": "x"})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_12.pt", "ckpt_12.pt.json", "ckpt_3.pt",
                                            "ckpt_3.pt.json"]  # no temporary file is left
    path = tio.latest_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_12.pt")
    assert json.load(open(path + ".json")) == {"step": 12, "note": "x"}
    other, _ = small_model(seed=9)
    other_opt = pretrain_optimizer(other, LR, WD, TOTAL, mu_dtype=torch.bfloat16)[0]
    assert tio.restore_checkpoint(path, other, other_opt) == 12
    assert other_opt.count == 1 and other_opt.mu[0][0].dtype == torch.bfloat16
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    tio.save_params(str(tmp_path / "final" / "params_final.pt"), model)
    sd = torch.load(tmp_path / "final" / "params_final.pt", weights_only=True)
    th.build_hsimae(model.cfg, device="cpu", state_dict=sd)  # loads strictly
    assert tio.latest_checkpoint(str(tmp_path / "none")) is None


def test_cli_pretrain_one_epoch_on_cpu(tmp_path):
    from hsimae_tpu_torch.cli import pretrain as cli

    argv = ["--synthetic", "--synthetic-scenes", "2", "--synthetic-size", "24",
            "--synthetic-bands", "40", "--model", "HSIMAE-S", "--no-bf16", "--epochs", "1",
            "--batch-size", "32", "--device", "cpu", "--workdir", str(tmp_path),
            "--checkpoint-every", "1", "--scene-dtype", "bfloat16", "--adam-mu-dtype",
            "bfloat16"]
    model, hist = cli.main(argv)
    assert len(hist["epoch_loss"]) == 1 and np.isfinite(hist["epoch_loss"][0])
    assert {"params_final.pt", "train_log.npy", "train.jsonl"} <= set(os.listdir(tmp_path))
    assert tio.latest_checkpoint(str(tmp_path)) is not None
    assert model.cfg.compute_dtype == torch.float32 and not model._kernel_params
    # a second call resumes at the end: no epoch left to run
    assert cli.main(argv)[1]["epoch_loss"] == []

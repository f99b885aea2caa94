"""Port parity for fused K-step pretraining (``make_fused_pretrain_chunk``,
``run_pretraining`` with ``fused_steps``, ``cli.pretrain --fused-steps``)
against ``hsimae_tpu``, on the CPU, where the chunk runs its K steps in a
loop (its plain version; on a card they are one captured CUDA graph).

* The chunk against JAX's ``make_fused_pretrain_chunk`` from one init on
  the same scenes and cut-index rows, each step's draws rebuilt from JAX's
  own keys (``split(fold_in(base, i), 3)``) and injected: the mean loss
  within 1e-5 relative, parameters within 1e-5 relative plus
  ``1e-4 * sum of the rates`` (as ``test_torch_pretrain.py`` holds the
  eager step).
* With ``remat`` (every block recomputed in the backward pass) the chunk
  tracks JAX's remat chunk at the same tolerances.
* The chunk against K eager steps with the generator's draws: 1e-6
  relative; a chunk with remat against eager steps without it too. The update's last operation rounds once more than the eager
  step's fused multiply-add, so parameters also take ``atol`` 1e-8, far
  above that rounding and far below any update.
* ``run_pretraining(fused_steps=3)`` against JAX's loop with its chunk
  replaced by a recorder: the same padded schedule length, chunks, grids
  and cut-index rows, and the same update count.
* A fused run stopped after one epoch and resumed equals the uninterrupted
  run (rtol 1e-5); the CLI trains one fused epoch on the CPU; two gloo
  ranks train as one process does.
"""

import os
import queue
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.data.pipeline import MultiScenePatchSource as JaxSource
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
from hsimae_tpu_torch.parallel import mesh as pmesh
from hsimae_tpu_torch.train import pretrain as tpt
from hsimae_tpu_torch.train.optim import pretrain_optimizer

TINY = dict(depth=2, s_depth=1, decoder_depth=1, embed_dim=32, num_heads=2, decoder_dim=16,
            decoder_num_heads=2)
LR, WD, TOTAL = 1e-3, 0.05, 10
K, B = 3, 8
GRID = (3, 6)
LOOP = dict(batch_size=16, fused_steps=3, log_every=10**9)
WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the fast tier runs six
    pytest workers on the machine's cores). Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenes_and_locs():
    """``tests/test_train.py``'s scenes of its fused tests and their cut index."""
    scenes = [apply_gwpca(s, 32) for s in
              make_synthetic_pretrain_scenes(2, (28, 36), bands=40, seed=6)]
    return scenes, build_pretrain_cut_index([s.shape for s in scenes], 9, coarse_from=1).locs


@pytest.fixture(scope="module")
def corpus():
    return scenes_and_locs()


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ids_from_mask(mask, t_size, l_size):
    keep = np.asarray(mask).reshape(-1, t_size, l_size) == 0
    return (np.stack([np.flatnonzero(k.any(axis=1)) for k in keep]),
            np.stack([np.flatnonzero(k.any(axis=0)) for k in keep]))


def test_chunk_tracks_jax_fused_chunk(corpus):
    track_jax_fused_chunk(corpus, remat=False)


def test_chunk_tracks_jax_fused_chunk_with_remat(corpus):
    """Both packages recompute every block in the backward pass (JAX's
    ``nn.remat(Block)`` inside its scanned chunk, the port's
    ``torch.utils.checkpoint`` inside the chunk's steps), at the same
    tolerances."""
    track_jax_fused_chunk(corpus, remat=True)


def track_jax_fused_chunk(corpus, remat: bool):
    scenes, all_locs = corpus
    locs = all_locs[:K * B].reshape(K, B, 3)
    jc = jcfg.preset("HSIMAE-S", **TINY, remat=remat)
    tc = tcfg.preset("HSIMAE-S", **TINY, remat=remat)
    jm = jh.build_hsimae(jc)
    params = jh.init_model(jm, seed=0)["params"]
    model = th.build_hsimae(tc, device="cpu", state_dict=from_jax_params(to_numpy(params), tc))
    tx, _ = jax_optimizer(LR, WD, TOTAL)
    state = jpt.TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    opt, sched = pretrain_optimizer(model, LR, WD, TOTAL)
    mask_of = jax.jit(lambda km, kd: jm.apply(
        {"params": params}, jnp.zeros((B, 9, 9, 32)), *GRID, True,
        rngs={"mask": km, "droppath": kd}, method=jh.HSIMAE.forward_pretrain)[2])

    base = jax.random.PRNGKey(7)
    draws = []
    for i in range(K):  # the JAX chunk's keys for step i, and augment_flips' own split
        kf, km, kd = jax.random.split(jax.random.fold_in(base, i), 3)
        flips = tuple(torch.from_numpy(np.array(jax.random.bernoulli(q, 0.5, (B,))))
                      for q in jax.random.split(kf))
        ids_t, ids_l = ids_from_mask(mask_of(km, kd), tc.t_size, tc.l_size)
        draws.append(tpt.PretrainDraws(flips, GridMask.from_ids(
            torch.from_numpy(ids_t), torch.from_numpy(ids_l), tc.t_size, tc.l_size), None))

    state, jloss = jpt.make_fused_pretrain_chunk(jm, JaxSource(scenes))(
        state, jnp.asarray(locs), base, *GRID)
    chunk = tpt.make_fused_pretrain_chunk(model, opt, sched,
                                          MultiScenePatchSource(scenes, device="cpu"))
    loss = chunk(locs, *GRID, draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert opt.count == int(state.step) == K
    want = from_jax_params(to_numpy(state.params), tc)
    lrs = sum(sched(k) for k in range(K))
    assert lrs > 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-4 * lrs, err_msg=name)


def test_chunk_equals_eager_steps(corpus):
    chunk_equals_eager_steps(corpus, chunk_remat=False)


def test_chunk_with_remat_equals_eager_steps_without(corpus):
    """The chunk recomputes its blocks in the backward pass, the eager
    steps keep their activations: same draws, same losses and parameters
    (remat changes only the autodiff schedule, as in JAX)."""
    chunk_equals_eager_steps(corpus, chunk_remat=True)


def test_blocks_draw_nothing():
    """A Block takes its drop-path masks as arguments and draws nothing, with
    masks or without, so recomputing it needs no saved RNG state (the
    port's remat runs ``checkpoint(..., preserve_rng_state=False)``, which a
    CUDA-graph capture needs); a training ``forward_pretrain`` with every
    draw injected draws nothing either, with remat or without."""
    tc = tcfg.preset("HSIMAE-S", **TINY, drop_path=0.1)
    blk = th.build_hsimae(tc, seed=0, device="cpu").train().blocks_1[0]
    x = torch.randn(4, 9, tc.embed_dim, requires_grad=True)
    keep = (torch.tensor([True, False, True, True]), torch.tensor([False, True, True, True]))
    torch.manual_seed(0)
    state = torch.get_rng_state()
    for k in (keep, None):
        blk(x, k).sum().backward()
        assert torch.equal(torch.get_rng_state(), state)
    imgs = torch.rand(B, 9, 9, 32, generator=torch.Generator().manual_seed(1))
    for remat in (False, True):
        model = th.build_hsimae(tc.replace(remat=remat), seed=0, device="cpu").train()
        draws = tpt.draw_pretrain(model, B, *GRID, torch.Generator().manual_seed(2), "cpu")
        state = torch.get_rng_state()
        model.forward_pretrain(imgs, *GRID, None, draws.grid, draws.drop_keep)[0].backward()
        assert torch.equal(torch.get_rng_state(), state)


def chunk_equals_eager_steps(corpus, chunk_remat: bool):
    scenes, all_locs = corpus
    src = MultiScenePatchSource(scenes, device="cpu")
    locs = all_locs[np.random.default_rng(0).integers(0, len(all_locs), (K, B))]
    tc = tcfg.preset("HSIMAE-S", **TINY, drop_path=0.1)  # drop-path masks drawn too
    runs = []
    for fused in (True, False):
        model = th.build_hsimae(tc.replace(remat=chunk_remat and fused), seed=0, device="cpu")
        opt, sched = pretrain_optimizer(model, LR, WD, TOTAL)
        if fused:
            losses = tpt.make_fused_pretrain_chunk(model, opt, sched, src, seed=5)(locs, *GRID)
        else:
            step = tpt.make_pretrain_step(model, opt, sched, seed=5)
            losses = torch.stack([step(src.gather(locs[i]), *GRID) for i in range(K)]).mean()
        assert opt.count == K
        runs.append((losses.item(), {k: v.detach() for k, v in model.named_parameters()}))
    (fused_loss, fused_params), (loss, params) = runs
    np.testing.assert_allclose(fused_loss, loss, rtol=1e-6)
    for name, p in params.items():
        np.testing.assert_allclose(fused_params[name].numpy(), p.numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


@pytest.mark.parametrize("mu_dtype,encoder_scale", [(None, 1.0), (torch.bfloat16, 1.0),
                                                     (None, 0.5)])
def test_step_from_is_step_with_device_rates(mu_dtype, encoder_scale):
    """``AdamW.step_from`` (the rate and bias corrections as tensors) against
    ``step`` over four updates with changing rates: the moments equal, the
    parameters within the rounding of the update's last operation; a
    group's ``lr_scale`` multiplies the tensor rate."""
    from hsimae_tpu_torch.train.optim import finetune_optimizer

    tc = tcfg.preset("HSIMAE-S", **TINY, num_classes=3)
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, p in enumerate(th.build_dual_vit(tc, 3, device="cpu").parameters())]
    opts = []
    for capturable in (False, True):
        model = th.build_dual_vit(tc, 3, seed=1, device="cpu")
        if encoder_scale == 1.0:
            opt, _ = pretrain_optimizer(model, LR, WD, TOTAL, mu_dtype=mu_dtype)
        else:
            opt, _ = finetune_optimizer(model, LR, WD, 3, 1, encoder_lr_scale=encoder_scale)
        for k in range(4):
            for p, g in zip(model.parameters(), grads):
                p.grad = g * (k + 1)
            lr = LR * (k + 1) / 4
            if capturable:
                bc1, bc2 = opt.bias_corrections(opt.count + 1)
                opt.step_from(*(torch.tensor(v, dtype=torch.float32) for v in (lr, bc1, bc2)))
                opt.count += 1
            else:
                for g in opt.param_groups:
                    g["lr"] = lr * g["lr_scale"]
                opt.step()
        opts.append((opt, model))
    (eager, a), (captured, b) = opts
    assert eager.count == captured.count == 4 and len(eager.param_groups) == (
        2 if encoder_scale == 1.0 else 4)
    moments = [[m for ms in (*o.mu, *o.nu) for m in ms] for o in (eager, captured)]
    assert len(moments[0]) == 2 * len(list(a.parameters()))
    for m, n in zip(*moments):
        assert torch.equal(m, n) and m.dtype == n.dtype
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


def test_run_pretraining_pads_like_jax(corpus, monkeypatch):
    """Both loops with their chunks recorded (JAX's replaced by a recorder
    that only advances the step): the schedule's length, every chunk's
    batches, kept grid and rows, and the update count agree."""
    scenes, locs = corpus
    seen = {"jax": [], "torch": []}
    lengths = {}

    def jax_chunk(*args, **kw):
        def chunk(state, locs_chunk, rng, len_t, len_l):
            seen["jax"].append((np.asarray(locs_chunk), len_t, len_l))
            return state.replace(step=state.step + locs_chunk.shape[0]), jnp.float32(1.0)
        return chunk

    def recording(pkg, real, at):  # records the schedule's length, argument ``at``
        def wrapped(*args, **kw):
            lengths[pkg] = args[at]
            return real(*args, **kw)
        return wrapped

    monkeypatch.setattr(jpt, "make_fused_pretrain_chunk", jax_chunk)
    monkeypatch.setattr(jpt, "pretrain_optimizer", recording("jax", jpt.pretrain_optimizer, 2))
    monkeypatch.setattr(tpt, "pretrain_optimizer", recording("torch", tpt.pretrain_optimizer, 3))
    real_make = tpt.make_fused_pretrain_chunk
    made = []

    def torch_chunk(model, optimizer, *a, **kw):
        inner = real_make(model, optimizer, *a, **kw)
        made.append(optimizer)

        def chunk(locs_chunk, len_t, len_l):
            seen["torch"].append((locs_chunk.numpy().copy(), len_t, len_l))
            return inner(locs_chunk, len_t, len_l)
        chunk.capture_seconds = inner.capture_seconds
        return chunk

    monkeypatch.setattr(tpt, "make_fused_pretrain_chunk", torch_chunk)
    jpt.run_pretraining(JaxSource(scenes), locs, jcfg.preset("HSIMAE-S", **TINY),
                        jcfg.PretrainConfig(epochs=2, **LOOP))
    _, hist = tpt.run_pretraining(MultiScenePatchSource(scenes, device="cpu"), locs,
                                  tcfg.preset("HSIMAE-S", **TINY),
                                  tcfg.PretrainConfig(epochs=2, **LOOP), device="cpu")
    steps = int(np.ceil(int(np.ceil(len(locs) / 16)) / 3)) * 3  # padded to whole chunks
    assert steps * 16 > len(locs) + 16  # the padding is more than the eager tail's
    assert lengths == {"jax": 2 * steps, "torch": 2 * steps}
    assert len(seen["jax"]) == len(seen["torch"]) == 2 * steps // 3
    for (jl, jt, jw), (tl, tt, tw) in zip(seen["jax"], seen["torch"]):
        assert jl.shape == (3, 16, 3) and (jt, jw) == (tt, tw)
        np.testing.assert_array_equal(tl, jl)
    assert made[0].count == 2 * steps
    assert len(hist["epoch_loss"]) == 2 and np.isfinite(hist["epoch_loss"]).all()
    assert hist["capture_seconds"] == [0.0, 0.0]  # the CPU captures nothing


def test_fused_resume_equals_uninterrupted(tmp_path, corpus):
    scenes, locs = corpus
    src = MultiScenePatchSource(scenes, device="cpu")
    mcfg = tcfg.preset("HSIMAE-S", **TINY)
    cfg = tcfg.PretrainConfig(epochs=2, checkpoint_every_steps=1, **LOOP)
    full, hist_full = tpt.run_pretraining(src, locs, mcfg, cfg, resume=False, device="cpu")
    wd = str(tmp_path)
    tpt.run_pretraining(src, locs, mcfg, cfg, workdir=wd, resume=False, stop_after_epochs=1,
                        device="cpu")
    res, hist_res = tpt.run_pretraining(src, locs, mcfg, cfg, workdir=wd, device="cpu")
    assert len(hist_full["epoch_loss"]) == 2 and len(hist_res["epoch_loss"]) == 1
    np.testing.assert_allclose(hist_res["epoch_loss"][0], hist_full["epoch_loss"][1], rtol=1e-5)
    for (name, a), b in zip(full.state_dict().items(), res.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    steps = int(np.ceil(int(np.ceil(len(locs) / 16)) / 3)) * 3
    assert tio.latest_checkpoint(wd).endswith(f"ckpt_{2 * steps}.pt")


def test_cli_fused_pretrain_one_epoch_on_cpu(tmp_path):
    from hsimae_tpu_torch.cli import pretrain as cli

    argv = ["--synthetic", "--synthetic-scenes", "2", "--synthetic-size", "24",
            "--synthetic-bands", "40", "--model", "HSIMAE-S", "--no-bf16", "--epochs", "1",
            "--batch-size", "8", "--device", "cpu", "--workdir", str(tmp_path),
            "--checkpoint-every", "1", "--fused-steps", "3"]
    args = cli.build_parser().parse_args(argv)
    _, index, _, cfg = cli.prepare(args)
    assert cfg.fused_steps == 3
    model, hist = cli.main(argv)
    assert len(hist["epoch_loss"]) == 1 and np.isfinite(hist["epoch_loss"][0])
    assert {"params_final.pt", "train_log.npy", "train.jsonl"} <= set(os.listdir(tmp_path))
    eager_steps = int(np.ceil(len(index) / 8))
    steps = int(np.ceil(eager_steps / 3)) * 3
    assert eager_steps > 3 and steps > eager_steps  # whole chunks of 3: padded
    assert tio.latest_checkpoint(str(tmp_path)).endswith(f"ckpt_{steps}.pt")
    assert cli.build_parser().parse_args([]).fused_steps == 0


def fused_loop(workdir=None):
    """Two fused epochs on the corpus -> (epoch losses, parameters)."""
    scenes, locs = scenes_and_locs()
    model, hist = tpt.run_pretraining(MultiScenePatchSource(scenes, device="cpu"), locs,
                                      tcfg.preset("HSIMAE-S", **TINY),
                                      tcfg.PretrainConfig(epochs=2, **LOOP), workdir=workdir,
                                      resume=False, device="cpu")
    return hist["epoch_loss"], {k: v.detach().numpy().copy()
                                for k, v in model.named_parameters()}


def _rank_main(rank, port, workdir, results):
    torch.set_num_threads(1)
    pmesh.init_distributed(rank, WORLD, f"tcp://localhost:{port}", rank, WORLD, "cpu")
    try:
        results.put((rank, fused_loop(workdir)))
    finally:
        pmesh.shutdown_distributed()


def test_two_gloo_ranks_train_fused_as_one_process(tmp_path):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    results = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_rank_main, args=(port, str(tmp_path), results), nprocs=WORLD,
                               join=False, start_method="spawn")
    losses, params = fused_loop()
    got = {}
    while len(got) < WORLD:
        try:
            rank, out = results.get(timeout=1.0)
            got[rank] = out
        except queue.Empty:
            procs.join(timeout=0)  # raises when a rank failed
    while not procs.join():
        pass
    for rank_losses, rank_params in got.values():
        np.testing.assert_allclose(rank_losses, losses, rtol=1e-5)
        assert set(rank_params) == set(params)
        for k, v in params.items():
            np.testing.assert_allclose(rank_params[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    assert {"params_final.pt", "train_log.npy"} <= set(os.listdir(tmp_path))  # rank 0 wrote

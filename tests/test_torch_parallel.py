"""Port parity for data and tensor parallelism (``hsimae_tpu_torch.parallel``
and its users) against one process on the global batch and against
``hsimae_tpu``, on the CPU.

* In this process, a one-rank gloo group over a ``FileStore``: the mesh's
  shapes and errors, the row partition, ``pad_to_multiple``, the TP plan
  against JAX's ``tp_spec`` on every parameter of a small ``DualViT``, and
  the fused-block kernel route refusing a TP-sharded block.
* One module fixture spawns 2 gloo ranks on the CPU once (one intra-op
  thread each) and returns what they computed; the tests below assert it:
  three data-parallel pretrain steps and three dual steps, each with a
  padded tail, against the same steps in one process (loss rtol 1e-5,
  parameters atol 1e-5) and against JAX's ``make_pretrain_step`` /
  ``make_dual_step`` on the same weights and injected draws (the same
  holds); data-parallel ``classify_scene`` at batch 30 on an 11x13 scene,
  equal to JAX's map; the TP ``(1, 2)`` dual step against the replicated
  one (loss rtol 1e-5, logits rtol 1e-4 / atol 1e-5); the pretraining loop
  with rank-0-only checkpoint writes and a resume on both ranks; one
  protocol run equal to one process's; and ``cli.evaluate --dp 2``.

Models are narrow (embed 32, 2 heads, decoder 16 x 1); each step's global
batch is split 50/50, so the ranks' local sums of weights differ."""

import contextlib
import os
import queue
import socket

import numpy as np
import pytest
import torch

from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.parallel import mesh as pmesh
from hsimae_tpu_torch.parallel import tp as ptp

SMALL = dict(embed_dim=32, num_heads=2, depth=3, s_depth=2, decoder_dim=16, decoder_num_heads=2,
             decoder_depth=1)
NC = 5  # classes, background included
DROP = 0.2
STACKS = ("blocks_1", "blocks_2", "blocks")
LR, WD, TOTAL = 1e-3, 0.05, 10
WORLD = 2
PRETRAIN_GRIDS = [(3, 6)] * 3  # one kept grid: one compile of each JAX step
DUAL_GRIDS = [(2, 4)] * 3
N_L, N_U = 6, 6  # the dual step's global labeled and unlabeled batches
PROTOCOL = dict(depth=2, s_depth=1, decoder_depth=1, embed_dim=32, num_heads=2, decoder_dim=16,
                decoder_num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the fast tier runs six
    pytest workers on the machine's cores). Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------ one rank, in process ------------------------


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group for one in-process test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    yield
    pmesh.shutdown_distributed()


def test_make_mesh_shapes_and_errors(group):
    m = pmesh.make_mesh(device_type="cpu")
    assert m.mesh_dim_names == ("data", "model") and (m.size(0), m.size(1)) == (1, 1)
    assert pmesh.make_mesh(data=1, model=1, device_type="cpu").size() == 1
    for bad in (dict(model=2), dict(data=2), dict(model=3)):
        with pytest.raises(ValueError):
            pmesh.make_mesh(device_type="cpu", **bad)
    assert pmesh.default_mesh().size() == 1  # a group of one rank: its collectives run
    assert pmesh.default_mesh() is pmesh.default_mesh()  # built once a group
    assert pmesh.local_mesh_info(m) == "mesh data=1 model=1 on 1 cpu ranks"
    assert pmesh.local_mesh_info(None) == "no mesh (single device)"
    x = torch.arange(8.0)
    assert torch.equal(pmesh.shard_batch(x, m), x)
    assert torch.equal(pmesh.all_gather_rows(x, m), x[None])


def test_process_local_slice_partitions_exactly(group):
    for n, pc in [(16, 4), (17, 4), (8, 1), (5, 3), (4, 8)]:
        covered = []
        for p in range(pc):
            covered.extend(range(n)[pmesh.process_local_slice(n, p, pc)])
        assert covered == list(range(n)), (n, pc)
        sizes = [len(range(n)[pmesh.process_local_slice(n, p, pc)]) for p in range(pc)]
        assert max(sizes) - min(sizes) <= 1, (n, pc)
    assert pmesh.process_local_slice(12) == slice(0, 12)  # this process's rank of one


def test_pad_to_multiple():
    assert pmesh.pad_to_multiple(9, 8) == 16
    assert pmesh.pad_to_multiple(16, 8) == 16
    assert pmesh.pad_to_multiple(1, 8) == 8
    assert pmesh.pad_to_multiple(7, 1) == 7


def test_tp_plan_matches_jax_tp_spec():
    """Every parameter of a small DualViT: the port's plan at model 2 and
    JAX's ``tp_spec`` on the matching flax path (named as
    ``export_torch_state_dict`` names it) split the same way."""
    import re

    import jax
    from jax.sharding import PartitionSpec as P

    from hsimae_tpu import config as jcfg
    from hsimae_tpu.checkpoints.io import _flatten
    from hsimae_tpu.models import hsimae as jh
    from hsimae_tpu.parallel.tp import tp_spec as jax_tp_spec
    from hsimae_tpu_torch.models import hsimae as th

    jc = jcfg.preset("HSIMAE-S", **SMALL)
    params = jax.device_get(jh.init_model(jh.build_dual_vit(jc, NC), seed=0)["params"])
    kinds = {P(None, "model"): "column", P("model"): "column", P("model", None): "row"}
    want = {}
    for path, leaf in _flatten(params).items():
        parts = [re.sub(r"_(\d+)$", r".\1", p) for p in path]
        leafname = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
        want[".".join(parts[:-1] + [leafname])] = kinds.get(jax_tp_spec(path, leaf.ndim))
    model = th.build_dual_vit(tcfg.preset("HSIMAE-S", **SMALL), NC, device="cpu")
    plan = ptp.tp_plan(model, 2)
    assert plan == want
    assert {k for k, v in plan.items() if v} and plan["patch_embed.proj.weight"] is None
    assert plan["blocks_1.0.attn.q.bias"] == "column" and plan["blocks.0.attn.proj.bias"] is None
    # 2 heads do not divide a model axis of 4: the attentions stay whole
    assert not any(v for k, v in ptp.tp_plan(model, 4).items() if ".attn." in k)


def test_tp_sharded_block_is_refused_by_the_kernel_route(group):
    from torch.distributed.tensor.parallel import ColwiseParallel, parallelize_module

    from hsimae_tpu_torch.models import hsimae as th

    cfg = tcfg.preset("HSIMAE-S", **SMALL)
    model = th.build_hsi_vit(cfg, NC, device="cpu")
    tp_mesh = pmesh.make_mesh(device_type="cpu")["model"]
    parallelize_module(model, tp_mesh, {"blocks_1.0.attn.q": ColwiseParallel()})
    assert type(model.blocks_1[0].attn.q.weight).__name__ == "DTensor"
    x = torch.rand(2, 9, 9, 32)
    with pytest.raises(ValueError, match="tensor-parallel"):
        model.classify(x)  # eval mode, use_kernel: the kernel route
    model.cfg = model.cfg.replace(use_kernel=False)
    assert model.classify(x).shape == (2, NC)  # the Block modules take the shards


# ------------------------------ two ranks, spawned --------------------------


def _imgs(n, seed, bands=32, img=9):
    return np.random.default_rng(seed).random((n, img, img, bands)).astype(np.float32)


def _ids_from_mask(mask, t_size, l_size):
    keep = np.asarray(mask).reshape(-1, t_size, l_size) == 0
    return (np.stack([np.flatnonzero(k.any(axis=1)) for k in keep]),
            np.stack([np.flatnonzero(k.any(axis=0)) for k in keep]))


def _grid(ids, tc):
    from hsimae_tpu_torch.models.masking import GridMask

    return GridMask.from_ids(torch.from_numpy(ids[0]), torch.from_numpy(ids[1]), tc.t_size,
                             tc.l_size)


def _flips(f):
    return tuple(torch.from_numpy(a) for a in f)


def _keep_tree(model, masks):
    """The port's drop-path masks of one encode from JAX's, in call order."""
    return {name: [(torch.from_numpy(next(masks)), torch.from_numpy(next(masks)))
                   if b.drop_path_rate > 0 else None for b in getattr(model, name)]
            for name in STACKS}


def _pretrain_draws(tc, d):
    from hsimae_tpu_torch.train.pretrain import PretrainDraws

    return PretrainDraws(_flips(d["flips"]), _grid(d["ids"], tc), None)


def _dual_draws(model, tc, d):
    from hsimae_tpu_torch.train.finetune import DualDraws

    masks = iter(d["keep"])
    return DualDraws(_flips(d["flips"]), _flips(d["flips_u"]), _grid(d["ids"], tc),
                     _keep_tree(model, masks), _keep_tree(model, masks))


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def run_pretrain_steps(case, mesh=None):
    """Three pretrain steps from the JAX weights with JAX's draws: the
    global batch, or this rank's rows of it under ``mesh``."""
    from hsimae_tpu_torch.checkpoints.convert import from_jax_params
    from hsimae_tpu_torch.models import hsimae as th
    from hsimae_tpu_torch.train import pretrain as tpt
    from hsimae_tpu_torch.train.optim import pretrain_optimizer

    tc = tcfg.preset("HSIMAE-S", **SMALL)
    model = th.build_hsimae(tc, device="cpu", state_dict=from_jax_params(case["pt_params"], tc))
    opt, sched = pretrain_optimizer(model, LR, WD, TOTAL)
    step = tpt.make_pretrain_step(model, opt, sched, mesh=mesh)
    rows = pmesh.mesh_slice(len(case["pt_w"]), mesh)
    losses = []
    for (lt, ll), x, d in zip(PRETRAIN_GRIDS, case["pt_x"], case["pt_draws"]):
        losses.append(step(torch.from_numpy(x[rows]), lt, ll, torch.from_numpy(case["pt_w"]),
                           _pretrain_draws(tc, d)).item())
    return losses, _state(model)


def _dual_model(case):
    from hsimae_tpu_torch.checkpoints.convert import from_jax_params
    from hsimae_tpu_torch.models import hsimae as th

    tc = tcfg.preset("HSIMAE-S", **SMALL)
    return th.build_dual_vit(tc, NC, drop_path=DROP, device="cpu",
                             state_dict=from_jax_params(case["ft_params"], tc)), tc


def run_dual_steps(case, mesh=None):
    """Dual steps from the JAX weights with JAX's draws (global batch, or
    this rank's rows under ``mesh``) -> (losses, recs, logits, params)."""
    from hsimae_tpu_torch.train import finetune as tft
    from hsimae_tpu_torch.train import optim as to

    model, tc = _dual_model(case)
    opt, sched = to.finetune_optimizer(model, LR, 5e-3, 3, 1)
    step = tft.make_dual_step(model, opt, sched, 10.0, mesh=mesh)
    rows, rows_u = pmesh.mesh_slice(N_L, mesh), pmesh.mesh_slice(N_U, mesh)
    out = ([], [], [])
    for k, (lt, ll) in enumerate(DUAL_GRIDS):
        x, xu = case["ft_x"][k], case["ft_xu"][k]
        loss, rec, logits = step(torch.from_numpy(x[rows]), torch.from_numpy(case["ft_y"]),
                                 torch.from_numpy(case["ft_w"]), torch.from_numpy(xu[rows_u]),
                                 lt, ll, draws=_dual_draws(model, tc, case["ft_draws"][k]))
        for acc, v in zip(out, (loss.item(), rec.item(), logits.numpy())):
            acc.append(v)
    return (*out, _state(model))


def corpus():
    from hsimae_tpu_torch.data.gwpca import apply_gwpca
    from hsimae_tpu_torch.data.pipeline import MultiScenePatchSource
    from hsimae_tpu_torch.data.synthetic import make_synthetic_pretrain_scenes
    from hsimae_tpu_torch.data.windows import build_pretrain_cut_index

    scenes = [apply_gwpca(s, 32) for s in
              make_synthetic_pretrain_scenes(2, (30, 40), bands=48, seed=3)]
    src = MultiScenePatchSource(scenes, patch_size=9, device="cpu")
    return src, build_pretrain_cut_index([s.shape for s in scenes], 9, coarse_from=1).locs


PRETRAIN_LOOP = dict(epochs=2, batch_size=64, log_every=10**9, checkpoint_every_steps=1)


def run_protocol_micro(resume_dir=None):
    from hsimae_tpu_torch.data.synthetic import make_synthetic_scene
    from hsimae_tpu_torch.models import hsimae as th
    from hsimae_tpu_torch.train import protocol as tp

    scene, gt = make_synthetic_scene(20, 20, bands=40, n_classes=3, seed=4)
    cfg = tcfg.preset("HSIMAE-S", **PROTOCOL)
    pretrained = th.build_hsimae(cfg, seed=11, device="cpu").state_dict()
    # 4 labeled a class: 6 train and 6 val, 144 windows -> unlabeled 72: no
    # batch needs padding to the data axis, so one process runs what two do
    res = tp.run_protocol(scene, gt, cfg, tcfg.FinetuneConfig(epochs=2, batch_size=8),
                          tcfg.ProtocolConfig(lr_grid=(1e-3,), selection_seeds=1, test_seeds=1),
                          samples_per_class=4, pretrained=pretrained, verbose=False,
                          resume_dir=resume_dir, device="cpu")
    m = res.test_metrics[0]
    return {"best_lr": res.best_lr, "scores": res.selection_scores,
            "test": (m.oa, m.aa, m.kappa, m.per_class.tolist())}


def tp_dual_step(mesh=None):
    """One dual step of a seeded port DualViT on seeded inputs and draws;
    under a ``mesh``, its attention and SwiGLU layers sharded over
    ``mesh["model"]`` and this rank's rows of the batch on the data axis ->
    (loss, this rank's logits, (sharded parameters, planned splits))."""
    from hsimae_tpu_torch.models import hsimae as th
    from hsimae_tpu_torch.train import finetune as tft
    from hsimae_tpu_torch.train import optim as to

    tc = tcfg.preset("HSIMAE-S", **SMALL)
    model = th.build_dual_vit(tc, NC, drop_path=DROP, seed=3, device="cpu")
    draws = tft.draw_dual(model, N_L, N_U, *DUAL_GRIDS[0], torch.Generator().manual_seed(4),
                          "cpu")
    sharded = None
    if mesh is not None:
        planned = sum(v is not None for v in ptp.tp_plan(model, mesh["model"].size()).values())
        ptp.shard_model_tp(model, mesh)
        sharded = (sum(any(pl.is_shard() for pl in getattr(p, "placements", ()))
                       for p in model.parameters()), planned)
    opt, sched = to.finetune_optimizer(model, LR, 5e-3, 3, 1)
    y = torch.tensor([1, 2, 3, 4, 0, 0])
    w = torch.tensor([1.0, 1, 1, 1, 0, 0])
    rows, rows_u = pmesh.mesh_slice(N_L, mesh), pmesh.mesh_slice(N_U, mesh)
    loss, _, logits = tft.make_dual_step(model, opt, sched, 10.0, mesh=mesh)(
        torch.from_numpy(_imgs(N_L, 70)[rows]), y, w, torch.from_numpy(_imgs(N_U, 71)[rows_u]),
        *DUAL_GRIDS[0], draws=draws)
    return loss.item(), logits.numpy(), sharded


def _rank_main(rank, port, case, inbox, results):
    """One of the spawned ranks: every data-parallel path, its outputs on
    ``results``. The paths that need no JAX draws run while the parent
    records them; then the pretrain and dual steps take them from
    ``inbox``."""
    torch.set_num_threads(1)
    pmesh.init_distributed(rank, WORLD, f"tcp://localhost:{port}", rank, WORLD, "cpu")
    try:
        out = {}
        from hsimae_tpu_torch.train import evaluate as tev

        out["scene_map"] = tev.classify_scene(  # the default mesh: both ranks
            case["scene"], case["scene_params"], tcfg.preset("HSIMAE-S", **SMALL), NC,
            tcfg.EvalConfig(batch_size=30), device="cpu")

        # tensor parallelism: one dual step on a (1, 2) mesh, and replicated
        out["tp"] = (tp_dual_step(pmesh.make_mesh(data=1, model=2)), tp_dual_step())

        # the pretraining loop: uninterrupted, then stopped after epoch 1 and
        # resumed; every checkpoint and final-parameter write is recorded
        from hsimae_tpu_torch.train import pretrain as tpt

        writes = []
        for name in ("save_checkpoint", "save_params"):
            real = getattr(tpt, name)
            setattr(tpt, name, lambda *a, _real=real, _name=name, **k: (
                writes.append(_name), _real(*a, **k))[1])
        src, locs = corpus()
        mcfg, pcfg = tcfg.preset("HSIMAE-S", **PROTOCOL), tcfg.PretrainConfig(**PRETRAIN_LOOP)
        full = tpt.run_pretraining(src, locs, mcfg, pcfg, resume=False, device="cpu")[1]
        wd = case["workdir"]
        tpt.run_pretraining(src, locs, mcfg, pcfg, workdir=wd, resume=False,
                            stop_after_epochs=1, device="cpu")
        res, hist = tpt.run_pretraining(src, locs, mcfg, pcfg, workdir=wd, device="cpu")
        out["loop"] = (full["epoch_loss"], hist["epoch_loss"], writes, sorted(os.listdir(wd)))

        out["protocol"] = run_protocol_micro(case["protocol_dir"])

        case.update(inbox.get(timeout=600))  # the weights, batches and JAX's draws
        dp = pmesh.make_mesh()
        out["pretrain"] = run_pretrain_steps(case, dp)
        out["dual"] = run_dual_steps(case, dp)
        results.put((rank, out))
    finally:
        pmesh.shutdown_distributed()


class Recorder:
    """Within ``record()``, JAX's kept-grid masks and drop-path keep masks
    are recorded in call order as a jitted step draws them."""

    def __init__(self):
        self.grids, self.keeps = [], []

    def drop_path(self, v, rate, rng, train):
        import jax
        import jax.numpy as jnp

        keep = jax.random.bernoulli(rng, 1.0 - rate, (v.shape[0],) + (1,) * (v.ndim - 1))
        jax.debug.callback(lambda k: self.keeps.append(np.array(k).reshape(-1)), keep,
                           ordered=True)
        return jnp.where(keep, v / (1.0 - rate), jnp.zeros_like(v))

    def mask(self, orig):
        import jax

        def recording(key, *shape):
            gm = orig(key, *shape)
            jax.debug.callback(lambda m: self.grids.append(np.array(m)), gm.mask, ordered=True)
            return gm

        return recording

    @contextlib.contextmanager
    def record(self):
        from hsimae_tpu.models import hsimae as jh
        from hsimae_tpu.models import layers as jl

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jl, "drop_path", self.drop_path)
            mp.setattr(jh, "spatial_spectral_mask", self.mask(jh.spatial_spectral_mask))
            yield

    def take(self):
        import jax

        jax.effects_barrier()
        out = (self.grids[:], self.keeps[:])
        self.grids.clear()
        self.keeps.clear()
        return out


def jax_flip_masks(key, m):
    """``augment_flips``' own split and draws of ``key``."""
    import jax

    kh, kv = jax.random.split(key)
    return tuple(np.array(jax.random.bernoulli(q, 0.5, (m,))) for q in (kh, kv))


def from_jax(params, tc):
    from hsimae_tpu_torch.checkpoints.convert import from_jax_params

    return {k: v.numpy() for k, v in from_jax_params(params, tc).items()}


def jax_pretrain_case(case, rec):
    """JAX's three pretrain steps on a padded global batch, their draws
    recorded (flips re-split from the step key, the kept grid)."""
    import jax
    import jax.numpy as jnp

    from hsimae_tpu import config as jcfg
    from hsimae_tpu.models import hsimae as jh
    from hsimae_tpu.train import pretrain as jpt
    from hsimae_tpu.train.optim import pretrain_optimizer as jax_optimizer

    jc, tc = jcfg.preset("HSIMAE-S", **SMALL), tcfg.preset("HSIMAE-S", **SMALL)
    jm = jh.build_hsimae(jc)
    params = jax.device_get(jh.init_model(jm, seed=0)["params"])
    tx, _ = jax_optimizer(LR, WD, TOTAL)
    state = jpt.TrainState.create(apply_fn=jm.apply, params=jax.tree_util.tree_map(
        jnp.asarray, params), tx=tx)
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)  # rank 1 holds the padded tail
    xs, draws, losses = [], [], []
    with rec.record():
        step = jpt.make_pretrain_step(jh.build_hsimae(jc))
        for k, (lt, ll) in enumerate(PRETRAIN_GRIDS):
            x = _imgs(8, 40 + k)
            key = jax.random.PRNGKey(200 + k)
            state, loss = step(state, jnp.asarray(x), key, lt, ll, jnp.asarray(w))
            (mask,), _ = rec.take()
            xs.append(x)
            draws.append({"flips": jax_flip_masks(jax.random.split(key, 3)[0], 8),
                          "ids": _ids_from_mask(mask, tc.t_size, tc.l_size)})
            losses.append(float(loss))
    case.update(pt_params=params, pt_x=xs, pt_w=w, pt_draws=draws)
    return losses, from_jax(jax.device_get(state.params), tc)


def jax_dual_case(case, rec):
    """JAX's three dual steps on a labeled batch with a padded tail, their
    draws recorded (flips re-split from the step key; the kept grid and the
    drop-path masks of both encodes in call order)."""
    import jax
    import jax.numpy as jnp

    from hsimae_tpu import config as jcfg
    from hsimae_tpu.models import hsimae as jh
    from hsimae_tpu.train import finetune as jft
    from hsimae_tpu.train import optim as jo

    jc, tc = jcfg.preset("HSIMAE-S", **SMALL), tcfg.preset("HSIMAE-S", **SMALL)
    params = jax.device_get(jh.init_model(jh.build_dual_vit(jc, NC, drop_path=DROP),
                                          seed=0)["params"])
    tx, _ = jo.finetune_optimizer(LR, 5e-3, 3, 1)
    y = np.array([1, 2, 3, 4, 0, 0], np.int32)  # a padded tail, all on rank 1
    w = np.array([1, 1, 1, 1, 0, 0], np.float32)
    xs, xus, draws, out = [], [], [], ([], [], [])
    with rec.record():
        jm = jh.build_dual_vit(jc, NC, drop_path=DROP)
        state = jft.TrainState.create(apply_fn=jm.apply, params=jax.tree_util.tree_map(
            jnp.asarray, params), tx=tx)
        step = jft.make_dual_step(jm, 10.0)
        for k, (lt, ll) in enumerate(DUAL_GRIDS):
            x, xu = _imgs(N_L, 50 + k), _imgs(N_U, 60 + k)
            key = jax.random.PRNGKey(300 + k)
            state, loss, loss_rec, logits = step(
                state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.asarray(xu),
                jnp.ones(N_U, jnp.float32), key, lt, ll)
            (mask,), keeps = rec.take()
            kf, ku = jax.random.split(key, 4)[:2]
            xs.append(x)
            xus.append(xu)
            draws.append({"flips": jax_flip_masks(kf, N_L), "flips_u": jax_flip_masks(ku, N_U),
                          "ids": _ids_from_mask(mask, tc.t_size, tc.l_size), "keep": keeps})
            for acc, v in zip(out, (float(loss), float(loss_rec), np.asarray(logits))):
                acc.append(v)
    case.update(ft_params=params, ft_x=xs, ft_xu=xus, ft_y=y, ft_w=w, ft_draws=draws)
    return (*out, from_jax(jax.device_get(state.params), tc))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX references, the single-process port runs, and what two
    spawned gloo ranks computed: ``(case, jax, single, [rank 0, rank 1])``."""
    import jax
    import torch.multiprocessing as mp

    from hsimae_tpu import config as jcfg
    from hsimae_tpu.models import hsimae as jh
    from hsimae_tpu.train import evaluate as jev
    from hsimae_tpu_torch.data.gwpca import apply_gwpca
    from hsimae_tpu_torch.data.synthetic import make_synthetic_scene
    from hsimae_tpu_torch.train import pretrain as tpt

    jc = jcfg.preset("HSIMAE-S", **SMALL)
    scene_params = jax.device_get(jh.init_model(jh.build_hsi_vit(jc, NC), seed=5)["params"])
    scene, _ = make_synthetic_scene(11, 13, bands=40, n_classes=NC - 1, seed=6)
    case = {"workdir": str(tmp_path_factory.mktemp("dp_pretrain")),
            "protocol_dir": str(tmp_path_factory.mktemp("dp_protocol")),
            "scene": apply_gwpca(scene, nc=32).astype(np.float32),
            "scene_params": {k: torch.from_numpy(v) for k, v in
                             from_jax(scene_params, tcfg.preset("HSIMAE-S", **SMALL)).items()}}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(port, dict(case), inbox, results),
                               nprocs=WORLD, join=False, start_method="spawn")

    # JAX's references while the ranks run their first paths
    # bs 30 on 2 ranks; 143 pixels: the last batch is padded
    jax_ref = {"scene_map": jev.classify_scene(case["scene"], scene_params, jc, NC,
                                               jcfg.EvalConfig(batch_size=30))}
    rec, steps = Recorder(), {}
    jax_ref["pretrain"] = jax_pretrain_case(steps, rec)
    jax_ref["dual"] = jax_dual_case(steps, rec)
    for _ in range(WORLD):
        inbox.put(steps)
    case.update(steps)

    single = {"pretrain": run_pretrain_steps(case), "dual": run_dual_steps(case),
              "tp": tp_dual_step(), "protocol": run_protocol_micro()}
    src, locs = corpus()
    single["loop"] = tpt.run_pretraining(src, locs, tcfg.preset("HSIMAE-S", **PROTOCOL),
                                         tcfg.PretrainConfig(**PRETRAIN_LOOP), resume=False,
                                         device="cpu")[1]["epoch_loss"]
    got = {}
    while len(got) < WORLD:
        try:
            rank, out = results.get(timeout=1.0)
            got[rank] = out
        except queue.Empty:
            procs.join(timeout=0)  # raises when a rank failed
    while not procs.join():
        pass
    return case, jax_ref, single, [got[r] for r in range(WORLD)]


def assert_params(got, want, rtol=1e-5, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_dp_pretrain_steps_match_one_process(ranks):
    _, _, single, got = ranks
    losses, params = single["pretrain"]
    for rank in got:  # every rank reports the global loss and holds the same weights
        np.testing.assert_allclose(rank["pretrain"][0], losses, rtol=1e-5)
        assert_params(rank["pretrain"][1], params)


def test_dp_pretrain_steps_match_jax(ranks):
    _, jax_ref, _, got = ranks
    losses, params = jax_ref["pretrain"]
    np.testing.assert_allclose(got[0]["pretrain"][0], losses, rtol=1e-5)
    assert_params(got[0]["pretrain"][1], {k: params[k] for k in got[0]["pretrain"][1]})


def test_dp_dual_steps_match_one_process(ranks):
    _, _, single, got = ranks
    losses, recs, logits, params = single["dual"]
    for rank in got:
        np.testing.assert_allclose(rank["dual"][0], losses, rtol=1e-5)
        np.testing.assert_allclose(rank["dual"][1], recs, rtol=1e-5)
        assert_params(rank["dual"][3], params)
    for k in range(3):  # each rank's logits are its rows'
        np.testing.assert_allclose(np.concatenate([r["dual"][2][k] for r in got]), logits[k],
                                   rtol=1e-5, atol=1e-5)


def test_dp_dual_steps_match_jax(ranks):
    _, jax_ref, _, got = ranks
    losses, recs, logits, params = jax_ref["dual"]
    np.testing.assert_allclose(got[0]["dual"][0], losses, rtol=1e-5)
    np.testing.assert_allclose(got[0]["dual"][1], recs, rtol=1e-5)
    for k in range(3):
        np.testing.assert_allclose(np.concatenate([r["dual"][2][k] for r in got]), logits[k],
                                   rtol=2e-5, atol=2e-5)
    assert_params(got[0]["dual"][3], {k: params[k] for k in got[0]["dual"][3]})


def test_dp_classify_scene_equals_jax(ranks):
    _, jax_ref, _, got = ranks
    for rank in got:  # every rank returns the whole map
        assert rank["scene_map"].dtype == np.int32 and rank["scene_map"].shape == (11, 13)
        np.testing.assert_array_equal(rank["scene_map"], jax_ref["scene_map"])


def test_tp_dual_step_matches_replicated(ranks):
    _, _, single, got = ranks
    want_loss, want_logits, _ = single["tp"]
    for rank in got:
        (loss, logits, sharded), replicated = rank["tp"]
        # q/k/v/w1/w3 weight and bias, proj/w2 weight: 12 a block, 5 encoder + 1 decoder
        assert sharded == (72, 72)
        assert replicated[0] == want_loss  # the same seeded step, one rank alone
        assert np.isclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=1e-5)


def test_dp_pretrain_loop_writes_on_rank_0_and_resumes_on_both(ranks):
    _, _, single, got = ranks
    for r, rank in enumerate(got):
        full, resumed, writes, files = rank["loop"]
        np.testing.assert_allclose(full, single["loop"], rtol=1e-5)
        assert len(resumed) == 1
        np.testing.assert_allclose(resumed[0], full[1], rtol=1e-5)
        # rank 0: one checkpoint an epoch of each run, and two final files
        assert writes == ([] if r else ["save_checkpoint", "save_params"] * 2)
        assert "params_final.pt" in files and "train_log.npy" in files
    steps = sorted(int(f[5:-3]) for f in got[0]["loop"][3] if f.endswith(".pt") and
                   f.startswith("ckpt_"))
    assert len(steps) == 2 and steps[1] == 2 * steps[0]


def test_dp_protocol_equals_one_process(ranks):
    case, _, single, got = ranks
    for rank in got:
        p = rank["protocol"]
        assert p["best_lr"] == single["protocol"]["best_lr"]
        np.testing.assert_allclose(list(p["scores"].values()),
                                   list(single["protocol"]["scores"].values()), rtol=1e-6)
        np.testing.assert_allclose(p["test"][:3], single["protocol"]["test"][:3], rtol=1e-6)
        np.testing.assert_allclose(p["test"][3], single["protocol"]["test"][3], rtol=1e-6)
    lines = open(os.path.join(case["protocol_dir"], "protocol_runs.jsonl")).read().splitlines()
    assert len(lines) == 2  # one record a run, written by rank 0 alone


def test_cli_evaluate_dp_equals_one_process(ranks, tmp_path, capsys):
    from hsimae_tpu_torch.cli import evaluate as cli

    argv = ["--synthetic", "--synthetic-size", "13", "--synthetic-bands", "40",
            "--synthetic-classes", "4", "--num-classes", "5", "--model", "HSIMAE-S",
            "--device", "cpu", "--batch-size", "30", "--out", str(tmp_path)]
    one = cli.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    two = cli.main(argv + ["--dp", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    np.testing.assert_array_equal(two.pred_map, one.pred_map)
    assert one.launches_by_rank is None and len(two.launches_by_rank) == 2
    assert sorted(os.listdir(tmp_path)) == ["scene_pred.png", "scene_pred_masked.png"]

"""The port's background checkpoint backend (``--ckpt-backend orbax``, no
orbax used: :mod:`hsimae_tpu_torch.checkpoints.async_io`) and ``--profile``,
held to the contract ``tests/test_resume.py`` holds JAX's orbax backend to:

* a run stopped after two epochs and resumed from the background writer's
  checkpoint equals the uninterrupted run (epoch loss rtol 1e-5, parameters
  rtol 1e-5 / atol 1e-6, as the JAX test);
* a resume with the other backend than the workdir was written with raises,
  in both directions;
* retention keeps the newest ``max_to_keep`` (0 or None: all) and a
  checkpoint round-trips model and optimizer exactly;
* ``--profile DIR`` writes one trace, of the second epoch.

Tiny model (embed 32, depth 2), on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints.async_io import AsyncCheckpointer, checkpoint_steps
from hsimae_tpu_torch.data.gwpca import apply_gwpca
from hsimae_tpu_torch.data.pipeline import MultiScenePatchSource
from hsimae_tpu_torch.data.synthetic import make_synthetic_pretrain_scenes
from hsimae_tpu_torch.data.windows import build_pretrain_cut_index
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.train import pretrain as tpt
from hsimae_tpu_torch.train.optim import pretrain_optimizer

TINY = tcfg.preset("HSIMAE-S", depth=2, s_depth=1, decoder_depth=1, embed_dim=32, num_heads=2,
                   decoder_dim=16, decoder_num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the fast tier runs six
    pytest workers on the machine's cores, and torch's default pool (a
    thread per core in each worker) oversubscribes them, which made these
    small-op tests ~8x slower. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    scenes = [apply_gwpca(s, 32) for s in
              make_synthetic_pretrain_scenes(2, (30, 40), bands=48, seed=3)]
    src = MultiScenePatchSource(scenes, patch_size=9, device="cpu")
    idx = build_pretrain_cut_index([s.shape for s in scenes], 9, coarse_from=1)
    return src, idx.locs


def config(backend="orbax", **kw):
    return tcfg.PretrainConfig(epochs=3, batch_size=32, log_every=10**9,
                               checkpoint_every_steps=1, checkpoint_backend=backend, **kw)


def test_background_resume_equals_uninterrupted(tmp_path, corpus):
    src, locs = corpus
    cfg = config()
    full, hist_full = tpt.run_pretraining(src, locs, TINY, cfg, resume=False, device="cpu")
    wd = str(tmp_path)
    tpt.run_pretraining(src, locs, TINY, cfg, workdir=wd, resume=False, stop_after_epochs=2,
                        device="cpu")
    spe = int(np.ceil(len(locs) / 32))
    assert checkpoint_steps(wd) == [spe, 2 * spe]  # every epoch, both kept (max 3)
    res, hist_res = tpt.run_pretraining(src, locs, TINY, cfg, workdir=wd, resume=True,
                                        device="cpu")
    assert len(hist_res["epoch_loss"]) == 1 and len(hist_res["checkpoint_seconds"]) == 1
    np.testing.assert_allclose(hist_res["epoch_loss"][0], hist_full["epoch_loss"][2], rtol=1e-5)
    for (name, a), b in zip(full.state_dict().items(), res.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    assert checkpoint_steps(wd) == [spe, 2 * spe, 3 * spe]
    assert not any(n.startswith("ckpt_") for n in os.listdir(wd))  # no synchronous files


@pytest.mark.parametrize("written,resumed", [("msgpack", "orbax"), ("orbax", "msgpack")])
def test_resume_with_flipped_backend_errors(tmp_path, corpus, written, resumed):
    src, locs = corpus
    wd = str(tmp_path)
    tpt.run_pretraining(src, locs, TINY, config(written), workdir=wd, resume=False,
                        stop_after_epochs=1, device="cpu")
    with pytest.raises(RuntimeError, match="ckpt-backend"):
        tpt.run_pretraining(src, locs, TINY, config(resumed), workdir=wd, resume=True,
                            device="cpu")


@pytest.mark.parametrize("max_keep,kept", [(2, [11, 17]), (None, [5, 11, 17])])
def test_retention_and_round_trip(tmp_path, max_keep, kept):
    model = th.build_hsimae(TINY, seed=1, device="cpu")
    opt = pretrain_optimizer(model, 1e-3, 0.05, 10, mu_dtype=torch.bfloat16)[0]
    x = torch.rand(4, 9, 9, 32)
    with AsyncCheckpointer(str(tmp_path), max_to_keep=max_keep) as ck:
        for step in (5, 11, 17):
            tpt.make_pretrain_step(model, opt, lambda k: 1e-3)(x, 2, 9)
            ck.save(step, model, opt)
            saved = {k: v.clone() for k, v in model.state_dict().items()}
        ck.wait()
        assert ck.latest_step() == 17
    assert sorted(int(n) for n in os.listdir(tmp_path)) == kept
    assert os.listdir(tmp_path / "17") == ["state.pt"]  # no temporary file is left
    other = th.build_hsimae(TINY, seed=9, device="cpu")
    other_opt = pretrain_optimizer(other, 1e-3, 0.05, 10, mu_dtype=torch.bfloat16)[0]
    with AsyncCheckpointer(str(tmp_path), max_to_keep=max_keep) as ck2:
        assert ck2.restore_latest(other, other_opt) == 17
    for k, v in other.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert other_opt.count == opt.count == 3 and other_opt.mu[0][0].dtype == torch.bfloat16
    for a, b in zip(other_opt.nu[0], opt.nu[0]):
        assert torch.equal(a, b)
    assert AsyncCheckpointer(str(tmp_path / "empty")).restore_latest(other, other_opt) is None


def test_cli_background_backend_and_profile(tmp_path):
    """``--ckpt-backend orbax --ckpt-max-keep 2 --profile DIR`` over three
    epochs: two checkpoints kept, one trace, of epoch 2 (index 1)."""
    from hsimae_tpu_torch.cli import pretrain as cli

    prof = tmp_path / "prof"
    argv = ["--synthetic", "--synthetic-scenes", "2", "--synthetic-size", "20",
            "--synthetic-bands", "40", "--model", "HSIMAE-S", "--no-bf16", "--epochs", "3",
            "--batch-size", "64", "--device", "cpu", "--workdir", str(tmp_path / "wd"),
            "--checkpoint-every", "1", "--ckpt-backend", "orbax", "--ckpt-max-keep", "2",
            "--profile", str(prof)]
    _, hist = cli.main(argv)
    assert len(hist["epoch_loss"]) == 3 and np.isfinite(hist["epoch_loss"]).all()
    steps = checkpoint_steps(str(tmp_path / "wd"))
    assert len(steps) == 2 and 3 * steps[0] == 2 * steps[1]  # epochs 2 and 3 of 3
    assert os.listdir(prof) == ["epoch_1.trace.json"]
    trace = json.load(open(prof / "epoch_1.trace.json"))
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])

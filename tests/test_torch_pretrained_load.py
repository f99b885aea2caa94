"""``--pretrained`` train-state checkpoints in the port's fine-tuning: a JAX
``save_checkpoint`` file (``{step, params, opt_state}``) and the port's own
``ckpt_{step}.pt`` (``{model, optimizer, step}``) give the fine-tune every
encoder tensor, as the JAX loop does when it unwraps ``params``; the
loaded/target counts line is JAX's ``partial_restore`` line; a file that
covers no encoder parameter raises.

The encoder's rate is 0 (``--encoder-lr-scale 0``), so after one epoch the
encoder must equal the checkpoint's weights exactly (float32 copies)."""

import os

import jax
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from hsimae_tpu import config as jcfg
from hsimae_tpu.checkpoints import io as jio
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints import io as tio
from hsimae_tpu_torch.checkpoints.convert import load_any_checkpoint
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.train.optim import pretrain_optimizer

ARGV = ["--synthetic", "--synthetic-size", "20", "--synthetic-bands", "40",
        "--synthetic-classes", "3", "--model", "HSIMAE-S", "--no-bf16", "--epochs", "1",
        "--samples-per-class", "5", "--batch-size", "8", "--device", "cpu",
        "--encoder-lr-scale", "0"]
ENCODER = ("patch_embed.", "blocks_1.", "blocks_2.", "blocks.", "norm.")


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


def finetune(path):
    from hsimae_tpu_torch.cli import finetune as cli

    res, _ = cli.main(ARGV + ["--pretrained", path])
    assert np.isfinite(res.history["loss"]).all()
    return res.params


def counts_line(out: str) -> str:
    return next(line for line in out.splitlines() if line.startswith("[partial_restore]"))


def jax_tree(model, seed):
    """A tree of ``model``'s parameter shapes with seeded values (no compile)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jh.init_model(model, seed=0))["params"]
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def test_jax_train_state_checkpoint_loads_every_encoder_tensor(tmp_path, capsys):
    jc = jcfg.preset("HSIMAE-S")
    params = jax_tree(jh.build_hsimae(jc), 5)
    state = train_state.TrainState.create(apply_fn=None, params=params, tx=optax.adamw(1e-3))
    path = jio.save_checkpoint(str(tmp_path), 7, state)
    assert path.endswith("ckpt_7.msgpack")
    got = finetune(path)
    line = counts_line(capsys.readouterr().out)
    # JAX's own line for the same restore: the DualViT's tree from this train state's params
    jio.partial_restore(jax_tree(jh.build_dual_vit(jc, 4, drop_path=0.2), 0), params)
    assert line == counts_line(capsys.readouterr().out)
    want = load_any_checkpoint(path, tcfg.preset("HSIMAE-S", compute_dtype=torch.float32))
    enc = [k for k in want if k.startswith(ENCODER)]
    assert len(enc) > 100
    for k in enc:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    np.testing.assert_array_equal(got["blocks_1.0.attn.q.weight"].numpy(),
                                  np.asarray(params["blocks_1_0"]["attn"]["q"]["kernel"]).T)


def test_port_train_state_checkpoint_loads_every_encoder_tensor(tmp_path, capsys):
    tc = tcfg.preset("HSIMAE-S", compute_dtype=torch.float32)
    model = th.build_hsimae(tc, seed=4, device="cpu")
    opt = pretrain_optimizer(model, 1e-3, 0.05, 10)[0]
    path = tio.save_checkpoint(str(tmp_path), 3, model, opt)
    assert os.path.basename(path) == "ckpt_3.pt"
    got = finetune(path)
    n_params = len(list(th.build_dual_vit(tc, 4, device="cpu").named_parameters()))
    n_loaded = len(list(model.named_parameters()))  # the pretrain model's: all but the head
    assert counts_line(capsys.readouterr().out) == (
        f"[partial_restore] loaded {n_loaded} / target {n_params} leaves; ignored 0 source leaves")
    sd = model.state_dict()
    for k in sd:
        if k.startswith(ENCODER):
            torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0, msg=k)


def test_checkpoint_without_encoder_keys_raises(tmp_path):
    path = str(tmp_path / "other.pt")
    torch.save({"model": {"head.weight": torch.zeros(3, 3)}, "optimizer": {}, "step": 1}, path)
    with pytest.raises(ValueError, match="no encoder parameter"):
        finetune(path)

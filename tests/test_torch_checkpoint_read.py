"""Port parity for reading weight files without JAX: the msgpack decoder of
``hsimae_tpu_torch.checkpoints.msgpack_io`` against ``flax``'s
``msgpack_restore`` (bit-equal leaves: float32, bfloat16, int32, scalars, a
leaf written in chunks), the banked HSIMAE-B pretrain read both ways, a
reference-style torch file (``export_torch_state_dict`` then ``torch.save``,
bare and wrapped) classified by both packages (logits within 1e-5), and
``--pretrained x.msgpack`` through the port's fine-tune CLI."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from hsimae_tpu import config as jcfg
from hsimae_tpu.checkpoints import io as jio
from hsimae_tpu.checkpoints import torch_convert as jtc
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints import convert as tconv
from hsimae_tpu_torch.checkpoints import msgpack_io as tmsg
from hsimae_tpu_torch.train.evaluate import build_classifier

REPO = Path(__file__).resolve().parents[1]
BANKED = REPO / "artifacts/texture/HSIMAE-B@v2@enc0@dec2x48_params_final.msgpack"
SMALL = dict(embed_dim=32, num_heads=2, depth=2, s_depth=1, decoder_dim=16, decoder_num_heads=2,
             decoder_depth=1)
NC = 5


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,))
    else:
        yield prefix, tree


def bits(leaf) -> tuple:
    """(kind, shape, dtype name, raw bytes) of a leaf of either reader."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return ("array", tuple(leaf.shape), "bfloat16", leaf.view(torch.uint16).numpy().tobytes())
    if isinstance(leaf, (np.ndarray, np.generic)):
        kind = "array" if isinstance(leaf, np.ndarray) else "scalar"
        return (kind, leaf.shape, leaf.dtype.name, np.ascontiguousarray(leaf).tobytes())
    return ("py", type(leaf).__name__, leaf)


def assert_trees_bit_equal(got, want):
    g, w = dict(flat(got)), dict(flat(want))
    assert set(g) == set(w)
    for k in w:
        assert bits(g[k]) == bits(w[k]), k


def test_msgpack_reader_bit_equal_to_flax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    tree = {
        "enc": {"kernel": rng.standard_normal((7, 5)).astype(np.float32),
                "bias": rng.standard_normal(5).astype(np.float32)},
        "half": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16),
        "ids": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
        "big": rng.standard_normal((40, 3)).astype(np.float32),  # 480 bytes: chunked
        "big_half": jnp.asarray(rng.standard_normal(300), jnp.bfloat16),  # 600 bytes: chunked
        "empty": np.zeros((0, 3), np.float32),
        "step": np.int32(17), "scale": np.float32(0.125), "count": 3, "neg": -70000,
        "lr": 1.5e-3, "flag": True, "none": None, "name": "hsimae", "c": 1 + 2j,
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    path = jio.save_params(str(tmp_path / "p.msgpack"), tree)
    raw = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in raw
    want = serialization.msgpack_restore(raw)
    got = tmsg.load_params(path)
    assert_trees_bit_equal(got, want)
    assert got["big"].shape == (40, 3) and got["big_half"].shape == (300,)
    assert got["half"].dtype == torch.bfloat16


def test_banked_hsimae_b_read_bit_equal():
    """The banked HSIMAE-B pretrain (decoder 48 x 2): the port's reader and
    weight map against JAX's reader and the same map."""
    tc = tcfg.preset("HSIMAE-B", decoder_dim=48, decoder_depth=2)
    want_tree = jio.load_params(str(BANKED))
    assert_trees_bit_equal(tmsg.load_params(str(BANKED)), want_tree)
    got = tconv.load_any_checkpoint(str(BANKED), tc)
    want = tconv.from_jax_params(jax.tree_util.tree_map(np.asarray, want_tree), tc)
    assert set(got) == set(want) and len(got) > 400
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def test_bf16_leaves_map_like_jax():
    """A bfloat16 tree reaches the state dict as float32, bit for bit."""
    jc = jcfg.preset("HSIMAE-S", **SMALL)
    tc = tcfg.preset("HSIMAE-S", **SMALL)
    params = jh.init_model(jh.build_hsi_vit(jc, NC), seed=1)["params"]
    half = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16), params)
    want = jtc.export_torch_state_dict(half, jc)
    got = tconv.from_jax_params(tmsg.msgpack_restore(serialization.to_bytes(half)), tc)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k], np.float32), err_msg=k)


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "wrapped"])
def test_reference_pkl_classifies_like_jax(tmp_path, wrapped):
    jc = jcfg.preset("HSIMAE-S", **SMALL)
    tc = tcfg.preset("HSIMAE-S", **SMALL, compute_dtype=torch.float32)
    model = jh.build_hsi_vit(jc, NC)
    params = jh.init_model(model, seed=3)["params"]
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in jtc.export_torch_state_dict(params, jc).items()}
    path = str(tmp_path / "ref.pkl")
    torch.save({"state_dict": sd, "epoch": 200} if wrapped else sd, path)

    x = np.random.default_rng(4).standard_normal((6, 9, 9, 32)).astype(np.float32)
    tgt = jh.init_model(model, seed=0)["params"]
    restored, loaded, _ = jio.partial_restore(tgt, jtc.load_torch_checkpoint(path), verbose=False)
    assert len(loaded) == len(list(flat(tgt)))
    want = np.asarray(model.apply({"params": restored}, x, False, method=jh.HSIMAE.classify))

    got_sd = tconv.load_any_checkpoint(path, tc)
    assert set(got_sd) == set(sd)
    clf = build_classifier(got_sd, tc, NC, device="cpu", seed=9)
    with torch.inference_mode():
        got = clf.classify(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_finetune_cli_takes_msgpack_pretrained(tmp_path):
    """A JAX ``save_params`` file as ``--pretrained``: with the encoder's
    rate at 0 the fine-tuned encoder holds the file's weights."""
    from hsimae_tpu_torch.cli import finetune as cli

    jc = jcfg.preset("HSIMAE-S")
    params = jh.init_model(jh.build_hsimae(jc), seed=5)["params"]
    path = jio.save_params(str(tmp_path / "params_final.msgpack"), params)
    argv = ["--synthetic", "--synthetic-size", "20", "--synthetic-bands", "40",
            "--synthetic-classes", "3", "--model", "HSIMAE-S", "--no-bf16", "--epochs", "1",
            "--samples-per-class", "5", "--batch-size", "8", "--device", "cpu",
            "--encoder-lr-scale", "0", "--pretrained", path]
    res, ev = cli.main(argv)
    assert ev is None and np.isfinite(res.history["loss"]).all()
    kernel = np.asarray(params["blocks_1_0"]["attn"]["q"]["kernel"])
    np.testing.assert_array_equal(res.params["blocks_1.0.attn.q.weight"].numpy(), kernel.T)
    assert not os.path.exists(tmp_path / "ft")

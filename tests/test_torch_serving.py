"""Port parity for serving: ``hsimae_tpu_torch.serving`` (int8 weights, the
exported classifier, its buckets and rules, the export CLI and the evaluate
CLI's ``--artifact``) against ``hsimae_tpu.serving``, on the CPU.

* int8: the port quantizes its ``[out, in]`` Linear weights per row and its
  5-D patch-embed weight per output channel; ``q8`` and ``scale`` equal the
  JAX package's, bit for bit, on every tensor of an HSIMAE-B-shaped tree,
  float32 and bfloat16, and inside a JAX int8 artifact.
* A CPU artifact's logits against JAX's live ``HSIMAE.classify`` on the
  same weights: 1e-4 (three blocks and the head, summed in another order
  than XLA, as ``test_torch_evaluate.py``); the int8 artifact against JAX's
  int8 artifact: 1e-4. int8 against the float32 weights: relative L2 < 0.02
  and the same labels; int8 with bfloat16 weights: < 0.05 (JAX's bounds).
* Bucket, padding, chunk, empty-batch and label rules as
  ``tests/test_serving.py`` holds JAX's.

The model is narrow (embed 32, depth 3, s_depth 2, 2 heads), float32; JAX's
export runs once (one bucket, CPU)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu.serving import export as jexp
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.ops import fused_block as tfb
from hsimae_tpu_torch.serving import export as texp

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(embed_dim=32, num_heads=2, depth=3, s_depth=2, decoder_depth=1)
NC = 5
JC, TC = jcfg.preset("HSIMAE-S", **SMALL), tcfg.preset("HSIMAE-S", **SMALL)
RNG_X = np.random.default_rng(0).standard_normal((19, 9, 9, 32)).astype(np.float32)


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


def export(params, cfg=TC, **kw):
    kw.setdefault("batch_sizes", (2, 8))
    return texp.export_classifier(params, cfg, NC, platforms=("cpu",), **kw)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX weights, their port state dict, JAX's live logits on RNG_X, a port
    float32 artifact on disk (buckets 2, 8) and a JAX int8 artifact
    (bucket 8)."""
    model = jh.build_hsi_vit(JC, NC)
    params = jax.tree_util.tree_map(np.asarray, jh.init_model(model, seed=3)["params"])
    live = np.asarray(jax.jit(lambda p, x: model.apply({"params": p}, x, False,
                                                       method=jh.HSIMAE.classify))(params, RNG_X))
    sd = from_jax_params(params, TC)
    path = str(tmp_path_factory.mktemp("srv") / "model.pt2")
    texp.save_classifier(path, export(sd))
    jblob = jexp.export_classifier(params, JC, NC, batch_sizes=(8,), platforms=("cpu",),
                                   quantize="int8")
    return {"params": params, "sd": sd, "live": live, "path": path, "jax_int8": jblob}


@pytest.fixture(scope="module")
def clf(case):
    return texp.load_classifier(case["path"], device="cpu")


def hsimae_b_tree(dtype):
    """An HSIMAE-B classifier tree of seeded values (shapes from JAX's init,
    one zero output channel to take the zero-scale branch)."""
    shapes = jax.eval_shape(lambda: jh.init_model(jh.build_hsi_vit(jcfg.PRESETS["HSIMAE-B"], 17),
                                                  seed=0))["params"]
    rng = np.random.default_rng(1)

    def fill(s):
        a = rng.standard_normal(s.shape).astype(np.float32)
        if a.ndim == 2:
            a = a * rng.gamma(2.0, 1.0, (1, a.shape[1])).astype(np.float32)
            a[:, 3] = 0.0
        return a.astype(dtype)

    return jax.tree_util.tree_map(fill, shapes)


def split_q8(tree, part):
    """The JAX quantized tree with each {q8, scale} kernel replaced by its
    ``q8``, or by its ``scale`` broadcast to the kernel's shape (so
    from_jax_params lays it out as the port's weight)."""
    if isinstance(tree, dict):
        if set(tree) == {"q8", "scale"}:
            q8 = np.asarray(tree["q8"])
            return q8 if part == "q8" else np.broadcast_to(tree["scale"], q8.shape)
        return {k: split_q8(v, part) for k, v in tree.items()}
    return np.zeros(0, np.float32)


def assert_q8_equal(jq, tq, cfg):
    """Port int8 tensors equal JAX's, mapped by from_jax_params's layout rule."""
    jq8, jsc = (from_jax_params(split_q8(jq, part), cfg) for part in ("q8", "scale"))
    quantized = {k for k, v in tq.items() if isinstance(v, dict)}
    assert quantized == {k for k, v in jq8.items() if v.dim() >= 2 and k != "pos_embed"}
    assert "patch_embed.proj.weight" in quantized and "cls_head.weight" in quantized
    for k in quantized:
        assert tq[k]["q8"].dtype == torch.int8 and tq[k]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(tq[k]["q8"].float().numpy(), jq8[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(tq[k]["scale"].expand_as(tq[k]["q8"]).numpy(),
                                      jsc[k].numpy(), err_msg=k)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
def test_int8_bit_equal_to_jax_on_hsimae_b_tree(dtype):
    tree = hsimae_b_tree(dtype)
    cfg = tcfg.PRESETS["HSIMAE-B"]
    sd = from_jax_params(tree, cfg)  # float32 copies of the (bf16) values
    if dtype is not np.float32:
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tq = texp.quantize_params_int8(sd)
    assert_q8_equal(jexp.quantize_params_int8(tree), tq, cfg)
    assert tq["norm.weight"].dtype == sd["norm.weight"].dtype  # 1-D tensors stay


def test_int8_artifact_holds_jax_artifacts_weights(case):
    from flax import serialization

    jbundle = serialization.msgpack_restore(case["jax_int8"])
    blob = export(case["sd"], quantize="int8", batch_sizes=(8,))
    clf = texp.load_classifier(blob, device="cpu")
    assert clf.quantize == "int8"
    assert_q8_equal(jbundle["params"]["params"], clf.params, TC)


def test_artifact_logits_match_jax_live(case, clf):
    got = clf.predict_logits(RNG_X[:8])
    assert got.dtype == np.float32 and got.shape == (8, NC)
    np.testing.assert_allclose(got, case["live"][:8], rtol=1e-4, atol=1e-4)


def test_int8_artifact_logits_match_jax_int8_artifact(case):
    jclf = jexp.load_classifier(case["jax_int8"])
    clf = texp.load_classifier(export(case["sd"], quantize="int8", batch_sizes=(8,)), "cpu")
    np.testing.assert_allclose(clf.predict_logits(RNG_X[:8]), jclf.predict_logits(RNG_X[:8]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 3, 8, 19], ids=["pad1to2", "pad3to8", "exact8", "chunk19"])
def test_buckets_padding_and_chunks(case, clf, n):
    # n=1 pads into the 2-bucket, n=3 into the 8-bucket, n=8 exact; 19 = 8 + 8 + pad(3->8)
    got = clf.predict_logits(RNG_X[:n])
    assert got.shape == (n, NC)
    np.testing.assert_allclose(got, case["live"][:n], rtol=1e-4, atol=1e-4)


def test_predict_labels_are_1based_background_excluded(case, clf):
    labels = clf.predict(RNG_X[:4])
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, np.argmax(case["live"][:4, 1:], axis=1) + 1)
    assert clf.predict_logits(np.zeros((0, 9, 9, 32), np.float32)).shape == (0, NC)


def test_tensor_in_tensor_out(clf):
    x = torch.from_numpy(RNG_X[:3])
    logits, labels = clf.predict_logits(x), clf.predict(x)
    assert isinstance(logits, torch.Tensor) and logits.device.type == "cpu"
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(logits.numpy(), clf.predict_logits(RNG_X[:3]))


def test_artifact_metadata_round_trip(clf):
    assert clf.num_classes == NC and clf.batch_sizes == [2, 8] and clf.platforms == ["cpu"]
    meta = clf.model_meta
    assert meta["embed_dim"] == TC.embed_dim and meta["compute_dtype"] == "float32"
    assert getattr(torch, meta["compute_dtype"]) == TC.compute_dtype
    assert clf.quantize is None and clf.params_dtype is None
    assert texp._unjsonify({"a": "__none__", "b": {"c": "__none__"}, "d": 3}) == \
        {"a": None, "b": {"c": None}, "d": 3}
    assert texp._jsonify({"a": None, "b": torch.bfloat16, "c": (1, 2)}) == \
        {"a": "__none__", "b": "bfloat16", "c": [1, 2]}


def test_rejections(case):
    pre = th.build_hsimae(TC, device="cpu").state_dict()
    with pytest.raises(ValueError, match="cls_head"):  # a pretrain-only checkpoint
        export(pre, batch_sizes=(2,))
    with pytest.raises(ValueError, match="unsupported quantize"):
        export(case["sd"], batch_sizes=(2,), quantize="int4")
    with pytest.raises(ValueError, match="JAX .hsix"):
        texp.load_classifier(case["jax_int8"], device="cpu")
    with pytest.raises(ValueError, match="not for cuda"):  # never the CPU program instead
        texp.load_classifier(case["path"], device="cuda")


def test_evaluate_cli_rejects_params_and_artifact_together():
    from hsimae_tpu_torch.cli.evaluate import main as eval_main

    with pytest.raises(SystemExit):
        eval_main(["--synthetic", "--params", "a", "--artifact", "b", "--device", "cpu"])
    with pytest.raises(SystemExit):  # no artifact: the class count is needed
        eval_main(["--synthetic", "--device", "cpu"])


def test_mismatched_model_args_warn(case):
    # SwiGLU widths differ: the encoder MLPs stay at init, the head matches
    other = TC.replace(mlp_ratio=2.0)
    with pytest.warns(UserWarning, match="random init"):
        export(case["sd"], other, batch_sizes=(2,))


def test_int8_size_error_and_labels(case):
    blob32 = export(case["sd"], batch_sizes=(8,))
    blob8 = export(case["sd"], batch_sizes=(8,), quantize="int8")
    assert len(blob8) < 0.6 * len(blob32)
    clf = texp.load_classifier(blob8, device="cpu")
    assert set(clf.params["cls_head.weight"]) == {"q8", "scale"}
    got, ref = clf.predict_logits(RNG_X[:8]), case["live"][:8]
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02
    np.testing.assert_array_equal(clf.predict(RNG_X[:8]), np.argmax(ref[:, 1:], axis=1) + 1)


def test_int8_plus_bf16_quantizes_kernels(case):
    clf = texp.load_classifier(export(case["sd"], batch_sizes=(8,), params_dtype="bfloat16",
                                      quantize="int8"), device="cpu")
    q = clf.params["cls_head.weight"]
    assert set(q) == {"q8", "scale"} and q["q8"].dtype == torch.int8
    assert clf.params["norm.weight"].dtype == torch.bfloat16 and clf.params_dtype == "bfloat16"
    got, ref = clf.predict_logits(RNG_X[:8]), case["live"][:8]
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.05


def test_quantize_dequantize_error_bound():
    """|deq - w| <= scale / 2 element by element, scales per output row."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((48, 64)) * rng.gamma(2.0, 1.0, (48, 1)))
                         .astype(np.float32))
    q = texp.quantize_params_int8({"m.weight": w, "m.bias": torch.ones(48)})
    assert q["m.weight"]["scale"].shape == (48, 1) and torch.equal(q["m.bias"], torch.ones(48))
    deq = texp.dequantize_params(q, torch.float32)["m.weight"]
    assert torch.all((deq - w).abs() <= q["m.weight"]["scale"] / 2 + 1e-7)


def test_load_builds_kernel_weights_once(case, monkeypatch):
    calls = []
    real = tfb.kernel_weights
    monkeypatch.setattr(tfb, "kernel_weights", lambda *a: calls.append(1) or real(*a))
    clf = texp.load_classifier(case["path"], device="cpu")
    n_blocks = 2 * TC.s_depth + TC.fusion_depth
    assert len(calls) == n_blocks
    for n in (1, 8, 19):
        clf.predict_logits(RNG_X[:n])
    assert len(calls) == n_blocks  # no pack is built per request


def test_export_cli_and_evaluate_artifact_equal_params_run(tmp_path, capsys):
    """cli.export, then cli.evaluate --artifact: the map equals cli.evaluate
    --params on the same weights; the artifact also loads and predicts in a
    process where hsimae_tpu_torch.models cannot be imported."""
    from hsimae_tpu_torch.cli import evaluate as cli_eval
    from hsimae_tpu_torch.cli import export as cli_export

    mcfg = tcfg.preset("HSIMAE-S", compute_dtype=torch.float32)
    ckpt = str(tmp_path / "ft.pt")
    torch.save(th.build_hsi_vit(mcfg, NC, seed=2, device="cpu").state_dict(), ckpt)
    art = str(tmp_path / "m.pt2")
    cli_export.main(["--params", ckpt, "--num-classes", str(NC), "--output", art,
                     "--batch-sizes", "64", "--platforms", "cpu", "--model", "HSIMAE-S",
                     "--no-bf16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"artifact": art, "bytes": os.path.getsize(art), "batch_sizes": [64],
                    "platforms": ["cpu"], "quantize": None}

    rng = np.random.default_rng(0)
    np.save(tmp_path / "scene.npy", rng.standard_normal((12, 11, 32)).astype(np.float32))
    np.save(tmp_path / "gt.npy", rng.integers(0, NC, (12, 11)).astype(np.int32))
    common = ["--scene", str(tmp_path / "scene.npy"), "--gt", str(tmp_path / "gt.npy"),
              "--no-gwpca", "--batch-size", "64", "--device", "cpu", "--no-bf16",
              "--model", "HSIMAE-S"]
    live = cli_eval.main(common + ["--params", ckpt, "--num-classes", str(NC)])
    art_res = cli_eval.main(common + ["--artifact", art, "--out", str(tmp_path / "png")])
    np.testing.assert_array_equal(art_res.pred_map, live.pred_map)
    assert art_res.metrics.oa == live.metrics.oa
    assert sorted(os.listdir(tmp_path / "png")) == ["scene_pred.png", "scene_pred_masked.png"]

    x = rng.standard_normal((5, 9, 9, 32)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    code = textwrap.dedent(f"""
        import sys, numpy as np
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == "hsimae_tpu_torch.models" or name.startswith("hsimae_tpu_torch.models."):
                    raise ImportError("the model source is not deployed")
        sys.meta_path.insert(0, Block())
        from hsimae_tpu_torch.serving import load_classifier
        clf = load_classifier({art!r}, device="cpu")
        np.save({str(tmp_path / 'y.npy')!r}, clf.predict_logits(np.load({str(tmp_path / 'x.npy')!r})))
        assert not any(n.startswith("hsimae_tpu_torch.models") for n in sys.modules)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    want = texp.load_classifier(art, device="cpu").predict_logits(x)
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)

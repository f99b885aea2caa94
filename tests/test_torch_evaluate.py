"""Port parity for the slice as a whole: HSIMAE ``classify`` and full-scene
classification of ``hsimae_tpu_torch`` against ``hsimae_tpu``, with JAX
weights carried across by ``from_jax_params``; plus the weight mapping and
the port's import hygiene (no JAX anywhere in the package or chip_smoke.py).

Models are narrow (embed 32, depth 3, s_depth 2, 2 heads) and run in f32;
one case runs HSIMAE-L's width (embed 256, 16 heads, SwiGLU 684) at the
same depth. Logit tolerance 1e-4: three blocks plus the head, each summing
in another order than XLA."""

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
from hsimae_tpu.checkpoints.torch_convert import export_torch_state_dict
from hsimae_tpu.data.gwpca import apply_gwpca
from hsimae_tpu.data.synthetic import make_synthetic_scene
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu.train import evaluate as jev
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.ops import fused_block as tfb
from hsimae_tpu_torch.train import evaluate as tev

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(embed_dim=32, num_heads=2, depth=3, s_depth=2, decoder_depth=1)
# HSIMAE-L's width and heads (its hidden width follows), depth cut as SMALL's
WIDE_L = dict(SMALL, embed_dim=256, num_heads=16)
NUM_CLASSES = 5


def configs(size=SMALL, **kw):
    return jcfg.preset("HSIMAE-S", **size, **kw), tcfg.preset("HSIMAE-S", **size, **kw)


def jax_params(jc, num_classes=NUM_CLASSES, seed=0):
    params = jh.init_model(jh.build_hsi_vit(jc, num_classes), seed=seed)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jax_xla", "jax_fused_path"])
@pytest.mark.parametrize("head_mode,size", [("agg", SMALL), ("gap", SMALL), ("agg", WIDE_L)],
                         ids=["agg", "gap", "agg-D256"])
def test_classify_logits_match_jax(head_mode, size, use_pallas):
    jc, tc = configs(size, head_mode=head_mode)
    params = jax_params(jc)
    x = np.random.default_rng(1).standard_normal((6, 9, 9, 32)).astype(np.float32)
    jm = jh.build_hsi_vit(jc.replace(use_pallas=use_pallas), NUM_CLASSES)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, False,
                                                    method=jh.HSIMAE.classify))(params, x))
    assert tc.use_kernel  # the port's inference path goes through the fused-block wrapper
    model = th.build_hsi_vit(tc, NUM_CLASSES, device="cpu", state_dict=from_jax_params(params, tc))
    before = (tfb.TF32X3_LAUNCHES, tfb.TF32X3_D256_LAUNCHES, tfb.WGMMA_LAUNCHES)
    with torch.inference_mode():
        got = model.classify(torch.from_numpy(x)).numpy()
    # CPU tensors take the plain version
    assert (tfb.TF32X3_LAUNCHES, tfb.TF32X3_D256_LAUNCHES, tfb.WGMMA_LAUNCHES) == before
    assert got.shape == (6, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_kernel_path_equals_module_path():
    """use_kernel on (fused wrapper -> plain version on CPU) and off (the
    Block modules) give the same logits."""
    _, tc = configs()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 9, 9, 32)).astype(np.float32))
    a = th.build_hsi_vit(tc, NUM_CLASSES, seed=3, device="cpu")
    b = th.build_hsi_vit(tc.replace(use_kernel=False), NUM_CLASSES, seed=3, device="cpu")
    with torch.inference_mode():
        torch.testing.assert_close(a.classify(x), b.classify(x), rtol=2e-5, atol=2e-5)


def test_kernel_params_built_once_and_rebuilt_after_a_weight_change():
    """The kernel-layout weights are made on the first inference call, reused
    after, and rebuilt when a weight is loaded or changed in place."""
    _, tc = configs()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, 9, 32)).astype(np.float32))
    model = th.build_hsi_vit(tc, NUM_CLASSES, seed=3, device="cpu")
    ref = th.build_hsi_vit(tc.replace(use_kernel=False), NUM_CLASSES, seed=4, device="cpu")
    with torch.inference_mode():
        model.classify(x)
        first = model.kernel_params("blocks_1")
        model.classify(x)
        assert all(a.wq is b.wq for a, b in zip(first, model.kernel_params("blocks_1")))
        model.load_state_dict(ref.state_dict())  # in-place copies: new versions
        assert model.kernel_params("blocks_1")[0].wq is not first[0].wq
        torch.testing.assert_close(model.classify(x), ref.classify(x), rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        model.blocks[0].attn.q.weight.mul_(2.0)
        ref.blocks[0].attn.q.weight.mul_(2.0)
    with torch.inference_mode():
        torch.testing.assert_close(model.classify(x), ref.classify(x), rtol=2e-5, atol=2e-5)


def test_from_jax_params_matches_export_and_loads_strict():
    jc, tc = configs()
    params = jax_params(jc)
    want = export_torch_state_dict(params, jc)
    got = from_jax_params(params, tc)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k], np.float32), err_msg=k)
    assert "blocks_1.1.attn.q.weight" in got and got["patch_embed.proj.weight"].dim() == 5
    model = th.build_hsi_vit(tc, NUM_CLASSES, device="cpu")
    model.load_state_dict(got, strict=True)


@pytest.fixture(scope="module")
def scene_case():
    scene, gt = make_synthetic_scene(16, 16, bands=40, n_classes=NUM_CLASSES - 1, seed=4)
    scene = apply_gwpca(scene, nc=32).astype(np.float32)
    jc, tc = configs()
    return scene, gt, jc, tc, jax_params(jc, seed=5)


def test_classify_scene_equal_map(scene_case):
    scene, _, jc, tc, params = scene_case
    want = jev.classify_scene(scene, params, jc, NUM_CLASSES, jcfg.EvalConfig(batch_size=96))
    got = tev.classify_scene(scene, from_jax_params(params, tc), tc, NUM_CLASSES,
                             tcfg.EvalConfig(batch_size=96), device="cpu")
    assert got.dtype == np.int32 and got.shape == (16, 16)
    assert got.min() >= 1
    np.testing.assert_array_equal(got, want)
    # the same model, built once, predicts the same map again
    model = tev.build_classifier(from_jax_params(params, tc), tc, NUM_CLASSES, device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(tev.predict_scene(model, scene, tcfg.EvalConfig(batch_size=96)),
                                      want)


def test_evaluate_scene_metrics_equal(scene_case):
    scene, gt, jc, tc, params = scene_case
    want = jev.evaluate_scene(scene, gt, params, jc, NUM_CLASSES, jcfg.EvalConfig(batch_size=256)).metrics
    got = tev.evaluate_scene(scene, gt, from_jax_params(params, tc), tc, NUM_CLASSES,
                             tcfg.EvalConfig(batch_size=256), device="cpu").metrics
    assert (got.oa, got.aa, got.kappa) == (want.oa, want.aa, want.kappa)


def test_classify_scene_requires_cls_head(scene_case):
    scene, _, _, tc, params = scene_case
    sd = {k: v for k, v in from_jax_params(params, tc).items() if not k.startswith("cls_head")}
    with pytest.raises(ValueError, match="cls_head"):
        tev.classify_scene(scene, sd, tc, NUM_CLASSES, device="cpu")


def test_scene_patch_source_matches_jax(scene_case):
    from hsimae_tpu.data.pipeline import ScenePatchSource as JSource
    from hsimae_tpu_torch.data.pipeline import ScenePatchSource as TSource

    scene = scene_case[0]
    idx = np.random.default_rng(6).integers(0, 256, 50)
    want = np.asarray(JSource(scene, 9).gather_pixels(idx))
    got = TSource(scene, 9, device="cpu").gather_pixels(idx).numpy()
    np.testing.assert_array_equal(got, want)


def test_cli_evaluate_on_cpu(tmp_path, capsys):
    from hsimae_tpu_torch.cli import evaluate as cli

    tc = tcfg.preset("HSIMAE-S", compute_dtype=torch.float32)
    sd_path = tmp_path / "sd.pt"
    torch.save(th.build_hsi_vit(tc, 4, seed=7, device="cpu").state_dict(), sd_path)
    argv = ["--model", "HSIMAE-S", "--no-bf16", "--synthetic", "--synthetic-size", "10",
            "--synthetic-bands", "40", "--synthetic-classes", "3", "--num-classes", "4",
            "--synthetic-seed", "0", "--batch-size", "64", "--device", "cpu"]
    res = cli.main(argv + ["--params", str(sd_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(__import__("json").loads(line)) == {"oa", "aa", "kappa", "per_class"}
    # no --params: the seeded init of --seed, i.e. the same weights
    res2 = cli.main(argv + ["--seed", "7"])
    np.testing.assert_array_equal(res.pred_map, res2.pred_map)


def test_cli_evaluate_test_split_and_colormaps_equal_jax(tmp_path, capsys):
    """Both evaluate CLIs read the same JAX ``save_params`` file, draw the
    same few-shot split again, score the held-out pixels and write the
    colormaps: equal JSON lines and equal PNG pixels."""
    from PIL import Image

    from hsimae_tpu.checkpoints.io import save_params
    from hsimae_tpu.cli import evaluate as jcli
    from hsimae_tpu_torch.cli import evaluate as tcli

    jc = jcfg.preset("HSIMAE-S")
    path = save_params(str(tmp_path / "finetuned.msgpack"),
                       jh.init_model(jh.build_hsi_vit(jc, 4), seed=6)["params"])
    argv = ["--model", "HSIMAE-S", "--no-bf16", "--synthetic", "--synthetic-size", "14",
            "--synthetic-bands", "40", "--synthetic-classes", "3", "--num-classes", "4",
            "--synthetic-seed", "0", "--params", path, "--samples-per-class", "5",
            "--seed", "3"]
    want_res = jcli.main(argv + ["--out", str(tmp_path / "jax")])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got_res = tcli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    np.testing.assert_array_equal(got_res.pred_map, want_res.pred_map)
    _, gt = make_synthetic_scene(14, 14, bands=40, n_classes=3, seed=0)
    # the metrics cover the labeled pixels less the 5-a-class training draw
    assert (tcli.prepare(tcli.build_parser().parse_args(argv))[1] != 0).sum() == (gt != 0).sum() - 15
    for name in ("scene_pred.png", "scene_pred_masked.png"):
        with Image.open(tmp_path / "port" / name) as a, Image.open(tmp_path / "jax" / name) as b:
            np.testing.assert_array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))


def test_port_imports_no_jax():
    """Every module of hsimae_tpu_torch, and chip_smoke.py, import without
    bringing jax, flax, optax or hsimae_tpu into the process."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import hsimae_tpu_torch
        for m in pkgutil.walk_packages(hsimae_tpu_torch.__path__, "hsimae_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hsimae_tpu"))
        print(len([n for n in sys.modules if n.startswith("hsimae_tpu_torch")]), bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 15  # every submodule was imported

"""Port parity for the benchmark harness (``hsimae_tpu_torch.bench``,
``utils/early_stop.py``, the harness's optimizers in ``train/optim.py`` and
``cli/benchmark.py``) against ``hsimae_tpu``, on the CPU.

* Every spec builds at PaviaU with as many parameter elements as the flax
  net (``jax.eval_shape`` of its init); ``epoch_lr`` equals JAX's for every
  spec at every epoch; ``preprocess_scene`` equals JAX's to 1e-6;
  ``EarlyStopping`` follows JAX's on scripted sequences, the first-call
  case included.
* The port's RMSprop and all-parameter-decay AdamW equal optax's (through
  JAX's ``make_optimizer``, the rate changed between steps) over 5 steps to
  1e-6.
* The harness against JAX's, trained, is in ``test_torch_bench_parity.py``.
* Injected flips and dropout masks are the draws ``train_baseline`` uses;
  JAX's tiny SSFTT run learns above chance in the port too (OA > 0.45);
  ``cli.benchmark`` gives JAX's report keys; ``test_zoo_model_export``:
  SSRN and its BatchNorm buffers through ``export_module_classifier``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hsimae_tpu.bench import harness as jh
from hsimae_tpu.bench import registry as jr
from hsimae_tpu.cli import benchmark as jcli
from hsimae_tpu.data.synthetic import make_synthetic_scene
from hsimae_tpu.utils.early_stop import EarlyStopping as JEarlyStopping
from hsimae_tpu_torch.bench import harness as th
from hsimae_tpu_torch.bench import registry as tr
from hsimae_tpu_torch.cli import benchmark as tcli
from hsimae_tpu_torch.train.optim import set_lr
from hsimae_tpu_torch.utils.early_stop import EarlyStopping


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (six pytest workers share
    the machine's cores; torch's default pool oversubscribes them).
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", tr.ALL_BASELINES)
def test_every_spec_builds_at_paviau(name):
    js, ts = jr.get_baseline_spec(name, "PaviaU"), tr.get_baseline_spec(name, "PaviaU")
    assert dataclasses.asdict(dataclasses.replace(ts, build=None)) == dataclasses.asdict(
        dataclasses.replace(js, build=None))
    bands = ts.pca_nc or tr.DATASETS["PaviaU"]["bands"]
    jm = js.build(bands, 10, "PaviaU")
    x = jnp.zeros((2, js.patch_size, js.patch_size, bands))
    shapes = jax.eval_shape(lambda v: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, v, False), x)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = ts.build(bands, 10, "PaviaU")
    assert sum(p.numel() for p in model.parameters()) == n_jax
    model.eval()
    with torch.no_grad():
        assert model(torch.zeros(2, ts.patch_size, ts.patch_size, bands)).shape == (2, 10)


def test_epoch_lr_matches_jax_for_every_spec():
    for name in tr.ALL_BASELINES:
        js, ts = jr.get_baseline_spec(name), tr.get_baseline_spec(name)
        for epoch in range(ts.epochs):
            # JAX's cosine runs in float32 (rounding ~1e-7 of the base rate),
            # the port's in float64
            assert th.epoch_lr(ts, 1e-3, epoch) == pytest.approx(
                jh.epoch_lr(js, 1e-3, epoch), rel=1e-6, abs=1e-3 * 1e-6), (name, epoch)


@pytest.mark.parametrize("name,resize", [("SSFTT", None), ("SSRN", None),
                                         ("GSC-ViT", (20, 12, 33))])
def test_preprocess_scene_matches_jax(name, resize):
    scene, _ = make_synthetic_scene(16, 18, bands=40, seed=0)
    ours = th.preprocess_scene(scene, tr.get_baseline_spec(name), resize=resize)
    ref = jh.preprocess_scene(scene, jr.get_baseline_spec(name), resize=resize)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_early_stopping_follows_jax():
    sequences = [
        [0.5, 0.4, 0.3, 0.2, 0.1],  # drops at once: the first call sets the best
        [0.1, 0.2, 0.2, 0.3, 0.25, 0.25, 0.25, 0.4],
        [0.3, 0.3, 0.29, 0.31, 0.305, 0.2, 0.1, 0.0],
    ]
    for seq in sequences:
        for delta in (0.0, 0.01):
            ours, ref = EarlyStopping(patience=3, delta=delta), JEarlyStopping(patience=3,
                                                                               delta=delta)
            for i, m in enumerate(seq):
                assert ours(m, value=i) == ref(m, value=i)
                assert (ours.counter, ours.best_metric, ours.best_value, ours.early_stop) == (
                    ref.counter, ref.best_metric, ref.best_value, ref.early_stop)


def _optimizer_steps_against_optax(name: str):
    """5 steps of the port's optimizer for spec ``name`` against JAX's
    ``make_optimizer`` (optax through ``inject_hyperparams``), the rate
    changed between steps, on fixed gradients. Returns the port optimizer."""
    rng = np.random.default_rng(0)
    module = torch.nn.Module()
    module.fc, module.norm = torch.nn.Linear(3, 4), torch.nn.LayerNorm(3)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    named = dict(module.named_parameters())
    grads = [{k: rng.standard_normal(p.shape).astype(np.float32) for k, p in named.items()}
             for _ in range(5)]
    lrs = [1e-3, 1e-3, 5e-4, 2.5e-4, 1e-3]
    js, ts = jr.get_baseline_spec(name), tr.get_baseline_spec(name)

    tx = jh.make_optimizer(js, lrs[0])
    params = {k: jnp.asarray(p.detach().numpy()) for k, p in named.items()}
    state = tx.init(params)
    for g, lr in zip(grads, lrs):
        state = jh._set_lr(state, lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)

    opt = th.make_optimizer(ts, module, lrs[0])
    for g, lr in zip(grads, lrs):
        set_lr(opt, lr)
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    return opt


def test_rmsprop_matches_optax():
    _optimizer_steps_against_optax("SSRN")  # RMSprop, momentum 0.9


def test_adamw_decays_every_parameter_as_optax():
    opt = _optimizer_steps_against_optax("GSC-ViT")  # AdamW, weight decay 0.05
    # biases and norm scales decay too: HSIMAE's wd_mask would skip them
    decayed = [n for g in opt.param_groups if g["weight_decay"] == 0.05 for n in g["names"]]
    assert sorted(decayed) == ["fc.bias", "fc.weight", "norm.bias", "norm.weight"]


def _tiny_scene():
    return make_synthetic_scene(20, 20, bands=24, n_classes=4, seed=3)


def test_train_baseline_takes_injected_draws():
    """Flips and dropout masks given to ``train_baseline`` are the draws it
    uses: two runs on the same injected draws (SSFTT, which has dropout)
    end bit for bit equal, every batch asked for its flips, and all-keep
    masks change the run."""
    from hsimae_tpu_torch.models.baselines.common import all_keep

    scene, gt = _tiny_scene()
    spec = dataclasses.replace(tr.get_baseline_spec("SSFTT"), epochs=2, batch_size=8, pca_nc=16)

    def run(masks):
        asked = []
        g = torch.Generator().manual_seed(1)

        def flips(epoch, step, n):
            asked.append((epoch, step, n))
            return torch.rand(n, generator=g) < 0.5, torch.rand(n, generator=g) < 0.5

        out, _, _ = th.train_baseline(scene, gt, spec, seed=2, device="cpu", flips=flips,
                                      dropout_masks=masks(g))
        return out, asked

    drawn = lambda g: lambda shape, keep, dev: torch.rand(tuple(shape), generator=g) < keep  # noqa
    a, asked = run(drawn)
    b, _ = run(drawn)
    c, _ = run(lambda g: all_keep)
    assert asked == [(e, s, 8) for e in range(2) for s in range(3)]  # 20 pixels, batches of 8
    assert all(torch.equal(a.state[k], b.state[k]) for k in a.state)
    assert a.history["loss"] == b.history["loss"] != c.history["loss"]


def test_train_baseline_end_to_end_tiny():
    """JAX's tiny SSFTT run (``tests/test_baselines.py``): above chance."""
    scene, gt = make_synthetic_scene(24, 24, bands=32, n_classes=4, seed=3)
    spec = dataclasses.replace(tr.get_baseline_spec("SSFTT"), epochs=15, batch_size=32, pca_nc=30)
    run, test_gt, scene_p = th.train_baseline(scene, gt, spec, lr=1e-3, samples_per_class=10,
                                              seed=0, device="cpu")
    m = th.evaluate_baseline(run, scene_p, test_gt, spec, int(gt.max()) + 1, device="cpu")
    assert m.oa > 0.45  # well above 1/4 chance


def test_cli_benchmark_gives_jax_report_keys(capsys):
    args = ["--synthetic", "--synthetic-size", "20", "--synthetic-bands", "24",
            "--synthetic-classes", "4", "--models", "RSSAN", "--lr-grid", "1e-3",
            "--selection-seeds", "1", "--test-seeds", "2", "--epochs", "1"]
    ours = tcli.main(args + ["--device", "cpu"])
    ref = jcli.main(args)
    assert set(ours) == set(ref) == {"RSSAN"}
    assert list(ours["RSSAN"]) == list(ref["RSSAN"])
    for k, v in ref["RSSAN"].items():
        assert type(ours["RSSAN"][k]) is type(v), k
    assert len(ours["RSSAN"]["per_seed_oa"]) == 2
    assert tcli.build_parser().parse_args([]).device == "cuda"


def test_zoo_model_export(tmp_path):
    """``export_module_classifier`` serves a zoo net: SSRN, whose BatchNorm
    buffers ride along in the artifact's weights (the counterpart of the JAX
    package's ``test_serving.py::test_zoo_model_export``)."""
    from hsimae_tpu_torch.serving.export import (export_module_classifier, load_classifier,
                                                 save_classifier)

    spec = tr.get_baseline_spec("SSRN", "PaviaU")
    bands, n_classes, p = 20, 4, spec.patch_size
    model = th.build_model(spec, bands, n_classes, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # BatchNorm statistics that are not the identity
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if name.endswith("var")
                      else torch.randn(buf.shape, generator=g) * 0.1)
    state = model.state_dict()
    assert any(k.endswith("running_var") for k in state)  # the case worth covering
    blob = export_module_classifier(model, state, n_classes, (p, p, bands), batch_sizes=(4,),
                                    platforms=("cpu",), meta={"name": spec.name}, device="cpu")
    clf = load_classifier(save_classifier(str(tmp_path / "ssrn.pt2"), blob), device="cpu")
    assert clf.model_meta["name"] == "SSRN"
    x = np.random.default_rng(3).standard_normal((4, p, p, bands)).astype(np.float32)
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(clf.predict_logits(x), ref, rtol=1e-5, atol=1e-5)

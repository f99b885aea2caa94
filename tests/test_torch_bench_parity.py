"""Port parity for the benchmark harness's training loop: RSSAN (BatchNorm,
no dropout) trained 3 epochs by ``hsimae_tpu.bench.harness`` and by
``hsimae_tpu_torch.bench.harness``, flips off, from JAX's initial weights
injected into the port (``from_jax_zoo``), on the CPU: per-epoch losses,
val ``mean3`` and the final weights' logits agree to 1e-4; and RSSAN with
``early_stop`` for 5 epochs, where both harnesses restore the best epoch's
state. JAX's train steps run op by op (see ``_eager_train_steps``), which
makes these the heaviest cases of the zoo's tests (~60 s in one process),
so they have a file of their own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu.bench import harness as jh
from hsimae_tpu.bench import registry as jr
from hsimae_tpu.data.synthetic import make_synthetic_scene
from hsimae_tpu_torch.bench import harness as th
from hsimae_tpu_torch.bench import registry as tr
from hsimae_tpu_torch.data.pipeline import ScenePatchSource
from hsimae_tpu_torch.models.baselines.convert import from_jax_zoo


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eager_train_steps(monkeypatch):
    """Run the JAX harness's train steps op by op (``jax.disable_jit``).

    On this net XLA:CPU's compiled step differs from the same step run op
    by op by up to ~3% of a leaf's largest gradient (fast-variance
    BatchNorm sums in another order), and Adam's first steps turn such
    differences into opposite-sign updates of many elements; the port's
    gradients agree with the op-by-op step to ~1e-6 of each leaf's
    largest. The eval steps stay compiled."""
    real = jh._cached_steps

    def steps(*a):
        tx, train_step, eval_step = real(*a)

        def eager(*b):
            with jax.disable_jit():
                return train_step(*b)

        return tx, eager, eval_step

    monkeypatch.setattr(jh, "_cached_steps", steps)


def test_harness_parity_rssan_three_epochs(monkeypatch):
    """RSSAN through both harnesses: the port from JAX's initial weights,
    flips off, batch 16 (20 training pixels: a padded tail every epoch), 3
    epochs. Losses, val ``mean3`` and the final weights' logits at 1e-4.
    The logits are taken with batch statistics (train-mode BatchNorm, on
    the same 96 patches): there the conv biases in front of each BatchNorm
    cancel. Their true gradient is 0, so each package's Adam moves them by
    its own rounding noise, and eval-mode logits, which read them through
    the running means, differ by more than 1e-4 for any two correct
    implementations."""
    _eager_train_steps(monkeypatch)
    scene, gt = make_synthetic_scene(20, 20, bands=24, n_classes=4, seed=3)
    seed = 5
    js = dataclasses.replace(jr.get_baseline_spec("RSSAN"), epochs=3, batch_size=16)
    ts = dataclasses.replace(tr.get_baseline_spec("RSSAN"), epochs=3, batch_size=16)
    jrun, jtest_gt, jscene_p = jh.train_baseline(scene, gt, js, lr=1e-3, seed=seed,
                                                 flip_augment=False)
    bands = jscene_p.shape[-1]
    jm = js.build(bands, int(gt.max()) + 1, "synthetic")
    init = jm.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
                   jnp.zeros((2, js.patch_size, js.patch_size, bands)), False)
    trun, ttest_gt, tscene_p = th.train_baseline(
        scene, gt, ts, lr=1e-3, seed=seed, flip_augment=False, device="cpu",
        init_state=from_jax_zoo("RSSAN", jax.device_get(init)))
    np.testing.assert_array_equal(ttest_gt, jtest_gt)
    np.testing.assert_array_equal(tscene_p, jscene_p)
    assert trun.history["train_steps"] == [2, 2, 2]
    np.testing.assert_allclose(trun.history["loss"], jrun.history["loss"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(trun.history["val_mean3"], jrun.history["val_mean3"],
                               rtol=1e-4, atol=1e-4)
    x = ScenePatchSource(tscene_p, ts.patch_size, device="cpu").gather_pixels(np.arange(96))
    ref, _ = jm.apply(jax.device_get(jrun.variables), jnp.asarray(x.numpy()), True,
                      mutable=["batch_stats"])
    model = th.build_model(ts, bands, int(gt.max()) + 1, trun.state, device="cpu").train()
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_harness_parity_rssan_early_stop_restores_best(monkeypatch):
    """RSSAN with ``early_stop`` through both harnesses, from JAX's initial
    weights, flips off, 5 epochs: val ``mean3`` peaks at epoch 2, so each
    harness ends on its copy of epoch 2's state. Losses and val ``mean3``
    at 1e-4; the restored state against JAX's restored variables at 1e-4:
    every parameter but the conv biases in front of a BatchNorm (true
    gradient 0, moved by each package's rounding noise), and every running
    variance. The running means fold those biases in, so they are held
    instead, with every other tensor, bit for bit against the port's own
    run stopped after the best epoch: the restore copied parameters and
    buffers, and left none of them live."""
    _eager_train_steps(monkeypatch)
    scene, gt = make_synthetic_scene(20, 20, bands=24, n_classes=4, seed=3)
    seed, epochs = 6, 5
    js = dataclasses.replace(jr.get_baseline_spec("RSSAN"), epochs=epochs, batch_size=16,
                             early_stop=True)
    ts = dataclasses.replace(tr.get_baseline_spec("RSSAN"), epochs=epochs, batch_size=16,
                             early_stop=True)
    jrun, _, jscene_p = jh.train_baseline(scene, gt, js, lr=1e-3, seed=seed, flip_augment=False)
    bands = jscene_p.shape[-1]
    jm = js.build(bands, int(gt.max()) + 1, "synthetic")
    init = from_jax_zoo("RSSAN", jax.device_get(jm.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((2, js.patch_size, js.patch_size, bands)), False)))
    run = lambda spec: th.train_baseline(scene, gt, spec, lr=1e-3, seed=seed,  # noqa: E731
                                         flip_augment=False, device="cpu", init_state=init)[0]
    trun = run(ts)
    val = trun.history["val_mean3"]
    np.testing.assert_allclose(trun.history["loss"], jrun.history["loss"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(val, jrun.history["val_mean3"], rtol=1e-4, atol=1e-4)
    best = len(val) - 1 - int(np.argmax(val[::-1]))  # EarlyStopping keeps the last of equal bests
    assert 0 < best < epochs - 1, val
    assert trun.val_metrics.mean3 == val[best]
    ref = from_jax_zoo("RSSAN", jax.device_get(jrun.variables))
    before_bn = {"conv1.bias", "ssa1.conv1.bias", "ssa2.conv1.bias"}
    for key, t in trun.state.items():
        if key not in before_bn and not key.endswith("running_mean"):
            np.testing.assert_allclose(t.numpy(), ref[key].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    stopped = run(dataclasses.replace(ts, epochs=best + 1, early_stop=False)).state
    assert set(stopped) == set(trun.state)
    for key, t in trun.state.items():
        assert torch.equal(t, stopped[key]), key

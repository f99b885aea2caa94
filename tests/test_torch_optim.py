"""Port parity for the pretraining optimizer: ``hsimae_tpu_torch.train.optim``
and ``PretrainConfig`` against ``hsimae_tpu``.

Schedules agree to float32 rounding (JAX evaluates them in float32, the
port in float64): within 1e-6 of the base rate. The weight-decay set is
equal, name by name, through ``from_jax_params``' name rule. k AdamW steps
on the same fixed gradients agree with optax's ``adamw`` in float32 within
rtol 1e-6 plus 1e-9 (the learning rate differs by float32 rounding); with a
bfloat16 first moment within ``2^-6 * sum of the learning rates``: JAX
rounds ``b1 * mu`` to bf16 before adding and the port adds in float32, so
the normalised update of a step (size about 1) differs by a few bf16
half-steps (2^-9 each)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.train import optim as jo
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.train import optim as to

DROPPED = set()  # JAX fields the port leaves out: none


def test_pretrain_config_fields_and_defaults():
    j, t = jcfg.PretrainConfig(), tcfg.PretrainConfig()
    jf = {f.name for f in dataclasses.fields(j)} - DROPPED
    assert {f.name for f in dataclasses.fields(t)} == jf
    for f in jf:
        assert getattr(t, f) == getattr(j, f), f
    assert "remat" in {f.name for f in dataclasses.fields(tcfg.ModelConfig)}


@pytest.mark.parametrize("kw", [dict(t_initial=100, warmup_t=10, lr_min=0.01, warmup_lr_init=0.05),
                                dict(t_initial=37, warmup_t=0, lr_min=1e-6),
                                dict(t_initial=20, warmup_t=3)])
def test_timm_cosine_schedule_equal(kw):
    want = jo.timm_cosine_schedule(1.0, **kw)
    got = to.timm_cosine_schedule(1.0, **kw)
    ts = np.arange(kw["t_initial"] + 2)
    np.testing.assert_allclose([got(t) for t in ts], np.asarray(want(ts)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("total", [10, 100, 1543])
def test_pretrain_schedule_equal(total):
    _, want = jo.pretrain_optimizer(5e-3, 0.05, total_steps=total)
    _, got = to.pretrain_optimizer(torch.nn.Linear(2, 2), 5e-3, 0.05, total_steps=total)
    assert got(0) == got(1) == 0.0  # updates 0 and 1 at warmup_lr_init
    ts = np.arange(total + 1)
    np.testing.assert_allclose([got(t) for t in ts], np.asarray(want(ts)), rtol=0, atol=1e-6 * 5e-3)


def param_tree(seed=0):
    """A JAX-style tree with every kind of leaf the model has: Dense
    kernels and biases, LayerNorm scales (norm, norm1, decoder_norm), the
    patch-embed kernel and a list-module suffix."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "patch_embed": {"proj": {"kernel": a(72, 16), "bias": a(16)}},
        "blocks_1_0": {"norm1": {"scale": a(16), "bias": a(16)},
                       "attn": {"q": {"kernel": a(16, 16), "bias": a(16)}},
                       "mlp": {"w1": {"kernel": a(16, 44), "bias": a(44)}}},
        "blocks_0": {"norm2": {"scale": a(16), "bias": a(16)}},
        "norm": {"scale": a(16), "bias": a(16)},
        "decoder_embed": {"kernel": a(16, 8), "bias": a(8)},
        "decoder_norm": {"scale": a(8), "bias": a(8)},
        "decoder_pred": {"kernel": a(8, 72), "bias": a(72)},
    }


def port_params(tree):
    sd = from_jax_params(tree, tcfg.ModelConfig())
    return {k: torch.nn.Parameter(v.clone()) for k, v in sd.items()
            if k not in ("pos_embed", "decoder_pos_embed", "mask_token")}


def test_decay_set_equal():
    tree = param_tree()
    mask = jo.wd_mask(tree)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                       mask, tree)
    want = {k: bool(v.all()) for k, v in from_jax_params(as_arrays, tcfg.ModelConfig()).items()
            if k not in ("pos_embed", "decoder_pos_embed", "mask_token")}
    params = port_params(tree)
    opt = to.AdamW(params.items(), 0.05)
    got = {**dict.fromkeys(opt.param_groups[0]["names"], True),
           **dict.fromkeys(opt.param_groups[1]["names"], False)}
    assert got == want
    assert {k for k, v in got.items() if v} == {"patch_embed.proj.weight", "blocks_1.0.attn.q.weight",
                                                "blocks_1.0.mlp.w1.weight", "decoder_embed.weight",
                                                "decoder_pred.weight"}


def test_decay_set_of_the_model_skips_buffers():
    from hsimae_tpu_torch.models.hsimae import build_hsimae

    model = build_hsimae(tcfg.preset("HSIMAE-S"), device="cpu")
    opt, _ = to.pretrain_optimizer(model, 1e-3, 0.05, 10)
    names = opt.param_groups[0]["names"] + opt.param_groups[1]["names"]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    assert not {"pos_embed", "decoder_pos_embed", "mask_token"} & set(names)
    assert all("norm" not in n and "bias" not in n for n in opt.param_groups[0]["names"])


def run_both(mu_dtype, steps=5, total=10):
    """The same fixed gradients through optax's adamw and the port's AdamW."""
    tree = param_tree(1)
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32)
                                    * 1e-2, tree) for _ in range(steps)]
    tx, sched = jo.pretrain_optimizer(5e-3, 0.05, total, mu_dtype=mu_dtype and jnp.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jp)

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for g in grads:
        jp, state = update(g, state, jp)

    params = port_params(tree)
    model = torch.nn.Module()
    for i, (k, v) in enumerate(params.items()):
        model.register_parameter(f"p{i}", v)
    opt = to.AdamW(params.items(), 0.05, b2=0.95, mu_dtype=mu_dtype)
    _, tsched = to.pretrain_optimizer(model, 5e-3, 0.05, total)
    for g in grads:
        for k, v in from_jax_params(g, tcfg.ModelConfig()).items():
            if k in params:
                params[k].grad = v
        to.set_lr(opt, tsched(opt.count))
        opt.step()
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg.ModelConfig())
    lrs = sum(float(sched(k)) for k in range(steps))
    return params, want, opt, lrs


def test_adamw_steps_match_optax_f32():
    params, want, opt, lrs = run_both(None)
    assert opt.count == 5 and lrs > 0
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_adamw_bf16_first_moment_within_bound():
    params, want, opt, lrs = run_both(torch.bfloat16)
    assert {m.dtype for g in opt.mu for m in g} == {torch.bfloat16}
    assert {v.dtype for g in opt.nu for v in g} == {torch.float32}
    moved = 0.0
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=0,
                                   atol=2 ** -6 * lrs, err_msg=k)
        moved = max(moved, float((p - port_params(param_tree(1))[k]).detach().abs().max()))
    assert moved > 10 * 2 ** -6 * lrs  # the bound is well below the steps' own size


def test_adamw_state_dict_round_trip_keeps_dtypes():
    params, _, opt, _ = run_both(torch.bfloat16, steps=3)
    sd = opt.state_dict()
    fresh = to.AdamW({k: torch.nn.Parameter(v.detach().clone()) for k, v in params.items()}.items(),
                     0.05, b2=0.95, mu_dtype=torch.bfloat16)
    fresh.load_state_dict(sd)
    assert fresh.count == 3
    for a, b in zip(fresh.mu + fresh.nu, opt.mu + opt.nu):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)

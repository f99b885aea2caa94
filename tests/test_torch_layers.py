"""Port parity for the layers: ``PatchEmbed`` and one ``Block`` of
``hsimae_tpu_torch`` against the flax modules of ``hsimae_tpu``, with the
flax weights carried across by ``from_jax_params``. f32 throughout;
tolerance 2e-5 (the same products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu.models import layers as jl
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.config import ModelConfig
from hsimae_tpu_torch.models import layers as tl
from hsimae_tpu_torch.ops import fused_block as tfb


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def converted(params, cfg=ModelConfig()):
    sd = from_jax_params(to_numpy(params), cfg)
    sd.pop("pos_embed")  # a model-level buffer, not part of these modules
    return sd


@pytest.mark.parametrize("embed_dim,bands,img", [(32, 32, 9), (64, 16, 6)])
def test_patch_embed_matches_flax(embed_dim, bands, img):
    cfg = ModelConfig(embed_dim=embed_dim, bands=bands, img_size=img, num_heads=2)
    x = np.random.default_rng(0).standard_normal((4, img, img, bands)).astype(np.float32)
    mod = jl.PatchEmbed(embed_dim, cfg.patch_size, cfg.b_patch_size)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))

    port = tl.PatchEmbed(embed_dim, cfg.patch_size, cfg.b_patch_size)
    port.load_state_dict({k.removeprefix("patch_embed."): v for k, v in
                          converted({"patch_embed": params}, cfg).items()}, strict=True)
    assert tuple(port.proj.weight.shape) == (embed_dim, 1, cfg.b_patch_size, 3, 3)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, cfg.t_size, cfg.l_size, embed_dim)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dim,s", [(32, 9), (64, 4), (128, 36)])
def test_block_matches_flax(dim, s):
    heads = dim // 16
    x = np.random.default_rng(dim).standard_normal((5, s, dim)).astype(np.float32)
    mod = jl.Block(dim, heads)
    params = jax.jit(mod.init, static_argnums=2)(jax.random.PRNGKey(dim), jnp.asarray(x), False)["params"]
    want = np.asarray(jax.jit(mod.apply, static_argnums=2)({"params": params}, jnp.asarray(x), False))

    port = tl.Block(dim, heads).eval()
    port.load_state_dict(converted(params), strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = port(xt).numpy()
        fused = tfb.fused_encoder_block(xt, tfb.params_from_block(port), heads).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the Block module and the kernel's plain version compute the same block
    np.testing.assert_allclose(fused, got, rtol=2e-5, atol=2e-5)


def test_block_init_is_seeded():
    def make(seed):
        with torch.device("meta"):
            b = tl.Block(32, 2)
        b.to_empty(device="cpu")
        tl.init_block_(b, torch.Generator().manual_seed(seed))
        return b.state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["attn.q.weight"], c["attn.q.weight"])
    assert torch.equal(a["norm1.weight"], torch.ones(32)) and a["attn.q.bias"].abs().max() == 0
    assert a["attn.q.weight"].abs().max() <= 0.04  # trunc-normal(0.02) cut at 2 std

"""Port parity for the fused block: ``block_reference`` (the plain PyTorch
version of the CUDA kernel) against the JAX package's
``fused_encoder_block``, which on the CPU runs its own plain math
``_block_math`` (as ``tests/test_ops.py`` runs it). Weights and inputs come
from one numpy generator and go to both.

Tolerances: f32 2e-5 (the same arithmetic, summed in another order); bf16
5e-2 (both round to bf16 at the same points, but a different f32 sum can
round to a neighbouring bf16 value, ~3 decimal digits), as in test_ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu.ops import fused_block as jfb
from hsimae_tpu_torch.models.layers import swiglu_hidden_dim
from hsimae_tpu_torch.ops import fused_block as tfb

FIELDS = tfb.BlockParams._fields


def numpy_block(d: int, hid: int, seed: int) -> dict:
    """Unit-gain random weights (1/sqrt(fan_in)), LN scales around 1."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (d, hid), "b1": (hid,), "w3": (d, hid), "b3": (hid,), "w2": (hid, d)}
    out = {}
    for f in FIELDS:
        shape = shapes.get(f, (d, d) if f.startswith("w") else (d,))
        if f.startswith("w"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            v = 0.1 * rng.standard_normal(shape) + (1.0 if f.endswith("scale") else 0.0)
        out[f] = v.astype(np.float32)
    return out


def both(d, hid, seed):
    w = numpy_block(d, hid, seed)
    return (jfb.BlockParams(**{k: jnp.asarray(v) for k, v in w.items()}),
            tfb.BlockParams(**{k: torch.from_numpy(v) for k, v in w.items()}))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [4, 9, 36])
def test_block_reference_matches_jax(s, d, dtype, tol):
    m, heads = 6, d // 16
    jp, tp = both(d, swiglu_hidden_dim(d), seed=s * 1000 + d)
    x = np.random.default_rng(s + d).standard_normal((m, s, d)).astype(np.float32)
    want = jfb.fused_encoder_block(jnp.asarray(x, getattr(jnp, dtype)), jp, heads)
    got = tfb.block_reference(torch.from_numpy(x).to(getattr(torch, dtype)), tp, heads)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_zero_padding_hidden_is_exact(d):
    """The JAX kernel zero-pads the SwiGLU hidden axis to a multiple of 128
    (``hsimae_tpu/ops/fused_block.py``, Mosaic lanes); the port runs the
    unpadded width (the CUDA kernel needs only a multiple of 4). Padding as
    JAX does leaves the block unchanged (silu(0) * 0 = 0, zero rows of w2) up
    to the order of the f32 sums, so both compute one block."""
    hid = swiglu_hidden_dim(d)
    assert hid % 4 == 0
    _, tp = both(d, hid, seed=d)
    pad = (-hid) % 128
    padded = tp._replace(
        w1=torch.nn.functional.pad(tp.w1, (0, pad)), b1=torch.nn.functional.pad(tp.b1, (0, pad)),
        w3=torch.nn.functional.pad(tp.w3, (0, pad)), b3=torch.nn.functional.pad(tp.b3, (0, pad)),
        w2=torch.nn.functional.pad(tp.w2, (0, 0, 0, pad)))
    assert pad and padded.w1.shape[-1] % 128 == 0
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((5, 9, d)).astype(np.float32))
    torch.testing.assert_close(tfb.block_reference(x, padded, d // 16),
                               tfb.block_reference(x, tp, d // 16), rtol=0, atol=2e-6)


def test_cpu_tensor_takes_plain_version_without_launch():
    _, tp = both(64, 172, seed=1)
    x = torch.randn(3, 9, 64, generator=torch.Generator().manual_seed(0))
    before = tfb.LAUNCHES
    out = tfb.fused_encoder_block(x, tp, 4)
    assert tfb.LAUNCHES == before
    torch.testing.assert_close(out, tfb.block_reference(x, tp, 4), rtol=0, atol=0)


def test_other_devices_raise():
    _, tp = both(64, 172, seed=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfb.fused_encoder_block(torch.empty(2, 9, 64, device="meta"), tp, 4)


@pytest.mark.parametrize("shape,dtype,heads,match", [
    ((4, 9, 96), torch.float32, 6, "unsupported width"),
    ((4, 9, 128), torch.float32, 4, "unsupported width"),
    ((4, 65, 128), torch.float32, 8, "sequence length"),
    ((4, 41, 256), torch.float32, 16, "sequence length"),
    ((4, 9, 128), torch.float16, 8, "float32 or bfloat16"),
    ((36,), torch.float32, 8, r"\[M, S, D\]"),
])
def test_wrapper_rejects_unsupported_inputs(shape, dtype, heads, match):
    d = shape[-1] if len(shape) == 3 else 128
    _, tp = both(d, 176, seed=2)
    with pytest.raises((ValueError, TypeError), match=match):
        # 40: a limit as the kernel library reports one (it is 40 at D=256)
        tfb._check(torch.zeros(shape, dtype=dtype), tp, heads, max_seq=40)


def test_wrapper_rejects_wrong_weights():
    _, tp = both(128, 344, seed=3)
    x = torch.zeros(2, 9, 128)
    tfb._check(x, tp, 8, max_seq=64)  # HSIMAE-B's block, unpadded, passes
    bad = tp._replace(wq=tp.wq.t()[:, :64].contiguous())
    with pytest.raises(ValueError, match="wq has shape"):
        tfb._check(x, bad, 8, max_seq=64)
    with pytest.raises(ValueError, match="float32"):
        tfb._check(x, tp._replace(bq=tp.bq.double()), 8, max_seq=64)
    _, odd = both(128, 342, seed=3)
    with pytest.raises(ValueError, match="multiple of 4"):
        tfb._check(x, odd, 8, max_seq=64)

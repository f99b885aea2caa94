"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked ``cuda``; each test skips without a card (a
CUDA kernel has no CPU mode). This file imports torch and the port only, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances as in chip_smoke.py: |kernel - plain| <= tol * max(1, |plain|),
f32 2e-5 (same arithmetic, other summation order), bf16 5e-2 (a different
f32 sum can round to a neighbouring bf16 value).
"""

import pytest
import torch

from hsimae_tpu_torch.models.layers import swiglu_hidden_dim
from hsimae_tpu_torch.ops import fused_block as tfb


def random_block(d: int, hid: int, seed: int) -> tfb.BlockParams:
    g = torch.Generator().manual_seed(seed)
    shapes = {"w1": (d, hid), "b1": (hid,), "w3": (d, hid), "b3": (hid,), "w2": (hid, d)}
    out = []
    for f in tfb.BlockParams._fields:
        shape = shapes.get(f, (d, d) if f.startswith("w") else (d,))
        if f.startswith("w"):
            out.append(torch.randn(shape, generator=g) / shape[0] ** 0.5)
        else:
            out.append(0.1 * torch.randn(shape, generator=g) + (1.0 if f.endswith("scale") else 0.0))
    return tfb.BlockParams(*(t.cuda() for t in out))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m,s,d", [(300, 9, 128), (301, 4, 128), (77, 36, 128), (300, 9, 64),
                                   (50, 36, 256), (40, 40, 256), (13, 64, 64), (5, 1, 128)])
def test_fused_block_kernel_matches_plain_version(card, m, s, d, dtype, tol):
    p = random_block(d, swiglu_hidden_dim(d), seed=s + d)
    x = torch.randn(m, s, d, generator=torch.Generator().manual_seed(m)).to("cuda", dtype)
    before = tfb.LAUNCHES
    got = tfb.fused_encoder_block(x, p, d // 16)
    ref = tfb.block_reference(x, p, d // 16)
    torch.cuda.synchronize()
    assert tfb.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    err = ((got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_longest_sequence_the_kernel_reports(card, d):
    """The kernel library's own limit: S = max runs and matches the plain
    version, S = max + 1 is refused before any launch."""
    from hsimae_tpu_torch.ops import _build

    max_seq = _build.load_library("fused_block").hsimae_fused_block_max_seq(d)
    assert max_seq >= 36  # HSIMAE's fusion blocks run 36 tokens at every width
    p = random_block(d, swiglu_hidden_dim(d), seed=d)
    x = torch.randn(7, max_seq, d, generator=torch.Generator().manual_seed(d)).cuda()
    got, ref = tfb.fused_encoder_block(x, p, d // 16), tfb.block_reference(x, p, d // 16)
    assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2e-5
    before = tfb.LAUNCHES
    with pytest.raises(ValueError, match="sequence length"):
        tfb.fused_encoder_block(torch.zeros(2, max_seq + 1, d, device="cuda"), p, d // 16)
    assert tfb.LAUNCHES == before


@pytest.mark.cuda
def test_fused_block_kernel_rejects_unsupported_on_card(card):
    p = random_block(128, 344, seed=0)
    before = tfb.LAUNCHES
    with pytest.raises(ValueError, match="sequence length"):
        tfb.fused_encoder_block(torch.zeros(2, 65, 128, device="cuda"), p, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfb.fused_encoder_block(torch.zeros(2, 9, 128, device="cuda", dtype=torch.float16), p, 8)
    assert tfb.LAUNCHES == before

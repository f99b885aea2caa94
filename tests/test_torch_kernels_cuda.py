"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked ``cuda``; each test skips without a card (a
CUDA kernel has no CPU mode). This file imports torch and the port only, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances as in chip_smoke.py: |kernel - plain| <= tol * max(1, |plain|),
f32 2e-5 (3xTF32 products or f32 CUDA-core sums against f32 sums in
another order), bf16 5e-2 (a different f32 sum can round to a neighbouring
bf16 value).

float32 at D 64 and 128 runs the 3xTF32 kernel on its pack
(``TF32X3_LAUNCHES``), float32 at D 256 the 3xTF32 D 256 kernel on its
pack (``TF32X3_D256_LAUNCHES``), bfloat16 at D 64 and 128 the wgmma kernel
on packed weights (``WGMMA_LAUNCHES``), bfloat16 at D 256 the wgmma D 256
kernel on its pack (``WGMMA_D256_LAUNCHES``).
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


def counts() -> tuple:
    return (tfb.TF32X3_LAUNCHES, tfb.TF32X3_D256_LAUNCHES, tfb.WGMMA_LAUNCHES,
            tfb.WGMMA_D256_LAUNCHES)


def route(dtype, d: int) -> tuple:
    """The launch counts one call adds on the route of (dtype, D)."""
    if dtype == torch.bfloat16:
        return (0, 0, 0, 1) if d == tfb.WGMMA_WIDE_D else (0, 0, 1, 0)
    return (1, 0, 0, 0) if d in tfb.TF32X3_D else (0, 1, 0, 0)


def library_of(d: int) -> str:
    """The float32 kernel's library at width d."""
    return "fused_block_tf32x3" if d in tfb.TF32X3_D else "fused_block_tf32x3_d256"


def scaled_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()


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
    before = counts()
    got = tfb.fused_encoder_block(x, tfb.kernel_weights(p, dtype), d // 16)
    ref = tfb.block_reference(x, p, d // 16)
    torch.cuda.synchronize()
    assert counts() == tuple(b + a for b, a in zip(before, route(dtype, d)))
    assert got.dtype == dtype and got.shape == x.shape
    err = scaled_err(got, ref)
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_longest_sequence_the_kernel_reports(card, d):
    """The float32 kernel library's own limit at each width (the 3xTF32
    library at D 64 and 128, the D 256 one at D 256): S = max runs and
    matches the plain version, S = max + 1 is refused before any launch."""
    from hsimae_tpu_torch.ops import _build

    name = library_of(d)
    max_seq = getattr(_build.load_library(name), f"hsimae_{name}_max_seq")(d)
    assert max_seq >= 36  # HSIMAE's fusion blocks run 36 tokens at every width
    p = random_block(d, swiglu_hidden_dim(d), seed=d)
    w = tfb.kernel_weights(p, torch.float32)
    x = torch.randn(7, max_seq, d, generator=torch.Generator().manual_seed(d)).cuda()
    before = counts()
    got, ref = tfb.fused_encoder_block(x, w, d // 16), tfb.block_reference(x, p, d // 16)
    assert counts() == tuple(b + a for b, a in zip(before, route(torch.float32, d)))
    assert scaled_err(got, ref) <= 2e-5
    before = counts()
    with pytest.raises(ValueError, match="sequence length"):
        tfb.fused_encoder_block(torch.zeros(2, max_seq + 1, d, device="cuda"), w, d // 16)
    assert counts() == before


@pytest.mark.cuda
def test_fused_block_kernel_rejects_unsupported_on_card(card):
    p = random_block(128, 344, seed=0)
    pack = tfb.pack_block_tf32(p)
    before = counts()
    with pytest.raises(ValueError, match="sequence length"):
        tfb.fused_encoder_block(torch.zeros(2, 65, 128, device="cuda"), pack, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfb.fused_encoder_block(torch.zeros(2, 9, 128, device="cuda", dtype=torch.float16), pack, 8)
    with pytest.raises(TypeError, match="pack_block_tf32"):  # float32 at D 128 takes only its pack
        tfb.fused_encoder_block(torch.zeros(2, 9, 128, device="cuda"), p, 8)
    p256 = random_block(256, 684, seed=0)
    with pytest.raises(TypeError, match="pack_block_tf32_d256"):  # and at D 256 only its own
        tfb.fused_encoder_block(torch.zeros(2, 9, 256, device="cuda"), p256, 16)
    with pytest.raises(TypeError, match="pack_block_tf32_d256"):
        tfb.fused_encoder_block(torch.zeros(2, 9, 256, device="cuda"), tfb.pack_block_tf32(p), 16)
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,d,hid", [
    *[(301, s, 128, 344) for s in (1, 2, 3, 4, 6, 9, 18, 36)],  # every S of the model at D 128
    (300, 9, 64, 172), (77, 36, 64, 172),  # HSIMAE-S
    (3001, 9, 128, 344),  # 429 row tiles of 7 sequences: the persistent loop wraps; last tile ragged
    (50, 9, 128, 344),  # 8 row tiles, fewer than the SMs
    (7, 64, 64, 172), (3, 64, 128, 344),  # the longest sequence the kernel takes
    # padded hidden widths whose last [W1 | W3] tile is 8, 16, 32, 40 or 56 columns wide,
    # and a last W2 atom of 1 or 3 K steps of 8
    (60, 9, 128, 200), (60, 9, 128, 208), (60, 9, 64, 96), (60, 9, 64, 104), (60, 9, 128, 120),
])
def test_tf32x3_kernel_matches_plain_version(card, m, s, d, hid):
    """The float32 3xTF32 kernel against block_reference (2e-5 scaled)."""
    p = random_block(d, hid, seed=5 * s + d + hid)
    x = torch.randn(m, s, d, generator=torch.Generator().manual_seed(m + s)).cuda()
    before = counts()
    got = tfb.fused_encoder_block(x, tfb.pack_block_tf32(p), d // 16)
    ref = tfb.block_reference(x, p, d // 16)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, *before[1:])
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.isfinite(got).all()
    err = scaled_err(got, ref)
    assert err <= 2e-5, err


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,hid", [
    *[(301, s, 684) for s in (1, 4, 9, 36)],  # ragged M at the model's S; 301 at S 9 is 43 tiles
    (77, 36, 684), (7, 64, 684),  # one sequence a tile; the longest sequence the kernel takes
    (3001, 4, 684),  # 188 row tiles: the persistent loop wraps
    (5, 9, 684),  # one tile: a grid of one CTA
    # padded hidden widths whose last [W1 | W3] tile is 8, 40 or 56 columns wide, a last W2
    # atom of one K step of 8
    (60, 9, 200), (60, 9, 104), (60, 9, 120), (60, 9, 8),
])
def test_tf32x3_d256_kernel_matches_plain_version(card, m, s, hid):
    """The float32 kernel at D 256 against block_reference (2e-5 scaled)."""
    p = random_block(256, hid, seed=7 * s + hid)
    x = torch.randn(m, s, 256, generator=torch.Generator().manual_seed(m + s)).cuda()
    before = counts()
    got = tfb.fused_encoder_block(x, tfb.pack_block_tf32_d256(p), 16)
    ref = tfb.block_reference(x, p, 16)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1, *before[2:])
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.isfinite(got).all()
    err = scaled_err(got, ref)
    assert err <= 2e-5, err


@pytest.mark.cuda
def test_d256_grid_shapes_of_the_cases(card):
    """The D 256 cases above are what they claim on this card: more 64-row
    tiles than SMs for (3001, 4), so CTAs walk several tiles, and a last
    tile only partly filled for (301, 4) and (301, 1)."""
    assert -(-3001 // (64 // 4)) > _sms()
    assert 301 % (64 // 4) and 301 % 64


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,d", [
    *[(301, s, 128) for s in (2, 3, 4, 6, 9, 18, 36)],  # every S of the model at D 128
    (300, 9, 64), (77, 36, 64),  # HSIMAE-S's width
    (3001, 9, 128),  # 215 row tiles of 14 sequences: the persistent loop wraps; last tile ragged
    (50, 9, 128),  # 4 row tiles, fewer than the SMs
    (7, 64, 64),  # the longest sequence the kernel takes
])
def test_wgmma_kernel_matches_plain_version(card, m, s, d):
    """The bf16 tensor-core kernel at D 64 and 128 against block_reference
    (bf16, 5e-2 scaled)."""
    p = random_block(d, swiglu_hidden_dim(d), seed=3 * s + d)
    x = torch.randn(m, s, d, generator=torch.Generator().manual_seed(m + s)).to("cuda", torch.bfloat16)
    before = counts()
    got = tfb.fused_encoder_block(x, tfb.pack_block(p), d // 16)
    ref = tfb.block_reference(x, p, d // 16)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1, before[3])
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    err = ((got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
    assert err <= 5e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,hid", [
    (300, 9, 684), (77, 36, 684), (3, 40, 684),  # HSIMAE-L's cases, once with the D 128 kernel's
    *[(301, s, 684) for s in (1, 2, 3, 4, 6, 9, 18, 36)],  # every S of the model
    (7, 64, 684),  # the longest sequence the kernel takes: 2 sequences a 128-row tile
    (4093, 9, 684),  # 293 row tiles of 14 sequences: the persistent loop wraps; last tile ragged
    (50, 9, 684),  # 4 row tiles, fewer than the SMs
    # padded hidden widths whose last hidden tile is 16, 32 or 48 columns wide
    (60, 9, 16), (60, 9, 96), (60, 9, 176),
])
def test_wgmma_d256_kernel_matches_plain_version(card, m, s, hid):
    """The bf16 tensor-core kernel at D 256 against block_reference (bf16,
    5e-2 scaled)."""
    p = random_block(256, hid, seed=3 * s + 256 + hid)
    x = torch.randn(m, s, 256, generator=torch.Generator().manual_seed(m + s)).to("cuda", torch.bfloat16)
    before = counts()
    got = tfb.fused_encoder_block(x, tfb.pack_block_wgmma_d256(p), 16)
    ref = tfb.block_reference(x, p, 16)
    torch.cuda.synchronize()
    assert counts() == (*before[:3], before[3] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    assert scaled_err(got, ref) <= 5e-2, scaled_err(got, ref)


@pytest.mark.cuda
def test_wgmma_d256_grid_shapes_of_the_cases(card):
    """The D 256 cases above are what they claim on this card (128-row
    tiles): more row tiles than SMs for (4093, 9), a ragged last tile, and
    fewer row tiles than SMs for (50, 9)."""
    per_tile = 128 // 9
    assert -(-4093 // per_tile) > _sms() and 4093 % per_tile
    assert -(-50 // per_tile) < _sms()


# HSIMAE-L's validation-pass launch shapes: a val batch of 80 and a full one of 512 through
# blocks_1 [4b, 9, 256], blocks_2 [9b, 4, 256] and the fusion blocks [b, 36, 256]
D256_VAL_SHAPES = [(b * k, s) for b in (80, 512) for k, s in ((4, 9), (9, 4), (1, 36))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m,s", D256_VAL_SHAPES)
def test_d256_kernels_at_the_hsimae_l_val_shapes(card, m, s, dtype, tol):
    """Both D 256 kernels at fine-tuning's validation shapes, where the row
    tiles are fewer than the SMs and partly filled: the route's kernel once,
    against block_reference (f32 2e-5, bf16 5e-2, scaled)."""
    p = random_block(256, swiglu_hidden_dim(256), seed=5 * s + m)
    x = torch.randn(m, s, 256, generator=torch.Generator().manual_seed(m * s)).to("cuda", dtype)
    before = counts()
    got = tfb.fused_encoder_block(x, tfb.kernel_weights(p, dtype), 16)
    ref = tfb.block_reference(x, p, 16)
    torch.cuda.synchronize()
    assert counts() == tuple(b + a for b, a in zip(before, route(dtype, 256)))
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    assert scaled_err(got, ref) <= tol, scaled_err(got, ref)


@pytest.mark.cuda
def test_wgmma_grid_shapes_of_the_cases(card):
    """The persistent-loop cases above are what they claim on this card:
    more row tiles than SMs for (3001, 9, 128), a ragged last tile, and
    fewer row tiles than SMs for (50, 9, 128) (128-row tiles at D 128)."""
    per_tile = 128 // 9
    assert -(-3001 // per_tile) > _sms() and 3001 % per_tile
    assert -(-50 // per_tile) < _sms()


@pytest.mark.cuda
def test_bf16_on_card_takes_only_packed_weights(card):
    """A bf16 CUDA tensor goes only to the wgmma kernel of its width:
    unpacked weights, or the other width's pack, raise before any launch,
    and S past the kernel's limit is refused. The D 128 kernel takes no D
    256 at all."""
    p = random_block(128, 344, seed=0)
    x = torch.zeros(2, 9, 128, device="cuda", dtype=torch.bfloat16)
    before = counts()
    with pytest.raises(TypeError, match="packed weights"):
        tfb.fused_encoder_block(x, p, 8)
    with pytest.raises(ValueError, match="sequence length"):
        tfb.fused_encoder_block(torch.zeros(2, 65, 128, device="cuda", dtype=torch.bfloat16),
                                tfb.pack_block(p), 8)
    p256 = random_block(256, 684, seed=0)
    x256 = torch.zeros(2, 9, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="pack_block_wgmma_d256"):
        tfb.fused_encoder_block(x256, tfb.pack_block(p256), 16)
    with pytest.raises(TypeError, match="pack_block_wgmma_d256"):
        tfb.fused_encoder_block(x256, p256, 16)
    with pytest.raises(TypeError, match="pack_block\\(params\\)"):
        tfb.fused_encoder_block(x, tfb.pack_block_wgmma_d256(p256), 8)
    with pytest.raises(ValueError, match="takes no width D=256"):
        tfb._launch_wgmma(x256, tfb.pack_block(p256), 16)
    with pytest.raises(ValueError, match="sequence length"):
        tfb.fused_encoder_block(torch.zeros(2, 65, 256, device="cuda", dtype=torch.bfloat16),
                                tfb.pack_block_wgmma_d256(p256), 16)
    assert counts() == before


@pytest.mark.cuda
def test_bf16_model_launches_only_the_wgmma_kernel(card):
    """HSIMAE-S in bf16 on the card: every block through the wgmma kernel,
    logits close to the same model with block_reference per block."""
    from hsimae_tpu_torch import config as tcfg
    from hsimae_tpu_torch.models import hsimae as th

    cfg = tcfg.preset("HSIMAE-S", compute_dtype=torch.bfloat16)
    model = th.build_hsi_vit(cfg, 7, seed=1, device="cuda")
    x = torch.randn(64, 9, 9, 32, generator=torch.Generator().manual_seed(1)).cuda()
    before = counts()
    with torch.inference_mode():
        got = model.classify(x)
        n = tfb.WGMMA_LAUNCHES - before[2]
        orig = th.fused_encoder_block
        th.fused_encoder_block = lambda v, pk, h: tfb.block_reference(v, pk.params, h)
        try:
            ref = model.classify(x)
        finally:
            th.fused_encoder_block = orig
    assert counts()[:2] == before[:2] and counts()[3] == before[3]
    assert n == 2 * cfg.s_depth + cfg.fusion_depth
    assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 5e-2


@pytest.mark.cuda
def test_bf16_hsimae_l_model_launches_only_the_d256_kernel(card):
    """HSIMAE-L in bf16 on the card: every block through the wgmma D 256
    kernel and no other, logits close to the same model with block_reference
    per block (5e-2 scaled, as one bf16 block)."""
    from hsimae_tpu_torch import config as tcfg
    from hsimae_tpu_torch.models import hsimae as th

    cfg = tcfg.preset("HSIMAE-L", compute_dtype=torch.bfloat16)
    model = th.build_hsi_vit(cfg, 7, seed=1, device="cuda")
    x = torch.randn(64, 9, 9, 32, generator=torch.Generator().manual_seed(1)).cuda()
    before = counts()
    with torch.inference_mode():
        got = model.classify(x)
        after = counts()
        orig = th.fused_encoder_block
        th.fused_encoder_block = lambda v, pk, h: tfb.block_reference(v, pk.params, h)
        try:
            ref = model.classify(x)
        finally:
            th.fused_encoder_block = orig
    assert after == (*before[:3], before[3] + 2 * cfg.s_depth + cfg.fusion_depth)
    assert scaled_err(got, ref) <= 5e-2


@pytest.mark.cuda
def test_f32_hsimae_l_model_launches_only_the_d256_kernel(card):
    """HSIMAE-L in float32 on the card: every block through the D 256
    kernel and no other, logits close to the same model with
    block_reference per block (21 blocks of <= 2e-5 each: 5e-4 scaled)."""
    from hsimae_tpu_torch import config as tcfg
    from hsimae_tpu_torch.models import hsimae as th

    cfg = tcfg.preset("HSIMAE-L")
    model = th.build_hsi_vit(cfg, 7, seed=1, device="cuda")
    x = torch.randn(64, 9, 9, 32, generator=torch.Generator().manual_seed(1)).cuda()
    before = counts()
    with torch.inference_mode():
        got = model.classify(x)
        after = counts()
        orig = th.fused_encoder_block
        th.fused_encoder_block = lambda v, pk, h: tfb.block_reference(v, pk.params, h)
        try:
            ref = model.classify(x)
        finally:
            th.fused_encoder_block = orig
    assert after == (before[0], before[1] + 2 * cfg.s_depth + cfg.fusion_depth, *before[2:])
    assert scaled_err(got, ref) <= 5e-4


@pytest.mark.cuda
def test_f32_model_launches_only_the_tf32x3_kernel(card):
    """HSIMAE-B in float32 on the card: every block through the 3xTF32
    kernel and no other, logits close to the same model with block_reference
    per block (21 blocks of <= 2e-5 each: 5e-4 scaled)."""
    from hsimae_tpu_torch import config as tcfg
    from hsimae_tpu_torch.models import hsimae as th

    cfg = tcfg.preset("HSIMAE-B")
    model = th.build_hsi_vit(cfg, 7, seed=1, device="cuda")
    x = torch.randn(64, 9, 9, 32, generator=torch.Generator().manual_seed(1)).cuda()
    before = counts()
    with torch.inference_mode():
        got = model.classify(x)
        after = counts()
        orig = th.fused_encoder_block
        th.fused_encoder_block = lambda v, pk, h: tfb.block_reference(v, pk.params, h)
        try:
            ref = model.classify(x)
        finally:
            th.fused_encoder_block = orig
    assert after == (before[0] + 2 * cfg.s_depth + cfg.fusion_depth, *before[1:])
    assert scaled_err(got, ref) <= 5e-4


# The serving artifact's launch shapes: at bucket b, blocks_1 [4b, 9, D],
# blocks_2 [9b, 4, D] and fusion [b, 36, D].
SERVING_ROUTES = {"tf32x3": (torch.float32, 128, 2e-5), "d256": (torch.float32, 256, 2e-5),
                  "wgmma": (torch.bfloat16, 128, 5e-2), "wgmma_d256": (torch.bfloat16, 256, 5e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(SERVING_ROUTES))
@pytest.mark.parametrize("b", [1, 64, 1024])
def test_registered_op_matches_plain_version_at_bucket_shapes(card, kernel, b):
    """torch.ops.hsimae.fused_block, as the exported program calls it, on the
    route's kernel (one launch a call, of it only) against block_reference."""
    dtype, d, tol = SERVING_ROUTES[kernel]
    p = random_block(d, swiglu_hidden_dim(d), seed=b + d)
    name, tensors = tfb.pack_tensors(tfb.kernel_weights(p, dtype))
    g = torch.Generator().manual_seed(b)
    for m, s in ((4 * b, 9), (9 * b, 4), (b, 36)):
        x = torch.randn(m, s, d, generator=g).cuda().to(dtype)
        before = counts()
        got = torch.ops.hsimae.fused_block(x, tensors, name, d // 16)
        assert tuple(a - c for a, c in zip(counts(), before)) == route(dtype, d)
        assert scaled_err(got, tfb.block_reference(x, p, d // 16)) <= tol


def _serving_case(dtype):
    from hsimae_tpu_torch import config as tcfg
    from hsimae_tpu_torch.models import hsimae as th
    from hsimae_tpu_torch.serving import export as texp

    cfg = tcfg.preset("HSIMAE-B", compute_dtype=dtype)
    model = th.build_hsi_vit(cfg, 7, seed=1, device="cuda")
    blob = texp.export_classifier(model.state_dict(), cfg, 7, batch_sizes=(64,),
                                  platforms=("cuda",))
    return cfg, model, texp.load_classifier(blob, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 5e-2)])
def test_cuda_artifact_launches_only_the_routes_kernel(card, dtype, tol):
    """An HSIMAE-B artifact exported on the card: 21 launches a program call,
    all of the route's kernel, named in the program's graph; logits close
    to the live model on the same weights (f32: 21 blocks of <= 2e-5)."""
    cfg, model, clf = _serving_case(dtype)
    kernel = "fused_block_wgmma" if dtype == torch.bfloat16 else "fused_block_tf32x3"
    assert f"'{kernel}'" in clf._calls[64].code  # the op's route argument in the graph
    x = torch.randn(64, 9, 9, 32, generator=torch.Generator().manual_seed(2)).cuda()
    before = counts()
    got = clf.predict_logits(x)
    launches = tuple(a - c for a, c in zip(counts(), before))
    assert launches == tuple(21 * n for n in route(dtype, 128))
    assert got.device.type == "cuda" and got.shape == (64, 7)
    with torch.inference_mode():
        want = model.classify(x)
    assert scaled_err(got, want) <= tol


@pytest.mark.cuda
def test_cuda_artifact_builds_no_pack_per_request(card, monkeypatch):
    """kernel_weights runs at load (once a block), never in predict_logits."""
    calls = []
    real = tfb.kernel_weights
    monkeypatch.setattr(tfb, "kernel_weights", lambda *a: calls.append(1) or real(*a))
    _, _, clf = _serving_case(torch.bfloat16)
    n_load = len(calls)
    x = torch.randn(200, 9, 9, 32).cuda()
    for n in (1, 64, 200):
        clf.predict_logits(x[:n])
    torch.cuda.synchronize()
    assert n_load == 2 * 21 and len(calls) == n_load  # export and load build; requests none

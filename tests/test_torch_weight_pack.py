"""The bf16 kernel's weight pack (``hsimae_tpu_torch.ops.fused_block.pack_block``),
pure tensor code, on the CPU: the packed image holds every matrix rounded to
bf16, in the tile order and 128-byte swizzle the kernel consumes, with the
SwiGLU hidden axis zero-padded to a multiple of 16; the model builds it once
per dtype and rebuilds it after a weight changes.

Widths are the presets' (D 64/128/256 with their SwiGLU widths 172/344/684)
plus odd hidden widths whose last W1|W3 tile is 16, 32 or 48 columns wide.
"""

import numpy as np
import pytest
import torch

from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.models.layers import swiglu_hidden_dim
from hsimae_tpu_torch.ops import fused_block as tfb

BF16 = torch.bfloat16
HIDDEN_CASES = [(64, swiglu_hidden_dim(64)), (128, swiglu_hidden_dim(128)),
                (256, swiglu_hidden_dim(256)), (64, 8), (64, 100), (128, 36)]


ATOM_K = 64  # bf16 K columns of one 128-byte swizzle atom
HID_TILE = 64  # hidden columns per interleaved [W1 | W3] tile


def pack_layout(d: int, hidden_pad: int) -> list:
    """The kernel's tile order, written out independently of pack_block:
    ``(matrix, n0, rows, k0)``. A tile holds output rows ``n0 : n0 + rows``
    of the matrix in ``[out, in]`` layout and its input columns
    ``k0 : k0 + 64`` (zero past the end). ``w13`` tiles stack ``rows // 2``
    hidden rows of W1 over the same rows of W3, from hidden row ``n0``."""
    nt = min(d, 128)
    tiles = [(name, n0, nt, k0) for name in ("wq", "wk", "wv", "wo")
             for n0 in range(0, d, nt) for k0 in range(0, d, ATOM_K)]
    for h0 in range(0, hidden_pad, HID_TILE):
        rows = 2 * min(HID_TILE, hidden_pad - h0)
        tiles += [("w13", h0, rows, k0) for k0 in range(0, d, ATOM_K)]
    tiles += [("w2", n0, nt, k0) for n0 in range(0, d, nt) for k0 in range(0, hidden_pad, ATOM_K)]
    return tiles


def unpack_block(pack: tfb.BlockPack) -> dict:
    """The matrices of a pack, read back through :func:`pack_layout`, in
    float32 ``[in, out]`` layout with the padded hidden axis: ``wq, wk, wv,
    wo [D, D]``, ``w1, w3 [D, Hp]``, ``w2 [Hp, D]``."""
    d, hp = pack.params.wq.shape[0], tfb.padded_hidden(pack.params.w1.shape[-1])
    out = {"wq": torch.zeros(d, d), "wk": torch.zeros(d, d), "wv": torch.zeros(d, d),
           "wo": torch.zeros(d, d), "w1": torch.zeros(hp, d), "w3": torch.zeros(hp, d),
           "w2": torch.zeros(d, hp)}  # [out, in] while filling
    image, off = pack.image.cpu(), 0
    for name, n0, rows, k0 in pack_layout(d, hp):
        tile = tfb.swizzle128(image[off:off + rows * ATOM_K].reshape(rows, ATOM_K)).float()
        off += rows * ATOM_K
        parts = ((("w1", tile[:rows // 2]), ("w3", tile[rows // 2:])) if name == "w13"
                 else ((name, tile),))
        for key, part in parts:
            kk = min(ATOM_K, out[key].shape[1] - k0)
            out[key][n0:n0 + part.shape[0], k0:k0 + kk] = part[:, :kk]
            assert not part[:, kk:].any(), "K padding of a tile must be zero"
    assert off == image.numel(), "pack image longer than its layout"
    return {k: v.t().contiguous() for k, v in out.items()}


def random_block(d: int, hid: int, seed: int) -> tfb.BlockParams:
    rng = np.random.default_rng(seed)
    shapes = {"w1": (d, hid), "b1": (hid,), "w3": (d, hid), "b3": (hid,), "w2": (hid, d)}
    out = []
    for f in tfb.BlockParams._fields:
        shape = shapes.get(f, (d, d) if f.startswith("w") else (d,))
        if f.startswith("w"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            v = 0.1 * rng.standard_normal(shape) + (1.0 if f.endswith("scale") else 0.0)
        out.append(torch.from_numpy(v.astype(np.float32)))
    return tfb.BlockParams(*out)


def test_swizzle_places_each_chunk_by_the_128_byte_rule():
    """Element (r, k) of a 64-column tile lands at r*64 + ((k//8) ^ (r%8))*8 + k%8,
    and the swizzle is its own inverse."""
    rows = 24
    t = torch.arange(rows * 64, dtype=torch.float32).reshape(rows, 64)
    sw = tfb.swizzle128(t).reshape(-1)
    for r in range(rows):
        for k in range(64):
            assert sw[r * 64 + ((k // 8) ^ (r % 8)) * 8 + k % 8] == t[r, k]
    torch.testing.assert_close(tfb.swizzle128(tfb.swizzle128(t)), t, rtol=0, atol=0)


@pytest.mark.parametrize("d,hid", HIDDEN_CASES)
def test_unpacked_image_is_the_bf16_weights_with_zero_padding(d, hid):
    p = random_block(d, hid, seed=d + hid)
    pack = tfb.pack_block(p)
    hp = tfb.padded_hidden(hid)
    assert hp % 16 == 0 and 0 <= hp - hid < 16
    assert pack.image.dtype == BF16 and pack.vecs.dtype == torch.float32
    assert pack.image.numel() == sum(rows * 64 for _, _, rows, _ in pack_layout(d, hp))
    u = unpack_block(pack)
    for name in ("wq", "wk", "wv", "wo"):
        assert torch.equal(u[name], getattr(p, name).to(BF16).float()), name
    for name in ("w1", "w3"):
        assert u[name].shape == (d, hp)
        assert torch.equal(u[name][:, :hid], getattr(p, name).to(BF16).float()), name
        assert not u[name][:, hid:].any(), name  # padded hidden columns are exactly zero
    assert u["w2"].shape == (hp, d)
    assert torch.equal(u["w2"][:hid], p.w2.to(BF16).float())
    assert not u["w2"][hid:].any()  # padded hidden rows are exactly zero
    # the vectors, in the kernel's order, biases of the hidden axis padded with zeros
    pad = torch.zeros(hp - hid)
    want = torch.cat([p.ln1_scale, p.ln1_bias, p.bq, p.bk, p.bv, p.bo, p.ln2_scale, p.ln2_bias,
                      p.b2, torch.cat([p.b1, pad]), torch.cat([p.b3, pad])])
    assert torch.equal(pack.vecs, want)


@pytest.mark.parametrize("d,hid", HIDDEN_CASES)
def test_block_reference_on_unpacked_weights_equals_the_originals(d, hid):
    """The padded, unpacked weights compute the same block as the originals
    rounded to bf16 (the rounding the bf16 block applies itself): f32
    activations to 2e-6 (only the f32 summation order may differ), and in
    bf16, where block_reference rounds the weights as it reads them, to one
    bf16 step (a different f32 sum may round to the neighbouring value)."""
    p = random_block(d, hid, seed=7 * d + hid)
    pack = tfb.pack_block(p)
    u = unpack_block(pack)
    hp = tfb.padded_hidden(hid)
    pad = torch.zeros(hp - hid)
    padded = p._replace(wq=u["wq"], wk=u["wk"], wv=u["wv"], wo=u["wo"], w1=u["w1"], w3=u["w3"],
                        w2=u["w2"], b1=torch.cat([p.b1, pad]), b3=torch.cat([p.b3, pad]))
    rounded = p._replace(**{k: getattr(p, k).to(BF16).float()
                            for k in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")})
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((5, 9, d)).astype(np.float32))
    torch.testing.assert_close(tfb.block_reference(x, padded, d // 16),
                               tfb.block_reference(x, rounded, d // 16), rtol=0, atol=2e-6)
    xb = x.to(BF16)
    torch.testing.assert_close(tfb.block_reference(xb, padded, d // 16).float(),
                               tfb.block_reference(xb, p, d // 16).float(), rtol=2**-7, atol=2**-7)


def test_cpu_bf16_tensor_with_a_pack_takes_plain_version_without_launch():
    p = random_block(64, 172, seed=1)
    pack = tfb.pack_block(p)
    x = torch.randn(3, 9, 64, generator=torch.Generator().manual_seed(0)).to(BF16)
    before = (tfb.TF32X3_LAUNCHES, tfb.TF32X3_D256_LAUNCHES, tfb.WGMMA_LAUNCHES)
    out = tfb.fused_encoder_block(x, pack, 4)
    assert (tfb.TF32X3_LAUNCHES, tfb.TF32X3_D256_LAUNCHES, tfb.WGMMA_LAUNCHES) == before
    torch.testing.assert_close(out, tfb.block_reference(x, p, 4), rtol=0, atol=0)


def test_kernel_params_packs_once_per_dtype_and_rebuilds_after_a_weight_change():
    tc = tcfg.preset("HSIMAE-S", embed_dim=32, num_heads=2, depth=3, s_depth=2,
                     decoder_depth=1, compute_dtype=BF16)
    model = th.build_hsi_vit(tc, 5, seed=3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, 9, 32)).astype(np.float32))
    f32_model = th.build_hsi_vit(tc.replace(compute_dtype=torch.float32), 5, seed=3, device="cpu")
    with torch.inference_mode():
        model.classify(x)
        packs = model.kernel_params("blocks_1")  # the config's dtype: bf16
        assert all(isinstance(pk, tfb.BlockPack) for pk in packs)
        assert model.kernel_params("blocks_1") is packs
        model.classify(x)
        assert all(a is b for a, b in zip(packs, model.kernel_params("blocks_1")))
        f32_model.classify(x)
        f32 = f32_model.kernel_params("blocks_1")  # a float32 model: BlockParams
        assert all(isinstance(pp, tfb.BlockParams) for pp in f32)
        assert f32_model.kernel_params("blocks_1") is f32
        assert torch.equal(unpack_block(packs[0])["wq"], f32[0].wq.to(BF16).float())
    with torch.no_grad():
        model.blocks_1[0].attn.q.weight.mul_(2.0)
    with torch.inference_mode():
        fresh = model.kernel_params("blocks_1")
    assert fresh[0] is not packs[0]
    assert torch.equal(unpack_block(fresh[0])["wq"],
                       (model.blocks_1[0].attn.q.weight.detach().t()).to(BF16).float())

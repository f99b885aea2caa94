"""The float32 kernels' arithmetic and weight packs, on the CPU
(``hsimae_tpu_torch.ops.fused_block.pack_block_tf32`` and
``pack_block_tf32_d256``, and the 3xTF32 products of
``csrc/fused_block_tf32x3.cu`` at D 64/128 and
``csrc/fused_block_tf32x3_d256.cu`` at D 256).

* A plain PyTorch emulation of the kernel's arithmetic (each of the wgmma
  products q/k/v, out-proj, W1/W3 and W2 as ``a_lo w_hi + a_hi w_lo + a_hi
  w_hi`` with every part rounded to TF32 by bit masking; LayerNorm,
  attention and the gate in float32 as the kernel computes them) holds the
  2e-5 check against the float32 ``block_reference``; one TF32 product does
  not. This is the precision study behind the kernel's design. At D 256 it
  follows that kernel's summation order: q/k/v, attention and Wo by head
  group of 64 columns (each group's Wo sum from zero, the groups' sums then
  added in order), the SwiGLU half by 64 hidden columns (each tile's W2 sum
  from zero, the tiles' sums added in order), and every product in chains
  of 4 K atoms of 16 (one wgmma accumulator each), each chain's sum a fresh
  partial added in K order.
* The packs: every hi and lo value is TF32 (13 low mantissa bits zero),
  ``hi + lo`` is within 2^-21 of the weight, and the unswizzled images are
  the ``[out, in]`` tiles in the kernel's order with zero padding.
* Generalising ``swizzle128`` to float32 tiles left the bf16 pack
  byte-identical.

Tolerance: |got - ref| <= 2e-5 * max(1, |ref|), as chip_smoke.py holds the
kernel. Rows are cut to a few hundred so the file runs in seconds.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.models.layers import swiglu_hidden_dim
from hsimae_tpu_torch.ops import fused_block as tfb

TOL = 2e-5
# (rows, S, D, hidden): the widths and lengths of chip_smoke.CHECK_SHAPES, rows cut
CASES = [(288, 9, 128, 344), (288, 4, 128, 344), (288, 36, 128, 344), (288, 9, 64, 172),
         (216, 36, 256, 684), (216, 9, 256, 684)]
ATOM_K = 32  # float32 K columns of one 128-byte swizzle atom
D256_ATOM_K = 16  # the D 256 kernel's: one 64-byte swizzle atom
CHAIN_K = 4 * D256_ATOM_K  # K of one of its wgmma chains
HID_TILE = 64
GROUP = 64  # q/k/v columns of one head group in the D 256 kernel


def random_block(d: int, hid: int, seed: int) -> tfb.BlockParams:
    """Unit-gain random weights (1/sqrt(fan_in)), LN scales around 1."""
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


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32, nearest with ties away from zero, by masking the bits
    (written out here apart from the package's rna_tf32)."""
    bits = t.numpy().view(np.uint32).astype(np.uint64)
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return torch.from_numpy((sign | mag).astype(np.uint32).view(np.float32))


def matmul_tf32(a: torch.Tensor, w: torch.Tensor, terms: int, acc=None) -> torch.Tensor:
    """a @ w as the kernel's wgmma products compute it: ``terms`` 3 sums
    a_lo w_hi + a_hi w_lo + a_hi w_hi (small terms first), 1 is plain TF32.
    With an accumulator ``acc`` (the D 256 kernel), K is taken in chains of
    4 atoms of 16 (one wgmma accumulator each), each chain's sum a fresh
    partial added to ``acc`` in K order."""
    a_hi, w_hi = tf32(a), tf32(w)
    if terms == 1:
        return a_hi @ w_hi if acc is None else acc + a_hi @ w_hi
    a_lo, w_lo = tf32(a - a_hi), tf32(w - w_hi)
    if acc is None:
        return a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
    for k0 in range(0, a.shape[1], CHAIN_K):
        part = torch.zeros_like(acc)
        for k1 in range(k0, min(k0 + CHAIN_K, a.shape[1]), D256_ATOM_K):
            k = slice(k1, k1 + D256_ATOM_K)
            part = part + (a_lo[:, k] @ w_hi[k] + a_hi[:, k] @ w_lo[k] + a_hi[:, k] @ w_hi[k])
        acc = acc + part
    return acc


def emulated_block(x: torch.Tensor, p: tfb.BlockParams, heads: int, terms: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on [M, S, D] float32."""
    m, s, d = x.shape
    x = x.reshape(m * s, d)

    def ln(v, scale, bias):
        mu = v.mean(-1, keepdim=True)
        inv = torch.rsqrt(((v - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        return (v - mu) * inv * scale + bias

    def split_heads(t):
        return t.reshape(m, s, heads, 16).transpose(1, 2)

    y = ln(x, p.ln1_scale, p.ln1_bias)
    q, k, v = (split_heads(matmul_tf32(y, w, terms) + b)
               for w, b in ((p.wq, p.bq), (p.wk, p.bk), (p.wv, p.bv)))
    logits = (q @ k.transpose(-1, -2)) * 0.25  # attention on the CUDA cores, in f32
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    o = ((e @ v) / e.sum(-1, keepdim=True)).transpose(1, 2).reshape(m * s, d)
    x = x + (matmul_tf32(o, p.wo, terms) + p.bo)
    y2 = ln(x, p.ln2_scale, p.ln2_bias)
    h = F.silu(matmul_tf32(y2, p.w1, terms) + p.b1) * (matmul_tf32(y2, p.w3, terms) + p.b3)
    return (x + (matmul_tf32(h, p.w2, terms) + p.b2)).reshape(m, s, d)


def emulated_block_d256(x: torch.Tensor, p: tfb.BlockParams, heads: int,
                           terms: int) -> torch.Tensor:
    """The D 256 kernel's arithmetic in plain PyTorch, in its order: per
    head group of 64 columns q/k/v, attention and the group's K slice of
    Wo, summed from zero and added to the sum of the groups before; per 64
    hidden columns the gate tile and its K slice of W2, likewise; the hidden
    axis zero-padded to a multiple of 8 as the pack pads it."""
    m, s, d = x.shape
    x = x.reshape(m * s, d)
    hp = tfb.padded_hidden(p.w1.shape[1], tfb.TF32_HIDDEN_MULTIPLE)
    pad = hp - p.w1.shape[1]
    w1, w3 = F.pad(p.w1, (0, pad)), F.pad(p.w3, (0, pad))
    b1, b3, w2 = F.pad(p.b1, (0, pad)), F.pad(p.b3, (0, pad)), F.pad(p.w2, (0, 0, 0, pad))

    def ln(v, scale, bias):
        mu = v.mean(-1, keepdim=True)
        inv = torch.rsqrt(((v - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        return (v - mu) * inv * scale + bias

    def split_heads(t):
        return t.reshape(m, s, GROUP // 16, 16).transpose(1, 2)

    zero = torch.zeros(m * s, d)
    y = ln(x, p.ln1_scale, p.ln1_bias)
    oacc = zero
    for c in (slice(c0, c0 + GROUP) for c0 in range(0, d, GROUP)):
        q, k, v = (split_heads(matmul_tf32(y, w[:, c], terms, zero[:, :GROUP]) + b[c])
                   for w, b in ((p.wq, p.bq), (p.wk, p.bk), (p.wv, p.bv)))
        logits = (q @ k.transpose(-1, -2)) * 0.25
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        o = ((e @ v) / e.sum(-1, keepdim=True)).transpose(1, 2).reshape(m * s, GROUP)
        oacc = oacc + matmul_tf32(o, p.wo[c], terms, zero)  # each group's sum, then the groups'
    x = x + (oacc + p.bo)
    y2 = ln(x, p.ln2_scale, p.ln2_bias)
    wacc = zero
    for h0 in range(0, hp, HID_TILE):
        h = slice(h0, min(h0 + HID_TILE, hp))
        tile = zero[:, :h.stop - h0]
        gate = F.silu(matmul_tf32(y2, w1[:, h], terms, tile) + b1[h]) * \
            (matmul_tf32(y2, w3[:, h], terms, tile) + b3[h])
        wacc = wacc + matmul_tf32(gate, w2[h], terms, zero)  # each tile's sum, then the tiles'
    return (x + (wacc + p.b2)).reshape(m, s, d)


def scaled_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("rows,s,d,hid", CASES)
def test_3xtf32_arithmetic_holds_the_float32_check(rows, s, d, hid):
    p = random_block(d, hid, seed=s + d)
    x = torch.from_numpy(np.random.default_rng(d + s).standard_normal((rows // s, s, d))
                         .astype(np.float32))
    ref = tfb.block_reference(x, p, d // 16)
    emulate = emulated_block_d256 if d == tfb.TF32X3_WIDE_D else emulated_block
    assert scaled_err(emulate(x, p, d // 16, terms=3), ref) <= TOL
    # one TF32 product misses the same check: why the kernel issues three
    assert scaled_err(emulate(x, p, d // 16, terms=1), ref) > 20 * TOL


def test_rna_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32 step at 1.0
    v = torch.tensor([1.0, 1 + one_ulp / 2, 1 + one_ulp / 2 - 2**-23, -(1 + one_ulp / 2),
                      1 + 1.5 * one_ulp, 3.0e-39, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + one_ulp, 1.0, -(1 + one_ulp), 1 + 2 * one_ulp,
                         tf32(torch.tensor([3.0e-39])).item(), 0.0], dtype=torch.float32)
    assert torch.equal(tfb.rna_tf32(v), want)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    assert torch.equal(tfb.rna_tf32(w), tf32(w))


def pack_layout(d: int, hidden_pad: int) -> list:
    """The 3xTF32 kernel's tile order, written out independently of the
    pack: ``(segments, k0)``, where a tile's rows are the listed segments
    ``(matrix, row0, nrows)`` of the matrices in ``[out, in]`` layout, one
    after the other, and its columns are the input columns ``k0 : k0 + 32``
    (zero past the end). A [W1 | W3] tile of tw hidden rows from h0 is cut
    for the kernel's two warpgroups: W1 over W3 for the first tw0 = ceil8(tw
    / 2) rows, then W1 over W3 for the rest."""
    tiles = [([(name, 0, d)], k0) for name in ("wq", "wk", "wv", "wo")
             for k0 in range(0, d, ATOM_K)]
    for h0 in range(0, hidden_pad, HID_TILE):
        tiles += [(hidden_segments(h0, hidden_pad), k0) for k0 in range(0, d, ATOM_K)]
    tiles += [([("w2", 0, d)], k0) for k0 in range(0, hidden_pad, ATOM_K)]
    return tiles


def hidden_segments(h0: int, hidden_pad: int) -> list:
    """The rows of the [W1 | W3] tile of hidden columns from h0, cut for
    the kernels' two warpgroups (see :func:`pack_layout`)."""
    tw = min(HID_TILE, hidden_pad - h0)
    tw0 = -(-(tw // 2) // 8) * 8
    segs = [("w1", h0, tw0), ("w3", h0, tw0), ("w1", h0 + tw0, tw - tw0),
            ("w3", h0 + tw0, tw - tw0)]
    return [sg for sg in segs if sg[2]]


def d256_pack_layout(d: int, hidden_pad: int) -> list:
    """The D 256 kernel's tile order, written out independently of the
    pack, as :func:`pack_layout` lists it, with K atoms of 16 columns: per
    head group of 64 columns from c0, the rows q[c0:+64], v[c0:+32],
    k[c0:+64], v[c0+32:+64] over every K atom, then Wo's 256 rows over the
    group's K atoms c0 : c0 + 64; per 64 hidden columns from h0, the [W1 |
    W3] tile over every K atom, then W2's 256 rows over the tile's K atoms."""
    tiles = []
    for c0 in range(0, d, GROUP):
        segs = [("wq", c0, GROUP), ("wv", c0, GROUP // 2), ("wk", c0, GROUP),
                ("wv", c0 + GROUP // 2, GROUP // 2)]
        tiles += [(segs, k0) for k0 in range(0, d, D256_ATOM_K)]
        tiles += [([("wo", 0, d)], k0) for k0 in range(c0, c0 + GROUP, D256_ATOM_K)]
    for h0 in range(0, hidden_pad, HID_TILE):
        tiles += [(hidden_segments(h0, hidden_pad), k0) for k0 in range(0, d, D256_ATOM_K)]
        h1 = min(h0 + HID_TILE, hidden_pad)
        tiles += [([("w2", 0, d)], k0) for k0 in range(h0, h1, D256_ATOM_K)]
    return tiles


def unpack_image(image: torch.Tensor, d: int, hp: int, layout=pack_layout, atom_k: int = ATOM_K,
                 unswizzle=tfb.swizzle128) -> dict:
    """The matrices of one image, read back through ``layout`` (tiles of
    ``atom_k`` columns, swizzled by the self-inverse ``unswizzle``), in
    ``[in, out]`` layout with the padded hidden axis."""
    out = {"wq": torch.zeros(d, d), "wk": torch.zeros(d, d), "wv": torch.zeros(d, d),
           "wo": torch.zeros(d, d), "w1": torch.zeros(hp, d), "w3": torch.zeros(hp, d),
           "w2": torch.zeros(d, hp)}  # [out, in] while filling
    filled = {k: torch.zeros(v.shape, dtype=torch.int32) for k, v in out.items()}
    off = 0
    for segs, k0 in layout(d, hp):
        rows = sum(n for _, _, n in segs)
        tile = unswizzle(image[off:off + rows * atom_k].reshape(rows, atom_k))
        off += rows * atom_k
        at = 0
        for key, row0, n in segs:
            part = tile[at:at + n]
            at += n
            kk = min(atom_k, out[key].shape[1] - k0)
            out[key][row0:row0 + n, k0:k0 + kk] = part[:, :kk]
            filled[key][row0:row0 + n, k0:k0 + kk] += 1
            assert not part[:, kk:].any(), "K padding of a tile must be zero"
    assert off == image.numel(), "pack image longer than its layout"
    assert all(bool((f == 1).all()) for f in filled.values()), "each weight packed once"
    return {k: v.t().contiguous() for k, v in out.items()}


@pytest.mark.parametrize("d,hid", [(64, swiglu_hidden_dim(64)), (128, swiglu_hidden_dim(128)),
                                   (64, 8), (64, 100), (128, 36), (128, 120),
                                   (256, swiglu_hidden_dim(256)), (256, 8), (256, 100), (256, 120)])
def test_tf32_pack_is_the_split_weights_in_the_kernels_order(d, hid):
    """At D 64 and 128 the 3xTF32 kernel's pack, at D 256 the D 256
    kernel's, as ``kernel_weights`` gives them for float32."""
    p = random_block(d, hid, seed=d + hid)
    pack = tfb.kernel_weights(p, torch.float32)
    if d == tfb.TF32X3_WIDE_D:
        assert type(pack) is tfb.Tf32D256Pack
        layout, atom_k, unswizzle = d256_pack_layout, D256_ATOM_K, tfb.swizzle64
    else:
        assert type(pack) is tfb.Tf32Pack
        layout, atom_k, unswizzle = pack_layout, ATOM_K, tfb.swizzle128
    hp = tfb.padded_hidden(hid, tfb.TF32_HIDDEN_MULTIPLE)
    assert hp % 8 == 0 and 0 <= hp - hid < 8
    assert pack.hi.dtype == pack.lo.dtype == torch.float32
    assert pack.hi.numel() == pack.lo.numel() == sum(
        n * atom_k for segs, _ in layout(d, hp) for _, _, n in segs)
    for image in (pack.hi, pack.lo):  # TF32 values: the 13 low mantissa bits are zero
        assert not (image.view(torch.int32) & 0x1FFF).any()
    hi, lo = (unpack_image(image, d, hp, layout, atom_k, unswizzle) for image in (pack.hi, pack.lo))
    for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
        w = getattr(p, name)
        if name in ("w1", "w3"):
            w = F.pad(w, (0, hp - hid))
        elif name == "w2":
            w = F.pad(w, (0, 0, 0, hp - hid))
        assert hi[name].shape == w.shape, name
        assert torch.equal(hi[name], tf32(w)), name
        assert torch.equal(lo[name], tf32(w - tf32(w))), name
        assert ((hi[name] + lo[name] - w).abs() <= 2.0**-21 * w.abs()).all(), name
    # padded hidden columns and rows are exactly zero; the vectors as the bf16 pack has them
    assert not hi["w1"][:, hid:].any() and not hi["w2"][hid:].any() and not lo["w3"][:, hid:].any()
    pad = torch.zeros(hp - hid)
    want = torch.cat([p.ln1_scale, p.ln1_bias, p.bq, p.bk, p.bv, p.bo, p.ln2_scale, p.ln2_bias,
                      p.b2, torch.cat([p.b1, pad]), torch.cat([p.b3, pad])])
    assert torch.equal(pack.vecs, want)


def test_swizzle64_moves_chunk_j_of_row_r_to_j_xor_half_r():
    """The 64-byte swizzle of the D 256 pack, as the wgmma descriptor's
    layout type 2 reads it: in a row of four 16-byte chunks, chunk j of row
    r lies at chunk j ^ (r // 2 % 4), which repeats every 8 rows (512 B)."""
    rows = 24
    t = torch.arange(rows * 16, dtype=torch.float32).reshape(rows, 16)  # value = 16 r + c
    got = tfb.swizzle64(t)
    for r in range(rows):
        for j in range(4):
            want = t[r, 4 * j:4 * j + 4]
            at = j ^ (r // 2 % 4)
            assert torch.equal(got[r, 4 * at:4 * at + 4], want)
    assert torch.equal(tfb.swizzle64(got), t)


def swizzle128_bf16_before(t: torch.Tensor) -> torch.Tensor:
    """``swizzle128`` as it was before it learned float32 tiles (bf16 only)."""
    rows = t.shape[-2]
    r = torch.arange(rows, device=t.device)
    idx = torch.arange(8, device=t.device)[None, :] ^ (r[:, None] % 8)
    chunks = t.reshape(*t.shape[:-1], 8, 8)
    idx = idx[..., None].expand(*chunks.shape[-3:]).expand_as(chunks)
    return torch.gather(chunks, -2, idx).reshape(t.shape)


def pack_block_image_before(p: tfb.BlockParams) -> torch.Tensor:
    """The bf16 ``pack_block`` image as that function built it before."""
    d, hid = p.w1.shape
    hp = -(-hid // 16) * 16
    pad = hp - hid
    bf = torch.bfloat16

    def atoms(w, rows):
        n, k = w.shape
        w = F.pad(w, (0, -k % 64))
        return swizzle128_bf16_before(w.reshape(n // rows, rows, -1, 64).transpose(1, 2)).reshape(-1)

    w1t = F.pad(p.w1.t().to(bf), (0, 0, 0, pad))
    w3t = F.pad(p.w3.t().to(bf), (0, 0, 0, pad))
    w2t = F.pad(p.w2.t().to(bf), (0, pad))
    nt = min(d, 128)
    parts = [atoms(w.t().to(bf), nt) for w in (p.wq, p.wk, p.wv, p.wo)]
    for h0 in range(0, hp, 64):
        sl = slice(h0, min(h0 + 64, hp))
        parts.append(atoms(torch.cat([w1t[sl], w3t[sl]]), 2 * (sl.stop - h0)))
    parts.append(atoms(w2t, nt))
    return torch.cat(parts)


@pytest.mark.parametrize("d,hid", [(64, 172), (128, 344), (256, 684), (64, 100)])
def test_bf16_pack_is_byte_identical_to_before(d, hid):
    p = random_block(d, hid, seed=3 * d + hid)
    got, want = tfb.pack_block(p).image, pack_block_image_before(p)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_cpu_tensor_with_a_tf32_pack_takes_plain_version_without_launch():
    p = random_block(128, 344, seed=5)
    pack = tfb.pack_block_tf32(p)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 9, 128)).astype(np.float32))
    before = (tfb.TF32X3_LAUNCHES, tfb.TF32X3_D256_LAUNCHES, tfb.WGMMA_LAUNCHES)
    out = tfb.fused_encoder_block(x, pack, 8)
    assert (tfb.TF32X3_LAUNCHES, tfb.TF32X3_D256_LAUNCHES, tfb.WGMMA_LAUNCHES) == before
    torch.testing.assert_close(out, tfb.block_reference(x, p, 8), rtol=0, atol=0)


@pytest.mark.parametrize("d,dtype,kind", [(64, torch.float32, tfb.Tf32Pack),
                                          (128, torch.float32, tfb.Tf32Pack),
                                          (256, torch.float32, tfb.Tf32D256Pack),
                                          (128, torch.bfloat16, tfb.BlockPack),
                                          (256, torch.bfloat16, tfb.BlockD256Pack)])
def test_kernel_weights_follow_the_route(d, dtype, kind):
    """float32 at D 64 and 128 takes the 3xTF32 pack, float32 at D 256 the
    D 256 kernel's pack, bfloat16 at D 64 and 128 the bf16 pack, bfloat16 at
    D 256 the bf16 D 256 kernel's pack."""
    p = random_block(d, swiglu_hidden_dim(d), seed=d)
    assert type(tfb.kernel_weights(p, dtype)) is kind


def test_float32_model_packs_its_blocks_for_the_3xtf32_kernel():
    model = th.build_hsi_vit(tcfg.preset("HSIMAE-S"), 5, seed=1, device="cpu")
    with torch.inference_mode():
        packs = model.kernel_params("blocks")
        assert all(isinstance(pk, tfb.Tf32Pack) for pk in packs)
        assert model.kernel_params("blocks") is packs
    want = tfb.pack_block_tf32(tfb.params_from_block(model.blocks[0]))
    assert torch.equal(packs[0].hi, want.hi) and torch.equal(packs[0].lo, want.lo)

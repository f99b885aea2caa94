"""The bf16 fused-block kernel at D 256 (``csrc/fused_block_wgmma_d256.cu``)
on the CPU: its weight pack (``pack_block_wgmma_d256``), its route, and the
plain version it is held to, against the JAX package.

* The pack, read back through the kernel's stage order written out here
  from the kernel's source note, is the bf16 weights with a zero-padded
  hidden axis, byte for byte; where each stage starts and how long it is
  follows the kernel's own arithmetic (``stage_of``, ported below).
* bf16 at D 256 takes the new pack (``kernel_weights``, ``ROUTES``, the
  registered op), and a CPU tensor with it runs ``block_reference`` and
  launches nothing.
* ``fused_encoder_block`` on a CPU bf16 block at D 256 against JAX's
  ``fused_encoder_block`` (its plain math on the CPU), 5e-2 as
  ``tests/test_torch_fused_block.py`` holds bf16; an HSIMAE-L-width bf16
  classifier (D 256, 16 heads, SwiGLU 684, depth cut to 2) from JAX
  parameters against JAX's bf16 classifier.
* A bf16 HSIMAE-L serving artifact made with the old route (the D 128
  kernel's pack at D 256) refuses to load and says to export it again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsimae_tpu import config as jcfg
from hsimae_tpu.models import hsimae as jh
from hsimae_tpu.ops import fused_block as jfb
from hsimae_tpu_torch import config as tcfg
from hsimae_tpu_torch.checkpoints.convert import from_jax_params
from hsimae_tpu_torch.models import hsimae as th
from hsimae_tpu_torch.models.layers import swiglu_hidden_dim
from hsimae_tpu_torch.ops import fused_block as tfb
from hsimae_tpu_torch.serving import export as texp

BF16 = torch.bfloat16
D, HEADS = 256, 16
HID_L = swiglu_hidden_dim(D)  # HSIMAE-L's 684, padded to 688
ATOM_K = 64  # bf16 K columns of one 128-byte swizzle atom
# hidden widths: HSIMAE-L's (last hidden tile 48 wide: sub-tiles of 32 and
# 16), one whose last tile is a single sub-tile of 16, and one of two full tiles
HIDDEN_CASES = [HID_L, 8, 128]
L_CUT = dict(depth=2, s_depth=1, decoder_depth=1)  # HSIMAE-L's widths, depth cut to 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the fast tier runs six
    pytest workers on the machine's cores, and torch's default pool (a
    thread per core in each worker) oversubscribes them. Restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_block(hid: int, seed: int) -> dict:
    """Unit-gain random weights (1/sqrt(fan_in)), LN scales around 1."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (D, hid), "b1": (hid,), "w3": (D, hid), "b3": (hid,), "w2": (hid, D)}
    out = {}
    for f in tfb.BlockParams._fields:
        shape = shapes.get(f, (D, D) if f.startswith("w") else (D,))
        if f.startswith("w"):
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            v = 0.1 * rng.standard_normal(shape) + (1.0 if f.endswith("scale") else 0.0)
        out[f] = v.astype(np.float32)
    return out


def torch_block(hid: int, seed: int) -> tfb.BlockParams:
    return tfb.BlockParams(**{k: torch.from_numpy(v) for k, v in numpy_block(hid, seed).items()})


def stage_layout(hp: int) -> list:
    """The kernel's stages of one row tile, in its order, as ``(matrix, n0,
    rows, k0)``: output rows ``n0 : n0 + rows`` of the matrix in ``[out,
    in]`` layout, input columns ``k0 : k0 + 64``. ``qk`` stacks q's rows
    over k's (64 each, from n0), ``w13`` W1's hidden rows over W3's (rows /
    2 each, from n0)."""
    stages = []
    for c0 in range(0, D, 64):  # head groups
        stages += [("qk", c0, 128, k0) for k0 in range(0, D, ATOM_K)]
        stages += [("wv", c0, 64, k0) for k0 in range(0, D, ATOM_K)]
    stages += [("wo", n0, 128, k0) for n0 in (0, 128) for k0 in range(0, D, ATOM_K)]
    for h0 in range(0, hp, 64):  # hidden tiles of 64 columns, [W1 | W3] by 32
        h1 = min(h0 + 64, hp)
        for a in range(h0, h1, 32):
            stages += [("w13", a, 2 * (min(a + 32, h1) - a), k0) for k0 in range(0, D, ATOM_K)]
        stages += [("w2", n0, 128, h0) for n0 in (0, 128)]
    return stages


def kernel_locate(a: int, hp: int) -> tuple:
    """``stage_of`` of the kernel, line for line: stage a's bytes and its
    byte offset in the pack. A stage holds one K atom of a 128-row tile or
    two of a 64-row one (v, [W1 | W3])."""
    k_ka, qk, v, slot, sub = 4, 128 * 128, 64 * 128, 16384, 32
    group_stages, wo_stages, hid_stages = k_ka + k_ka // 2, 2 * k_ka, 2 * (k_ka // 2) + 2
    group_bytes, hid_bytes = k_ka * (qk + v), k_ka * 2 * 64 * 128 + 2 * slot
    if a < 4 * group_stages:
        i = a % group_stages
        return ((qk if i < k_ka else 2 * v),
                a // group_stages * group_bytes + (i * qk if i < k_ka else k_ka * qk + (i - k_ka) * 2 * v))
    a -= 4 * group_stages
    off = 4 * group_bytes
    if a < wo_stages:
        return slot, off + a * slot
    a -= wo_stages
    t, i = divmod(a, hid_stages)
    tw = min(64, hp - 64 * t)
    off += wo_stages * slot + t * hid_bytes
    nsub, per = -(-tw // sub), k_ka // 2
    if i < nsub * per:
        s, sw = i // per, min(sub, tw - i // per * sub)
        return 2 * (2 * sw * 128), off + s * k_ka * 2 * sub * 128 + i % per * 2 * (2 * sw * 128)
    return slot, off + k_ka * 2 * tw * 128 + (i - nsub * per) * slot


def kernel_stage_count(hp: int) -> int:
    """``stage_count`` of the kernel."""
    nfull, rest = divmod(hp, 64)
    return 4 * 6 + 8 + nfull * 6 + ((-(-rest // 32)) * 2 + 2 if rest else 0)


def kernel_stages(hp: int) -> list:
    """The layout's tiles as the kernel's stages take them: ``(bytes,
    offset)`` a stage, the K atoms of v and of [W1 | W3] two a stage."""
    stages, off, pending = [], 0, None
    for name, _, rows, _ in stage_layout(hp):
        n = rows * ATOM_K * 2
        if name in ("wv", "w13"):
            if pending is None:
                pending = (n, off)
            else:
                stages.append((pending[0] + n, pending[1]))
                pending = None
        else:
            stages.append((n, off))
        off += n
    assert pending is None
    return stages


def unpack(pack: tfb.BlockD256Pack) -> dict:
    """The matrices of a pack, read back through :func:`stage_layout`, in
    float32 ``[in, out]`` layout with the padded hidden axis."""
    hp = tfb.padded_hidden(pack.params.w1.shape[-1])
    out = {k: torch.zeros(D, D) for k in ("wq", "wk", "wv", "wo")}
    out.update(w1=torch.zeros(hp, D), w3=torch.zeros(hp, D), w2=torch.zeros(D, hp))  # [out, in]
    image, off = pack.image, 0
    for name, n0, rows, k0 in stage_layout(hp):
        tile = tfb.swizzle128(image[off:off + rows * ATOM_K].reshape(rows, ATOM_K)).float()
        off += rows * ATOM_K
        if name in ("qk", "w13"):
            a, b = ("wq", "wk") if name == "qk" else ("w1", "w3")
            parts = ((a, tile[:rows // 2]), (b, tile[rows // 2:]))
        else:
            parts = ((name, tile),)
        for key, part in parts:
            kk = min(ATOM_K, out[key].shape[1] - k0)
            out[key][n0:n0 + part.shape[0], k0:k0 + kk] = part[:, :kk]
            assert not part[:, kk:].any(), "K padding of a tile must be zero"
    assert off == image.numel(), "pack image longer than its layout"
    return {k: v.t().contiguous() for k, v in out.items()}


@pytest.mark.parametrize("hid", HIDDEN_CASES)
def test_unpacked_image_is_the_bf16_weights_with_zero_padding(hid):
    p = torch_block(hid, seed=hid)
    pack = tfb.pack_block_wgmma_d256(p)
    hp = tfb.padded_hidden(hid)
    assert pack.image.dtype == BF16 and pack.vecs.dtype == torch.float32
    u = unpack(pack)
    for name in ("wq", "wk", "wv", "wo"):
        assert torch.equal(u[name], getattr(p, name).to(BF16).float()), name
    for name in ("w1", "w3"):
        assert torch.equal(u[name][:, :hid], getattr(p, name).to(BF16).float()), name
        assert not u[name][:, hid:].any(), name  # padded hidden columns are exactly zero
    assert torch.equal(u["w2"][:hid], p.w2.to(BF16).float()) and not u["w2"][hid:].any()
    assert torch.equal(pack.vecs, tfb.pack_block(p).vecs)  # the vectors as the D 128 pack's
    # where the kernel looks for each stage: its bytes and offsets, stage after stage
    stages = kernel_stages(hp)
    assert kernel_stage_count(hp) == len(stages)
    assert [kernel_locate(a, hp) for a in range(len(stages))] == stages
    assert sum(n for n, _ in stages) == 2 * pack.image.numel()


@pytest.mark.parametrize("hid", [HID_L, 8])
def test_block_reference_on_unpacked_weights_equals_the_originals(hid):
    """The unpacked, padded weights compute the block of the originals: in
    bf16, where block_reference rounds the weights as it reads them, to one
    bf16 step (a different f32 sum may round to the neighbouring value)."""
    p = torch_block(hid, seed=3 * hid)
    u = unpack(tfb.pack_block_wgmma_d256(p))
    pad = tfb.padded_hidden(hid) - hid
    padded = p._replace(wq=u["wq"], wk=u["wk"], wv=u["wv"], wo=u["wo"], w1=u["w1"], w3=u["w3"],
                        w2=u["w2"], b1=torch.nn.functional.pad(p.b1, (0, pad)),
                        b3=torch.nn.functional.pad(p.b3, (0, pad)))
    x = torch.from_numpy(np.random.default_rng(hid).standard_normal((3, 9, D)).astype(np.float32))
    got = tfb.block_reference(x.to(BF16), padded, HEADS).float()
    want = tfb.block_reference(x.to(BF16), p, HEADS).float()
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_cpu_tensor_with_the_d256_pack_takes_plain_version_without_launch():
    p = torch_block(HID_L, seed=1)
    pack = tfb.pack_block_wgmma_d256(p)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 9, D)).astype(np.float32))
    before = tfb.launch_counts()
    out = tfb.fused_encoder_block(x.to(BF16), pack, HEADS)
    assert tfb.launch_counts() == before
    assert set(before) == {"fused_block_tf32x3", "fused_block_tf32x3_d256", "fused_block_wgmma",
                           "fused_block_wgmma_d256"}
    torch.testing.assert_close(out, tfb.block_reference(x.to(BF16), p, HEADS), rtol=0, atol=0)


def test_the_d256_pack_has_its_own_route():
    """kernel_weights gives the new pack for bf16 at D 256 only; the route
    survives pack_tensors / tensors_pack, and the registered op on a CPU
    tensor is block_reference."""
    p = torch_block(HID_L, seed=2)
    pack = tfb.kernel_weights(p, BF16)
    assert type(pack) is tfb.BlockD256Pack
    route, tensors = tfb.pack_tensors(pack)
    assert route == "fused_block_wgmma_d256" == tfb.ROUTES[tfb.BlockD256Pack]
    back = tfb.tensors_pack(route, tensors)
    assert type(back) is tfb.BlockD256Pack and back.image is pack.image
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4, D)).astype(np.float32))
    torch.testing.assert_close(torch.ops.hsimae.fused_block(x.to(BF16), tensors, route, HEADS),
                               tfb.block_reference(x.to(BF16), p, HEADS), rtol=0, atol=0)
    assert type(tfb.kernel_weights(p, torch.float32)) is tfb.Tf32D256Pack


@pytest.mark.parametrize("s", [4, 9, 36])
def test_fused_encoder_block_with_the_d256_pack_matches_jax(s):
    """bf16 at D 256 through the port's wrapper (its plain version on the
    CPU) against JAX's fused_encoder_block (its plain math on the CPU):
    5e-2, as bf16 is held in test_torch_fused_block.py (both round to bf16
    at the same points; a different f32 sum can round to a neighbouring
    bf16 value)."""
    w = numpy_block(HID_L, seed=100 + s)
    jp = jfb.BlockParams(**{k: jnp.asarray(v) for k, v in w.items()})
    tp = tfb.BlockParams(**{k: torch.from_numpy(v) for k, v in w.items()})
    x = np.random.default_rng(s).standard_normal((5, s, D)).astype(np.float32)
    want = np.asarray(jfb.fused_encoder_block(jnp.asarray(x, jnp.bfloat16), jp, HEADS), np.float32)
    got = tfb.fused_encoder_block(torch.from_numpy(x).to(BF16), tfb.kernel_weights(tp, BF16), HEADS)
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_hsimae_l_bf16_classifier_matches_jax():
    """HSIMAE-L's widths (D 256, 16 heads, SwiGLU 684), depth cut to 2, in
    bf16, built from JAX parameters: every block stack packs for the D 256
    kernel, and the logits match JAX's bf16 classifier (its fused path, plain
    math on the CPU) within 2e-2 scaled by max(1, |logit|): each of the three
    blocks may differ from JAX's by a bf16 step (2^-8 relative) where an f32
    sum rounds to the neighbouring value, and the final norm and the head
    carry that into the logits; 2e-2 is five such steps."""
    jc = jcfg.preset("HSIMAE-L", **L_CUT, compute_dtype=jnp.bfloat16, use_pallas=True)
    tc = tcfg.preset("HSIMAE-L", **L_CUT, compute_dtype=BF16)
    assert (tc.embed_dim, tc.num_heads, swiglu_hidden_dim(tc.embed_dim)) == (D, HEADS, HID_L)
    jm = jh.build_hsi_vit(jc, 5)
    params = jax.tree_util.tree_map(np.asarray, jh.init_model(jm, seed=0)["params"])
    x = np.random.default_rng(1).standard_normal((6, 9, 9, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, False,
                                                    method=jh.HSIMAE.classify))(params, x), np.float32)
    model = th.build_hsi_vit(tc, 5, device="cpu", state_dict=from_jax_params(params, tc))
    before = tfb.launch_counts()
    with torch.inference_mode():
        got = model.classify(torch.from_numpy(x)).float().numpy()
        for name in ("blocks_1", "blocks_2", "blocks"):
            packs = model.kernel_params(name)
            assert packs and all(type(pk) is tfb.BlockD256Pack for pk in packs), name
    assert tfb.launch_counts() == before  # CPU tensors take the plain version
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= 2e-2, err


def test_old_hsimae_l_bf16_artifact_refuses_to_load():
    """An artifact exported before the D 256 kernel (its programs name the
    D 128 kernel's route at D 256) raises on load and says to export again;
    one exported now names the new route and serves."""
    cfg = tcfg.preset("HSIMAE-L", **L_CUT, compute_dtype=BF16)
    model = th.build_hsi_vit(cfg, 5, seed=0, device="cpu")
    blob = texp.export_classifier(model.state_dict(), cfg, 5, batch_sizes=(2,), platforms=("cpu",),
                                  device="cpu")
    clf = texp.load_classifier(blob, device="cpu")
    assert texp.program_routes(clf._calls[2]) == {"fused_block_wgmma_d256"}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, 9, 32)).astype(np.float32))
    with torch.inference_mode():
        want = model.classify(x).float()
    torch.testing.assert_close(clf.predict_logits(x).float(), want, rtol=0, atol=0)

    real = tfb.kernel_weights
    try:  # the layout the old library built for bf16 at D 256
        tfb.kernel_weights = lambda p, dt: tfb.pack_block(p) if dt == BF16 else real(p, dt)
        old = texp.export_classifier(model.state_dict(), cfg, 5, batch_sizes=(2,),
                                     platforms=("cpu",), device="cpu")
    finally:
        tfb.kernel_weights = real
    with pytest.raises(ValueError, match="export the weights again"):
        texp.load_classifier(old, device="cpu")

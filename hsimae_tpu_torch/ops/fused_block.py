"""One fused pre-LN transformer block: CUDA kernels, wrapper and plain version.

Counterpart of ``hsimae_tpu/ops/fused_block.py``. The Pallas TPU kernel
(``_kernel``, math ``_block_math``) becomes three hand-written CUDA kernels
for sm_90a, chosen by stream dtype and width (a fixed route, never a
fallback), built by ``nvcc`` and bound with ``ctypes``
(:mod:`hsimae_tpu_torch.ops._build`):

* float32 at D 64 and 128: ``csrc/fused_block_tf32x3.cu``, 3xTF32 wgmma on
  the tensor cores (each product as ``a_lo b_hi + a_hi b_lo + a_hi b_hi``,
  which holds the 2e-5 check that one TF32 product does not); takes a
  :class:`Tf32Pack`, the weights split once into TF32 hi and lo images by
  :func:`pack_block_tf32`;
* float32 at D 256: ``csrc/fused_block_tf32x3_d256.cu``, the same
  arithmetic with attention by head group and the SwiGLU half by hidden
  tile (the D 128 kernel's tile does not fit in shared memory at that
  width); takes a :class:`Tf32D256Pack` from :func:`pack_block_tf32_d256`;
* bfloat16: ``csrc/fused_block_wgmma.cu``, on the tensor cores (wgmma fed by
  bulk async copies through a shared-memory ring, persistent CTAs); takes a
  :class:`BlockPack`, the block's weights packed once by :func:`pack_block`.

:func:`kernel_weights` gives the weights in the form the route takes. One
launch covers all M sequences; the JAX package's ``fused_block_sliced`` (a
TPU compile workaround) has no counterpart.

* :func:`block_reference` is the plain PyTorch version of the block math.
* :func:`fused_encoder_block` is the wrapper: on a CPU tensor it returns the
  plain version; on a CUDA tensor it launches the route's kernel or raises.
  ``TF32X3_LAUNCHES``, ``TF32X3_D256_LAUNCHES`` and ``WGMMA_LAUNCHES``
  count launches of the float32 kernels at D 64/128 and D 256 and of the
  bfloat16 kernel.
* :func:`fused_block_op` registers the wrapper as the operator
  ``torch.ops.hsimae.fused_block`` (CUDA: the wrapper; CPU: the plain
  version; fake: ``empty_like(x)``), with the weights flattened by
  :func:`pack_tensors`, so an exported program (``hsimae_tpu_torch.serving``)
  runs the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hsimae_tpu_torch.ops import _build

# Kernel launches since import (or since a caller last set them to 0): the
# float32 3xTF32 kernels at D 64/128 and at D 256, and the bfloat16 wgmma
# kernel.
TF32X3_LAUNCHES = 0
TF32X3_D256_LAUNCHES = 0
WGMMA_LAUNCHES = 0

SUPPORTED_D = (64, 128, 256)
TF32X3_D = (64, 128)  # float32 widths of fused_block_tf32x3.cu
TF32X3_WIDE_D = 256  # the float32 width of fused_block_tf32x3_d256.cu
HEAD_DIM = 16
_DTYPES = (torch.float32, torch.bfloat16)

# Weight pack of the bf16 kernel: tiles of up to 128 output rows x 64 K
# columns (one 128-byte swizzle atom), in the order the kernel consumes them:
# wq, wk, wv, wo (output-row blocks of min(D, 128), K atoms inner), then per
# 64 hidden columns W1's rows over W3's (K atoms inner), then W2.
HIDDEN_MULTIPLE = 16  # wgmma's K step for bf16: the padded hidden axis
_ATOM_K = 64
_HID_TILE = 64  # hidden columns per interleaved [W1 | W3] tile

# Weight pack of the 3xTF32 kernel: the same tile order with atoms of 32
# float32 K columns (128 bytes), the hidden axis padded to TF32's K step. Its
# two consumer warpgroups split each [W1 | W3] tile's tw hidden columns, the
# first taking tw0 = ceil8(tw / 2): the tile holds W1 over W3 for those,
# then W1 over W3 for the rest.
TF32_HIDDEN_MULTIPLE = 8
_TF32_ATOM_K = 32

# Weight pack of the D 256 kernel (same hidden padding, hi and lo images):
# atoms of 16 float32 K columns (64-byte rows, 64-byte swizzle), each a
# whole product's output rows, in the order the kernel consumes them: per
# head group of 64 columns, the [q | v0 | k | v1] rows (v's first 32
# columns with q for the first warpgroup, its last 32 with k for the
# second), then that group's K slice of Wo (all 256 output rows); per 64
# hidden columns, the [W1 | W3] tile as in the 3xTF32 pack, then that
# tile's K slice of W2.
_D256_ATOM_K = 16
_GROUP_COLS = 64


class BlockParams(NamedTuple):
    """Weights of one Block in matmul layout ([in, out] kernels), float32."""

    ln1_scale: torch.Tensor  # [D]
    ln1_bias: torch.Tensor  # [D]
    wq: torch.Tensor  # [D, D]
    bq: torch.Tensor  # [D]
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    w1: torch.Tensor  # [D, H]
    b1: torch.Tensor  # [H]
    w3: torch.Tensor  # [D, H]
    b3: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, D]
    b2: torch.Tensor  # [D]


def params_from_state(state: dict, prefix: str = "") -> BlockParams:
    """Block ``prefix`` (``"blocks_1.3."``) of a state dict with the
    reference's names, in matmul layout (``Linear.weight [out, in]``
    transposed to ``[in, out]``)."""

    def t(name):
        return state[f"{prefix}{name}.weight"].detach().t().contiguous()

    def v(name, leaf):
        return state[f"{prefix}{name}.{leaf}"].detach()

    return BlockParams(
        ln1_scale=v("norm1", "weight"), ln1_bias=v("norm1", "bias"),
        wq=t("attn.q"), bq=v("attn.q", "bias"), wk=t("attn.k"), bk=v("attn.k", "bias"),
        wv=t("attn.v"), bv=v("attn.v", "bias"), wo=t("attn.proj"), bo=v("attn.proj", "bias"),
        ln2_scale=v("norm2", "weight"), ln2_bias=v("norm2", "bias"),
        w1=t("mlp.w1"), b1=v("mlp.w1", "bias"), w3=t("mlp.w3"), b3=v("mlp.w3", "bias"),
        w2=t("mlp.w2"), b2=v("mlp.w2", "bias"),
    )


def launch_counts() -> dict:
    """Each kernel's launches in this process so far: name -> count."""
    return {"fused_block_tf32x3": TF32X3_LAUNCHES, "fused_block_tf32x3_d256": TF32X3_D256_LAUNCHES,
            "fused_block_wgmma": WGMMA_LAUNCHES}


def params_from_block(block) -> BlockParams:
    """A :class:`hsimae_tpu_torch.models.layers.Block`'s weights in matmul
    layout (:func:`params_from_state` of its state dict). A block whose
    weights are tensor-parallel shards (``DTensor``) is refused: the kernel
    takes a whole block, and tensor parallelism is a training path."""
    state = block.state_dict()
    sharded = [k for k, t in state.items() if hasattr(t, "device_mesh")]
    if sharded:
        raise ValueError(f"the fused-block kernel takes whole blocks; {sharded[0]} is a "
                         "tensor-parallel shard (tensor parallelism serves training only: "
                         "run the model in train mode, or with use_kernel=False)")
    return params_from_state(state)


class BlockPack(NamedTuple):
    """One block's weights as the bf16 kernel reads them, built once by
    :func:`pack_block`."""

    params: BlockParams  # the float32 weights it was packed from
    image: torch.Tensor  # bf16, 1-D: the swizzled weight tiles in the kernel's order
    vecs: torch.Tensor  # float32, 1-D: ln1 (scale, bias), bq, bk, bv, bo, ln2, b2, b1, b3


class Tf32Pack(NamedTuple):
    """One block's weights as the 3xTF32 kernel reads them, built once by
    :func:`pack_block_tf32`: two images of the same layout."""

    params: BlockParams  # the float32 weights it was packed from
    hi: torch.Tensor  # float32, 1-D: rna_tf32(w), swizzled tiles in the kernel's order
    lo: torch.Tensor  # float32, 1-D: rna_tf32(w - hi), the same layout
    vecs: torch.Tensor  # float32, 1-D: as BlockPack.vecs


class Tf32D256Pack(NamedTuple):
    """One D 256 block's weights as the D 256 kernel reads them, built
    once by :func:`pack_block_tf32_d256`: as :class:`Tf32Pack`, in that
    kernel's tile order and swizzle."""

    params: BlockParams
    hi: torch.Tensor
    lo: torch.Tensor
    vecs: torch.Tensor


def padded_hidden(hidden: int, multiple: int = HIDDEN_MULTIPLE) -> int:
    return -(-hidden // multiple) * multiple


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of tiles ``[..., rows, 8 c]`` whose rows are
    eight 16-byte chunks of c elements (64 bf16 or 32 float32 columns): the
    chunk j of row r moves to chunk ``j ^ (r % 8)``. It is its own inverse."""
    rows, cols = t.shape[-2:]
    r = torch.arange(rows, device=t.device)
    idx = torch.arange(8, device=t.device)[None, :] ^ (r[:, None] % 8)  # [rows, 8]
    chunks = t.reshape(*t.shape[:-1], 8, cols // 8)
    idx = idx[..., None].expand(*chunks.shape[-3:]).expand_as(chunks)
    return torch.gather(chunks, -2, idx).reshape(t.shape)


def swizzle64(t: torch.Tensor) -> torch.Tensor:
    """The 64-byte swizzle of tiles ``[..., rows, 4 c]`` whose rows are four
    16-byte chunks of c elements (16 float32 columns): the chunk j of row r
    moves to chunk ``j ^ (r // 2 % 4)``. It is its own inverse."""
    rows, cols = t.shape[-2:]
    r = torch.arange(rows, device=t.device)
    idx = torch.arange(4, device=t.device)[None, :] ^ (r[:, None] // 2 % 4)  # [rows, 4]
    chunks = t.reshape(*t.shape[:-1], 4, cols // 4)
    idx = idx[..., None].expand(*chunks.shape[-3:]).expand_as(chunks)
    return torch.gather(chunks, -2, idx).reshape(t.shape)


def rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: the 13 low mantissa bits end zero.
    Adding half of the dropped range to the bit pattern rounds the
    magnitude, whatever the sign."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _atoms(w: torch.Tensor, rows: int, atom_k: int, swizzle=swizzle128) -> torch.Tensor:
    """``w [N, K]`` (``[out, in]``) as swizzled tiles of ``rows`` x
    ``atom_k`` (128 bytes a row for ``swizzle128``, 64 for ``swizzle64``),
    output-row blocks outer, K atoms inner; K zero-padded to ``atom_k``."""
    n, k = w.shape
    w = F.pad(w, (0, -k % atom_k))
    tiles = w.reshape(n // rows, rows, -1, atom_k).transpose(1, 2)
    return swizzle(tiles).reshape(-1)


def _image(p: BlockParams, dtype: torch.dtype, hp: int, atom_k: int,
           split_hidden: bool = False) -> torch.Tensor:
    """Every matrix cast to ``dtype``, transposed to ``[out, in]``, cut into
    tiles in the kernels' order (above) and swizzled, the hidden axis
    zero-padded to ``hp``; ``split_hidden`` orders each [W1 | W3] tile's
    rows for the 3xTF32 kernel's two warpgroups (above)."""
    d, hid = p.w1.shape
    pad = hp - hid
    w1t = F.pad(p.w1.t().to(dtype), (0, 0, 0, pad))  # [hp, d]
    w3t = F.pad(p.w3.t().to(dtype), (0, 0, 0, pad))
    w2t = F.pad(p.w2.t().to(dtype), (0, pad))  # [d, hp]
    nt = min(d, 128)
    parts = [_atoms(w.t().to(dtype), nt, atom_k) for w in (p.wq, p.wk, p.wv, p.wo)]
    for h0 in range(0, hp, _HID_TILE):
        h1 = min(h0 + _HID_TILE, hp)
        cuts = _hidden_cuts(h0, h1) if split_hidden else (h0, h1)
        rows = [w[a:b] for a, b in zip(cuts, cuts[1:]) for w in (w1t, w3t)]
        parts.append(_atoms(torch.cat(rows), 2 * (h1 - h0), atom_k))
    parts.append(_atoms(w2t, nt, atom_k))
    return torch.cat(parts).contiguous()


def _vecs(p: BlockParams, hp: int) -> torch.Tensor:
    pad = hp - p.b1.shape[0]
    return torch.cat([p.ln1_scale, p.ln1_bias, p.bq, p.bk, p.bv, p.bo, p.ln2_scale, p.ln2_bias,
                      p.b2, F.pad(p.b1, (0, pad)), F.pad(p.b3, (0, pad))]).float().contiguous()


@torch.no_grad()
def pack_block(p: BlockParams) -> BlockPack:
    """Pack one block for the bf16 kernel, on the weights' device: every
    matrix rounded to bf16, transposed to ``[out, in]``, cut into tiles in
    the kernel's order (above) and swizzled; the hidden axis
    zero-padded to a multiple of 16 (exact: silu(0) * 0 = 0, and the padded
    rows of W2 are zero). Done once per model, never per launch."""
    hp = padded_hidden(p.w1.shape[-1])
    return BlockPack(p, _image(p, torch.bfloat16, hp, _ATOM_K), _vecs(p, hp))


@torch.no_grad()
def pack_block_tf32(p: BlockParams) -> Tf32Pack:
    """Pack one block for the 3xTF32 kernel, on the weights' device: the
    float32 image in the bf16 pack's tile order, with atoms of 32 K columns,
    each [W1 | W3] tile's rows in two warpgroup halves (above) and the
    hidden axis zero-padded to a multiple of 8, split into
    ``hi = rna_tf32(w)`` and ``lo = rna_tf32(w - hi)`` (wgmma reads TF32
    operands without rounding their low bits, so both are rounded here;
    ``hi + lo`` is within 2^-21 of w, relative). Done once per model."""
    hp = padded_hidden(p.w1.shape[-1], TF32_HIDDEN_MULTIPLE)
    image = _image(p, torch.float32, hp, _TF32_ATOM_K, split_hidden=True)
    hi = rna_tf32(image)
    return Tf32Pack(p, hi, rna_tf32(image - hi), _vecs(p, hp))


def _hidden_cuts(h0: int, h1: int) -> tuple:
    """Row cuts of the [W1 | W3] tile of hidden columns h0:h1 between the
    3xTF32 kernels' two warpgroups: the first takes ceil8((h1 - h0) / 2)."""
    return h0, h0 + (h1 - h0 + 15) // 16 * 8, h1


def _d256_image(p: BlockParams, hp: int) -> torch.Tensor:
    """The float32 image of the D 256 kernel's pack (order above), the hidden
    axis zero-padded to ``hp``."""
    pad = hp - p.w1.shape[1]
    wq, wk, wv, wo = (w.t() for w in (p.wq, p.wk, p.wv, p.wo))  # [out, in]
    w1t = F.pad(p.w1.t(), (0, 0, 0, pad))  # [hp, d]
    w3t = F.pad(p.w3.t(), (0, 0, 0, pad))
    w2t = F.pad(p.w2.t(), (0, pad))  # [d, hp]
    g, half, k = _GROUP_COLS, _GROUP_COLS // 2, _D256_ATOM_K
    parts = []
    for c0 in range(0, p.wq.shape[0], g):
        parts += [torch.cat([wq[c0:c0 + g], wv[c0:c0 + half], wk[c0:c0 + g], wv[c0 + half:c0 + g]]),
                  wo[:, c0:c0 + g]]
    for h0 in range(0, hp, _HID_TILE):
        cuts = _hidden_cuts(h0, min(h0 + _HID_TILE, hp))
        parts += [torch.cat([w[a:b] for a, b in zip(cuts, cuts[1:]) for w in (w1t, w3t)]),
                  w2t[:, h0:cuts[-1]]]
    return torch.cat([_atoms(w.float(), w.shape[0], k, swizzle64) for w in parts]).contiguous()


@torch.no_grad()
def pack_block_tf32_d256(p: BlockParams) -> Tf32D256Pack:
    """Pack one D 256 block for the D 256 kernel, on the weights' device:
    the float32 image in that kernel's order (above), K atoms of 16 columns
    with the 64-byte swizzle, the hidden axis zero-padded to a multiple of
    8, split into TF32 ``hi`` and ``lo`` as :func:`pack_block_tf32` does.
    Done once per model."""
    hp = padded_hidden(p.w1.shape[-1], TF32_HIDDEN_MULTIPLE)
    image = _d256_image(p, hp)
    hi = rna_tf32(image)
    return Tf32D256Pack(p, hi, rna_tf32(image - hi), _vecs(p, hp))


def kernel_weights(p: BlockParams, dtype: torch.dtype) -> BlockParams | BlockPack | Tf32Pack | Tf32D256Pack:
    """The weights in the form the kernel of stream ``dtype`` at the
    block's width takes: a :class:`BlockPack` for bfloat16, a
    :class:`Tf32Pack` for float32 at D 64 and 128, a
    :class:`Tf32D256Pack` for float32 at D 256. At a width no kernel
    takes, the :class:`BlockParams` themselves (the CPU's plain version
    runs them; a CUDA tensor raises)."""
    if dtype == torch.bfloat16:
        return pack_block(p)
    d = p.wq.shape[0]
    if d in TF32X3_D:
        return pack_block_tf32(p)
    if d == TF32X3_WIDE_D:
        return pack_block_tf32_d256(p)
    return p


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)) * scale.float() + bias.float()


def block_reference(x: torch.Tensor, p: BlockParams, num_heads: int) -> torch.Tensor:
    """The block on ``[M, S, D]`` in plain PyTorch, computing in ``x.dtype``:
    operands rounded to ``x.dtype``, every product accumulated in float32,
    LayerNorm, softmax and the SwiGLU gate in float32."""
    cd = x.dtype
    m, s, d = x.shape
    hd = d // num_heads

    def mm(a, w, b, out_dtype=cd):
        out = a.float() @ w.to(cd).float()
        return (out + b.float()).to(out_dtype)

    y = _ln(x, p.ln1_scale, p.ln1_bias).to(cd)
    q = mm(y, p.wq, p.bq).reshape(m, s, num_heads, hd).transpose(1, 2)  # [m, h, s, hd]
    k = mm(y, p.wk, p.bk).reshape(m, s, num_heads, hd).transpose(1, 2)
    v = mm(y, p.wv, p.bv).reshape(m, s, num_heads, hd).transpose(1, 2)
    logits = (q.float() @ k.float().transpose(-1, -2)) * (hd**-0.5)
    attn = torch.softmax(logits, dim=-1).to(cd)
    o = (attn.float() @ v.float()).to(cd).transpose(1, 2).reshape(m, s, d)
    x = x + mm(o, p.wo, p.bo).to(x.dtype)

    y2 = _ln(x, p.ln2_scale, p.ln2_bias).to(cd)
    h1 = mm(y2, p.w1, p.b1, torch.float32)
    h3 = mm(y2, p.w3, p.b3, torch.float32)
    h = (F.silu(h1) * h3).to(cd)
    return x + mm(h, p.w2, p.b2).to(x.dtype)


def _check(x: torch.Tensor, p: BlockParams, num_heads: int, max_seq: int) -> None:
    """Raise unless the kernel takes ``x`` and ``p``; ``max_seq`` is the
    longest sequence one CTA holds, as the kernel library reports it."""
    if x.dim() != 3:
        raise ValueError(f"x must be [M, S, D], got {tuple(x.shape)}")
    m, s, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused block kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if d not in SUPPORTED_D or d != num_heads * HEAD_DIM:
        raise ValueError(f"unsupported width D={d} with {num_heads} heads (D in {SUPPORTED_D}, head dim 16)")
    if not 1 <= s <= max_seq:
        raise ValueError(f"unsupported sequence length S={s} at D={d} (max {max_seq})")
    if m * s * d >= 2**31:
        raise ValueError("x is too large for one launch")
    hid = p.w1.shape[-1]
    if hid % 4:
        raise ValueError(f"SwiGLU hidden width {hid} must be a multiple of 4")
    want = {"ln1_scale": (d,), "ln1_bias": (d,), "wq": (d, d), "bq": (d,), "wk": (d, d),
            "bk": (d,), "wv": (d, d), "bv": (d,), "wo": (d, d), "bo": (d,),
            "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, hid), "b1": (hid,),
            "w3": (d, hid), "b3": (hid,), "w2": (hid, d), "b2": (d,)}
    for name, t in p._asdict().items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_wgmma(x: torch.Tensor, pack: BlockPack, num_heads: int) -> torch.Tensor:
    """The bfloat16 tensor-core kernel."""
    global WGMMA_LAUNCHES
    lib = _build.load_library("fused_block_wgmma")
    d = x.shape[-1]
    _check(x, pack.params, num_heads, lib.hsimae_fused_block_wgmma_max_seq(d))
    hp = padded_hidden(pack.params.w1.shape[-1])
    if hp > lib.hsimae_fused_block_wgmma_max_hidden(d):
        raise ValueError(f"unsupported padded hidden width {hp} at D={d}")
    want = lib.hsimae_fused_block_wgmma_image_bytes(d, hp)
    for name, t, dtype, n in (("image", pack.image, torch.bfloat16, want // 2),
                              ("vecs", pack.vecs, torch.float32, 9 * d + 2 * hp)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"pack {name} must be a contiguous {dtype} tensor of {n} on {x.device}")
    m, s, _ = x.shape
    out = torch.empty_like(x)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        rc = lib.hsimae_fused_block_wgmma(x.data_ptr(), out.data_ptr(), pack.image.data_ptr(),
                                          pack.vecs.data_ptr(), m, s, d, hp, num_heads, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused block wgmma kernel launch failed: cudaError_t {rc}")
    WGMMA_LAUNCHES += 1
    return out


def _launch_tf32x3(x: torch.Tensor, pack: Tf32Pack | Tf32D256Pack, num_heads: int) -> torch.Tensor:
    """A float32 3xTF32 tensor-core kernel: ``fused_block_tf32x3`` (D 64 and
    128) for a :class:`Tf32Pack`, ``fused_block_tf32x3_d256`` (D 256) for a
    :class:`Tf32D256Pack`."""
    global TF32X3_LAUNCHES, TF32X3_D256_LAUNCHES
    wide = isinstance(pack, Tf32D256Pack)
    name = "fused_block_tf32x3_d256" if wide else "fused_block_tf32x3"
    lib = _build.load_library(name)

    def fn(suffix=""):
        return getattr(lib, f"hsimae_{name}{suffix}")

    d = x.shape[-1]
    _check(x, pack.params, num_heads, fn("_max_seq")(d))
    hp = padded_hidden(pack.params.w1.shape[-1], TF32_HIDDEN_MULTIPLE)
    if hp > fn("_max_hidden")(d):
        raise ValueError(f"unsupported padded hidden width {hp} at D={d}")
    n = fn("_image_bytes")(d, hp) // 4
    for part, t, numel in (("hi", pack.hi, n), ("lo", pack.lo, n), ("vecs", pack.vecs, 9 * d + 2 * hp)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous() \
                or t.numel() != numel or t.data_ptr() % 16:
            raise ValueError(f"pack {part} must be a contiguous, 16-byte aligned float32 tensor "
                             f"of {numel} on {x.device}")
    m, s, _ = x.shape
    out = torch.empty_like(x)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        rc = fn()(x.data_ptr(), out.data_ptr(), pack.hi.data_ptr(), pack.lo.data_ptr(),
                  pack.vecs.data_ptr(), m, s, d, hp, num_heads, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused block {name} kernel launch failed: cudaError_t {rc}")
    if wide:
        TF32X3_D256_LAUNCHES += 1
    else:
        TF32X3_LAUNCHES += 1
    return out


# The route of each weight form: the kernel library it launches on a CUDA
# tensor, or the plain version for BlockParams (no kernel takes them there).
ROUTES = {BlockPack: "fused_block_wgmma", Tf32Pack: "fused_block_tf32x3",
          Tf32D256Pack: "fused_block_tf32x3_d256", BlockParams: "block_reference"}
_PACK_OF_ROUTE = {route: cls for cls, route in ROUTES.items()}


def pack_tensors(p: BlockParams | BlockPack | Tf32Pack | Tf32D256Pack) -> tuple:
    """``(route, tensors)``: the route of ``p``'s form and its tensors in one
    flat list, the 18 :class:`BlockParams` first (:func:`tensors_pack`
    inverts it)."""
    if isinstance(p, BlockParams):
        return ROUTES[BlockParams], list(p)
    return ROUTES[type(p)], [*p.params, *p[1:]]


def tensors_pack(route: str, tensors) -> BlockParams | BlockPack | Tf32Pack | Tf32D256Pack:
    """The weights :func:`pack_tensors` flattened, in their form again."""
    params = BlockParams(*tensors[:len(BlockParams._fields)])
    cls = _PACK_OF_ROUTE[route]
    return params if cls is BlockParams else cls(params, *tensors[len(BlockParams._fields):])


def fused_encoder_block(x: torch.Tensor, p: BlockParams | BlockPack | Tf32Pack | Tf32D256Pack,
                        num_heads: int) -> torch.Tensor:
    """Apply one transformer block to ``[M, S, D]`` sequences.

    On a CPU tensor this is :func:`block_reference`. On a CUDA tensor it
    launches, on the current stream (no synchronisation), the kernel of the
    route fixed by dtype and width, with the weights in the form
    :func:`kernel_weights` gives: float32 at D 64 and 128 the 3xTF32 wgmma
    kernel (a :class:`Tf32Pack`), float32 at D 256 the D 256 kernel (a
    :class:`Tf32D256Pack`), bfloat16 the wgmma kernel (a
    :class:`BlockPack`). Anything else raises."""
    params = p if isinstance(p, BlockParams) else p.params
    if x.device.type == "cpu":
        return block_reference(x, params, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_block runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused block kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dtype == torch.bfloat16:
        if not isinstance(p, BlockPack):
            raise TypeError("the bfloat16 kernel takes packed weights: pass pack_block(params)")
        return _launch_wgmma(x, p, num_heads)
    d = x.shape[-1] if x.dim() == 3 else None
    if d in TF32X3_D:
        if not isinstance(p, Tf32Pack):
            raise TypeError("the float32 kernel at D 64 and 128 takes packed weights: "
                            "pass pack_block_tf32(params)")
        return _launch_tf32x3(x, p, num_heads)
    if d == TF32X3_WIDE_D:
        if not isinstance(p, Tf32D256Pack):
            raise TypeError("the float32 kernel at D 256 takes packed weights: "
                            "pass pack_block_tf32_d256(params)")
        return _launch_tf32x3(x, p, num_heads)
    _check(x, params, num_heads, max_seq=0)  # raises: no float32 kernel takes this input
    raise ValueError(f"no float32 kernel takes x of shape {tuple(x.shape)}")


# The block as a registered operator, ``torch.ops.hsimae.fused_block``: a
# ``torch.export`` program (the serving artifact) cannot trace the ctypes
# launch, but it holds an op call, with the weights as the program's inputs.
@torch.library.custom_op("hsimae::fused_block", mutates_args=(), device_types="cuda")
def fused_block_op(x: torch.Tensor, weights: list[torch.Tensor], route: str,
                   num_heads: int) -> torch.Tensor:
    """:func:`fused_encoder_block` on the weights :func:`pack_tensors` gave
    as ``(route, weights)``. On a CUDA tensor: the route's kernel, with its
    checks and launch counter; on a CPU tensor: :func:`block_reference`."""
    return fused_encoder_block(x, tensors_pack(route, weights), num_heads)


@fused_block_op.register_kernel("cpu")
def _fused_block_op_cpu(x, weights, route, num_heads):
    return block_reference(x, BlockParams(*weights[:len(BlockParams._fields)]), num_heads)


@fused_block_op.register_fake
def _fused_block_op_fake(x, weights, route, num_heads):
    return torch.empty_like(x)

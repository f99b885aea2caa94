"""One fused pre-LN transformer block: CUDA kernel, wrapper and plain version.

Counterpart of ``hsimae_tpu/ops/fused_block.py``. The Pallas TPU kernel
(``_kernel``, math ``_block_math``) becomes the hand-written CUDA kernel
``csrc/fused_block.cu``, built by ``nvcc`` for sm_90a and bound with
``ctypes`` (:mod:`hsimae_tpu_torch.ops._build`). One launch covers all M
sequences; the JAX package's ``fused_block_sliced`` (a TPU compile
workaround) has no counterpart.

* :func:`block_reference` is the plain PyTorch version of the block math.
* :func:`fused_encoder_block` is the wrapper: on a CPU tensor it returns the
  plain version; on a CUDA tensor it launches the kernel or raises.
  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hsimae_tpu_torch.ops import _build

# Kernel launches since import (or since a caller last set it to 0).
LAUNCHES = 0

SUPPORTED_D = (64, 128, 256)
HEAD_DIM = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def params_from_block(block) -> BlockParams:
    """A :class:`hsimae_tpu_torch.models.layers.Block`'s weights in matmul
    layout (``Linear.weight [out, in]`` transposed to ``[in, out]``)."""
    a, m = block.attn, block.mlp

    def t(lin):
        return lin.weight.detach().t().contiguous()

    def b(lin):
        return lin.bias.detach()

    return BlockParams(
        ln1_scale=block.norm1.weight.detach(), ln1_bias=block.norm1.bias.detach(),
        wq=t(a.q), bq=b(a.q), wk=t(a.k), bk=b(a.k), wv=t(a.v), bv=b(a.v),
        wo=t(a.proj), bo=b(a.proj),
        ln2_scale=block.norm2.weight.detach(), ln2_bias=block.norm2.bias.detach(),
        w1=t(m.w1), b1=b(m.w1), w3=t(m.w3), b3=b(m.w3), w2=t(m.w2), b2=b(m.w2),
    )


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
    if x.dtype not in _DTYPE_CODE:
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


def _launch(x: torch.Tensor, p: BlockParams, num_heads: int) -> torch.Tensor:
    global LAUNCHES
    lib = _build.load_library("fused_block")
    _check(x, p, num_heads, lib.hsimae_fused_block_max_seq(x.shape[-1]))
    m, s, d = x.shape
    out = torch.empty_like(x)
    if m == 0:
        return out
    ptrs = (ctypes.c_void_p * len(p))(*(t.data_ptr() for t in p))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.hsimae_fused_block(_DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), ptrs,
                                    m, s, d, p.w1.shape[-1], num_heads, stream)
    if rc != 0:
        raise RuntimeError(f"fused block kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return out


def fused_encoder_block(x: torch.Tensor, p: BlockParams, num_heads: int) -> torch.Tensor:
    """Apply one transformer block to ``[M, S, D]`` sequences.

    On a CPU tensor this is :func:`block_reference`; on a CUDA tensor it
    launches the CUDA kernel on the current stream (no synchronisation) or
    raises."""
    if x.device.type == "cpu":
        return block_reference(x, p, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_block runs on cpu or cuda tensors, got {x.device}")
    return _launch(x, p, num_heads)

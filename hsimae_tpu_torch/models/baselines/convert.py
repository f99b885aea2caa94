"""The weight bridge from the JAX zoo to the port: flax variables -> the
port module's ``state_dict``.

Each model's mapping is the inverse of its converter in
``hsimae_tpu/models/baselines/convert.py`` (reference torch names -> flax),
rule for rule:

* Linear ``kernel [in, out]``       -> ``weight [out, in]``
* Conv ``kernel [*k, in, out]``     -> ``weight [out, in, *k]``
* BatchNorm params ``scale``/``bias`` and batch_stats ``mean``/``var``
  -> ``weight``/``bias``/``running_mean``/``running_var``
* LayerNorm / GroupNorm ``scale``   -> ``weight``

plus the per-model quirks: SSFTT's s-major -> c-major permutation of the
Conv2d's input channels, FDSSC's 3-D kernels back to Conv1d/Conv2d and its
scalar PReLU slope to ``[1]``, GSC-ViT's ChanLayerNorm ``[1, C, 1, 1]`` and
Conv1d-as-Dense, HiT's dynamic-conv bank transpose, DCTN's GroupNorm maps.
HiT's ``embed_proj`` (the JAX zoo's own layer, absent from the reference,
so its converter has no rule for it) maps as a Linear.

``from_jax_zoo(name, variables)`` takes a flax ``{"params",
"batch_stats"}`` tree of arrays (numpy or anything ``np.asarray`` reads);
the architecture arguments the JAX converters take (SSFTT's ``kernel_3d``,
HybridFormer's ``patch_sizes``, HiT's and DCTN's ``layers``,
``transitions``, ``embed_dims``) are read from the tree.
The result loads into the port module with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


class _Inverse:
    """Reads flat flax leaves and writes reference-named tensors."""

    def __init__(self, variables):
        self.params = _flatten(variables["params"])
        self.stats = _flatten(variables.get("batch_stats", {}))
        self.sd: Dict[str, np.ndarray] = {}

    def has(self, *fpath: str) -> bool:
        return any(k[:len(fpath)] == fpath for k in self.params)

    def p(self, *fpath: str) -> np.ndarray:
        return self.params[fpath]

    def linear(self, tname: str, *fpath: str):
        self.sd[f"{tname}.weight"] = self.p(*fpath, "kernel").T
        if (*fpath, "bias") in self.params:
            self.sd[f"{tname}.bias"] = self.p(*fpath, "bias")

    def conv(self, tname: str, *fpath: str, kernel: Optional[np.ndarray] = None):
        k = self.p(*fpath, "kernel") if kernel is None else kernel
        self.sd[f"{tname}.weight"] = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
        if (*fpath, "bias") in self.params:
            self.sd[f"{tname}.bias"] = self.p(*fpath, "bias")

    def bn(self, tname: str, *fpath: str):
        self.sd[f"{tname}.weight"] = self.p(*fpath, "scale")
        self.sd[f"{tname}.bias"] = self.p(*fpath, "bias")
        self.sd[f"{tname}.running_mean"] = self.stats[(*fpath, "mean")]
        self.sd[f"{tname}.running_var"] = self.stats[(*fpath, "var")]

    def ln(self, tname: str, *fpath: str):
        self.sd[f"{tname}.weight"] = self.p(*fpath, "scale")
        self.sd[f"{tname}.bias"] = self.p(*fpath, "bias")

    def raw(self, tname: str, *fpath: str):
        self.sd[tname] = self.p(*fpath)

    def count(self, pattern: str, *prefix: str) -> int:
        """How many distinct names under ``prefix`` match ``pattern``."""
        rx = re.compile(pattern)
        return len({k[len(prefix)] for k in self.params
                    if k[:len(prefix)] == prefix and rx.fullmatch(k[len(prefix)])})

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.array(v, order="C")) for k, v in self.sd.items()}


def _ssftt(t: _Inverse):
    t.conv("conv3d_features.0", "conv3d")
    t.bn("conv3d_features.1", "bn3d")
    k3d = t.p("conv3d", "kernel").shape[-1]
    w = t.p("conv2d", "kernel")  # [kh, kw, S*C s-major, out]
    kh, kw, cin, cout = w.shape
    w = w.reshape(kh, kw, cin // k3d, k3d, cout).transpose(0, 1, 3, 2, 4).reshape(w.shape)
    t.conv("conv2d_features.0", "conv2d", kernel=w)  # c-major, as the reference
    t.bn("conv2d_features.1", "bn2d")
    t.sd["token_wA"] = t.p("token_wA")[None]
    t.sd["token_wV"] = t.p("token_wV")[None]
    t.raw("cls_token", "cls_token")
    t.raw("pos_embedding", "pos_embedding")
    for i in range(t.count(r"norm1_\d+", "transformer")):
        p, f = f"transformer.layers.{i}", ("transformer",)
        t.ln(f"{p}.0.fn.norm", *f, f"norm1_{i}")
        t.linear(f"{p}.0.fn.fn.to_qkv", *f, f"attn_{i}", "qkv")
        t.linear(f"{p}.0.fn.fn.nn1", *f, f"attn_{i}", "proj")
        t.ln(f"{p}.1.fn.norm", *f, f"norm2_{i}")
        t.linear(f"{p}.1.fn.fn.net.0", *f, f"mlp_{i}", "Dense_0")
        t.linear(f"{p}.1.fn.fn.net.3", *f, f"mlp_{i}", "Dense_1")
    t.linear("nn1", "head")


def _spectralformer(t: _Inverse):
    t.conv("patch_to_embedding.embed", "gse")
    t.raw("cls_token", "cls_token")
    t.raw("pos_embedding", "pos_embedding")
    depth = t.count(r"norm1_\d+")
    for i in range(depth):
        p = f"transformer.layers.{i}"
        t.ln(f"{p}.0.fn.norm", f"norm1_{i}")
        t.linear(f"{p}.0.fn.fn.to_qkv", f"attn_{i}", "qkv")
        t.linear(f"{p}.0.fn.fn.to_out.0", f"attn_{i}", "proj")
        t.ln(f"{p}.1.fn.norm", f"norm2_{i}")
        t.linear(f"{p}.1.fn.fn.net.0", f"mlp_{i}", "Dense_0")
        t.linear(f"{p}.1.fn.fn.net.3", f"mlp_{i}", "Dense_1")
    for j in range(depth - 2):
        t.conv(f"transformer.skipcat.{j}", f"skipcat_{j}")
    t.ln("mlp_head.0", "head_norm")
    t.linear("mlp_head.1", "head")


def _ssrn(t: _Inverse):
    t.conv("conv1", "conv1")
    t.bn("batch_norm1.0", "bn1")
    for i in (1, 2, 3, 4):
        t.conv(f"res_net{i}.conv1.0", f"res{i}", "conv1")
        t.conv(f"res_net{i}.conv2", f"res{i}", "conv2")
        t.bn(f"res_net{i}.bn1", f"res{i}", "bn1")
        t.bn(f"res_net{i}.bn2", f"res{i}", "bn2")
    t.conv("conv2", "conv2")
    t.bn("batch_norm2.0", "bn2")
    t.conv("conv3", "conv3")
    t.bn("batch_norm3.0", "bn3")
    t.linear("full_connection.1", "fc")


def _dbda(t: _Inverse):
    for i in (11, 12, 13, 14, 15, 21, 22, 23, 24):
        t.conv(f"conv{i}", f"conv{i}")
    for i in (11, 12, 13, 14, 21, 22, 23):
        t.bn(f"batch_norm{i}.0", f"bn{i}")
    t.raw("attention_spectral.gamma", "cam", "gamma")
    t.raw("attention_spatial.gamma", "pam", "gamma")
    t.conv("attention_spatial.query_conv", "pam", "query")
    t.conv("attention_spatial.key_conv", "pam", "key")
    t.conv("attention_spatial.value_conv", "pam", "value")
    t.linear("full_connection.1", "fc")


def _fdssc(t: _Inverse):
    for i in (1, 2, 3, 4, 5):  # [1, 1, k, in, out] -> Conv1d [out, in, k]
        t.conv(f"conv{i}", f"conv{i}", kernel=t.p(f"conv{i}", "kernel")[0, 0])
    w = t.p("conv6", "kernel")  # [3, 3, 200, 1, 24] -> Conv2d [24, 200, 3, 3]
    t.conv("conv6", "conv6", kernel=w.reshape(w.shape[0], w.shape[1], w.shape[2], w.shape[4]))
    for i in (7, 8, 9):  # [3, 3, 1, in, out] -> Conv2d [out, in, 3, 3]
        t.conv(f"conv{i}", f"conv{i}", kernel=t.p(f"conv{i}", "kernel")[:, :, 0])
    for i in range(1, 10):
        t.bn(f"batch_norm{i}.0", f"bn{i}")
        t.sd[f"batch_norm{i}.1.weight"] = t.p(f"prelu{i}", "negative_slope").reshape(1)
    t.linear("full_connection.1", "fc")


def _hybridformer(t: _Inverse):
    for i, c in enumerate(("conv1", "conv2", "conv3", "out_conv"), start=1):
        t.conv(f"ournet.{c}.0", "ournet", c if c == "out_conv" else f"conv{i}")
        t.bn(f"ournet.{c}.1", "ournet", f"bn{i}")
    t.conv("conv4", "conv4")
    patch_sizes = sorted(int(k[0][4:]) for k in t.params if k[0].startswith("sub_")
                         and k[1:] == ("pos_embedding",))
    for i, ps in enumerate(patch_sizes):
        sub = f"sub_{ps}"
        t.conv(f"net.{i}.to_patch_embedding.0.depth_conv", sub, "patch_dw")
        t.raw(f"net.{i}.pos_embedding", sub, "pos_embedding")
        for j in range(t.count(r"norm1_\d+", sub)):
            p = f"net.{i}.transformer.layers.{j}"
            t.ln(f"{p}.0.norm", sub, f"norm1_{j}")
            a = (sub, f"attn_{j}")
            t.linear(f"{p}.0.fn.to_qkv", *a, "qkv")
            t.linear(f"{p}.0.fn.to_out.0", *a, "proj")
            t.conv(f"{p}.0.fn.spatial_conv", *a, "spatial_conv")
            t.conv(f"{p}.0.fn.spectral_conv", *a, "spectral_conv")
            t.linear(f"{p}.0.fn.to_qkv_spec", *a, "qkv_spec")
            t.ln(f"{p}.1.norm", sub, f"norm2_{j}")
            f = (sub, f"ffn_{j}")
            t.conv(f"{p}.1.fn.net.0.depth_conv", *f, "dw")
            t.conv(f"{p}.1.fn.net.0.point_conv", *f, "pw")
            t.bn(f"{p}.1.fn.net.1", *f, "bn")
            t.conv(f"{p}.1.fn.net.2", *f, "fc1")
            t.conv(f"{p}.1.fn.net.4", *f, "fc2")
        t.ln(f"mlp_head.{i}.0", f"head_norm_{ps}")
        t.linear(f"mlp_head.{i}.1", f"head_{ps}")


def _chan_ln(t: _Inverse, tname: str, *fpath: str):
    t.sd[f"{tname}.g"] = t.p(*fpath, "scale").reshape(1, -1, 1, 1)
    t.sd[f"{tname}.b"] = t.p(*fpath, "bias").reshape(1, -1, 1, 1)


def _dense_as_conv1d(t: _Inverse, tname: str, *fpath: str):
    t.sd[f"{tname}.weight"] = t.p(*fpath, "kernel").T[:, :, None]
    if (*fpath, "bias") in t.params:
        t.sd[f"{tname}.bias"] = t.p(*fpath, "bias")


def _gscvit(t: _Inverse):
    t.conv("sc.conv", "sc_conv")
    t.bn("sc.bn", "sc_bn")
    t.bn("bn_1", "bn_1")
    for i in range(t.count(r"gsc_\d+")):
        s = f"layers_trans.{i}"
        t.conv(f"{s}.0.gpwc", f"gsc_{i}", "gpwc")
        t.conv(f"{s}.0.gc", f"gsc_{i}", "gc")
        t.bn(f"{s}.0.bn", f"gsc_{i}", "bn")
        for j in range(t.count(rf"prenorm_{i}_\d+")):
            p = f"{s}.1.layers.{j}"
            _chan_ln(t, f"{p}.norm", f"prenorm_{i}_{j}")
            g = f"gssa_{i}_{j}"
            _dense_as_conv1d(t, f"{p}.fn.to_qkv", g, "to_qkv")
            t.raw(f"{p}.fn.group_tokens", g, "group_token")
            t.ln(f"{p}.fn.group_tokens_to_qk.0", g, "gt_norm")
            _dense_as_conv1d(t, f"{p}.fn.group_tokens_to_qk.3", g, "gt_qk")
            t.conv(f"{p}.fn.to_out.0", g, "to_out")
        if t.has(f"postnorm_{i}"):
            _chan_ln(t, f"{s}.1.norm", f"postnorm_{i}")
        t.bn(f"{s}.2", f"stage_bn_{i}")
        t.conv(f"{s}.4", f"pw_{i}")
    t.ln("mlp_head.1", "head_norm")
    t.linear("mlp_head.2", "head")


def _dynamic_conv3d(t: _Inverse, tname: str, fname: str):
    for fc in ("fc1", "fc2"):  # Dense [in, out] -> Conv3d 1x1x1 [out, in, 1, 1, 1]
        t.sd[f"{tname}.attention.{fc}.weight"] = t.p(fname, fc, "kernel").T[:, :, None, None, None]
    t.conv(f"{tname}.local.a", fname, "a")
    t.bn(f"{tname}.local.bn", fname, "bn")
    t.conv(f"{tname}.local.b", fname, "b")
    # [K, kd, kh, kw, in, out] -> [K, out, in, kd, kh, kw]
    t.sd[f"{tname}.weight"] = t.p(fname, "weight").transpose(0, 5, 4, 1, 2, 3)


def _stages(t: _Inverse):
    """``(ref network index, block name)`` of each block and
    ``(index, name)`` of each downsample, in the reference's order."""
    layers = [t.count(rf"block_{i}_\d+") for i in range(t.count(r"block_\d+_0"))]
    blocks, downs, n = [], [], 0
    for i, n_blocks in enumerate(layers):
        blocks += [(f"network.{n}.{j}", f"block_{i}_{j}") for j in range(n_blocks)]
        n += 1
        if i == len(layers) - 1:
            break
        if t.has(f"downsample_{i}"):
            downs.append((f"network.{n}", f"downsample_{i}"))
            n += 1
    return blocks, downs


def _hit(t: _Inverse):
    _dynamic_conv3d(t, "patch_embed.proj1_1", "proj1_1")
    _dynamic_conv3d(t, "patch_embed.proj2_1", "proj2_1")
    if t.has("embed_proj"):
        t.linear("embed_proj", "embed_proj")
    blocks, downs = _stages(t)
    for p, blk in blocks:
        t.ln(f"{p}.norm1", blk, "norm1")
        t.conv(f"{p}.attn.mlp_c.0", blk, "attn", "mlp_c")
        t.conv(f"{p}.attn.mlp_h.0", blk, "attn", "mlp_h")
        t.conv(f"{p}.attn.mlp_w", blk, "attn", "mlp_w")
        t.linear(f"{p}.attn.reweight.fc1", blk, "attn", "reweight", "Dense_0")
        t.linear(f"{p}.attn.reweight.fc2", blk, "attn", "reweight", "Dense_1")
        t.linear(f"{p}.attn.proj", blk, "attn", "proj")
        t.ln(f"{p}.norm2", blk, "norm2")
        t.linear(f"{p}.mlp.fc1", blk, "mlp", "Dense_0")
        t.linear(f"{p}.mlp.fc2", blk, "mlp", "Dense_1")
    for p, name in downs:
        t.conv(f"{p}.proj", name)
    t.ln("norm", "norm")
    t.linear("head", "head")


def _dctn(t: _Inverse):
    pe = "patch_embed"
    t.conv(f"{pe}.proj", pe, "proj")
    t.conv(f"{pe}.proj2", pe, "proj2")
    t.bn(f"{pe}.bn", pe, "bn")
    t.conv(f"{pe}.conv_1", pe, "conv_1")
    t.bn(f"{pe}.bn_1", pe, "bn_1")
    for m in ("conv1", "conv2", "conv3"):
        bn = m.replace("conv", "bn")
        t.conv(f"{pe}.add2D.{m}", pe, "add2d", m)
        t.bn(f"{pe}.add2D.{bn}", pe, "add2d", bn)
    t.conv(f"{pe}.down_sample", pe, "down_sample")
    t.raw(f"{pe}.weights", pe, "weights")
    blocks, downs = _stages(t)
    for p, blk in blocks:
        t.ln(f"{p}.norm1", blk, "norm1")
        a = (blk, "attn")
        for m in ("mlp_h", "mlp_w", "mlp_s", "convH", "convH2", "mix_hw", "mix_hw2",
                  "mix_hws", "mix_hws2", "mix_all"):
            t.conv(f"{p}.attn.{m}", *a, m)
        t.linear(f"{p}.attn.linearH", *a, "linearH")
        t.linear(f"{p}.attn.linearW", *a, "linearW")
        t.linear(f"{p}.attn.proj", *a, "proj")
        t.raw(f"{p}.attn.weights", *a, "weights")
        t.ln(f"{p}.norm2", blk, "norm2")
        t.conv(f"{p}.mlp.Conv1", blk, "mlp", "conv1")
        t.conv(f"{p}.mlp.proj1", blk, "mlp", "proj1")
        t.conv(f"{p}.mlp.Conv2", blk, "mlp", "conv2")
    for p, name in downs:
        t.conv(f"{p}.proj", name)
    for m in ("conv2", "conv2_2", "conv3", "conv3_2", "conv4", "conv4_2"):
        t.conv(m, m)
        t.bn(f"bn{m[4:]}", f"bn{m[4:]}")
    t.conv("down_sample.proj", "down_sample")
    t.conv("ConvEnd", "conv_end")
    t.ln("norm", "norm")
    t.linear("head", "head")


def _spectral_attention(t: _Inverse, tname: str, *fpath: str):
    t.linear(f"{tname}.SharedMLP.0", *fpath, "fc1")
    t.linear(f"{tname}.SharedMLP.2", *fpath, "fc2")


def _rssan(t: _Inverse):
    _spectral_attention(t, "attention1", "attn1")
    t.conv("attention2.conv1", "attn2", "conv")
    t.conv("conv1", "conv1")
    t.bn("bn1", "bn1")
    for name in ("ssa1", "ssa2"):
        t.conv(f"{name}.conv1", name, "conv1")
        t.bn(f"{name}.bn1", name, "bn1")
        t.bn(f"{name}.bn2", name, "bn2")
        _spectral_attention(t, f"{name}.spe_attention", name, "spe")
        t.conv(f"{name}.spa_attention.conv1", name, "spa", "conv")
    t.linear("full_connection.0", "fc")


RULES = {
    "SSRN": _ssrn, "FDSSC": _fdssc, "DBDA": _dbda, "RSSAN": _rssan, "SSFTT": _ssftt,
    "SpectralFormer": _spectralformer, "HybridFormer": _hybridformer, "GSC-ViT": _gscvit,
    "HiT": _hit, "DCTN": _dctn,
}


def from_jax_zoo(name: str, variables) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` of zoo net ``name`` (a registry name:
    ``GSC-ViT``, not ``GSCViT``) from its flax variables."""
    if name not in RULES:
        raise KeyError(f"unknown baseline {name!r}; known: {sorted(RULES)}")
    t = _Inverse(variables)
    RULES[name](t)
    return t.state_dict()

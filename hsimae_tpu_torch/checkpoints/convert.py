"""JAX parameter trees -> the port's ``state_dict``.

Port-owned copy of the mapping in
``hsimae_tpu/checkpoints/torch_convert.py::export_torch_state_dict``. It takes
the tree as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)`` on the JAX side), so the port never sees a JAX type:

* ``kernel [in, out]`` -> ``weight [out, in]`` (transpose);
* LayerNorm ``scale`` -> ``weight``;
* the patch-embed kernel ``[u*p*p, C]`` -> Conv3d ``weight [C, 1, u, p, p]``;
* list-module suffixes ``blocks_1_3`` -> ``blocks_1.3``;
* the frozen sincos table(s) the reference stores as parameters are added.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from hsimae_tpu_torch.config import ModelConfig
from hsimae_tpu_torch.models.pos_embed import sincos_3d


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def from_jax_params(params: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Nested-dict JAX params (numpy leaves) -> reference-named torch tensors."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params):
        parts = [re.sub(r"_(\d+)$", r".\1", p) for p in path]
        leafname = parts[-1]
        scope = ".".join(parts[:-1])
        if scope == "patch_embed.proj" and leafname == "kernel":
            c = arr.shape[-1]
            u, p = cfg.b_patch_size, cfg.patch_size
            out[f"{scope}.weight"] = arr.T.reshape(c, 1, u, p, p)
        elif leafname == "kernel":
            out[f"{scope}.weight"] = arr.T
        elif leafname == "scale":
            out[f"{scope}.weight"] = arr
        else:
            out[f"{scope}.{leafname}"] = arr
    out["pos_embed"] = sincos_3d(cfg.embed_dim, cfg.t_size, cfg.grid_size)[None]
    if any(k.startswith("decoder_") for k in out):
        out["decoder_pos_embed"] = sincos_3d(cfg.decoder_dim, cfg.t_size, cfg.grid_size)[None]
        out["mask_token"] = np.zeros((1, 1, cfg.decoder_dim), np.float32)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}

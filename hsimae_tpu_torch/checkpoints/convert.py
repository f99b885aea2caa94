"""Weight files of every source -> the port's ``state_dict``.

``from_jax_params`` is the port-owned copy of the mapping in
``hsimae_tpu/checkpoints/torch_convert.py::export_torch_state_dict``. It takes
the tree as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)`` on the JAX side, or :func:`msgpack_io.load_params` of a file) or
bfloat16 tensors, so the port never sees a JAX type:

* ``kernel [in, out]`` -> ``weight [out, in]`` (transpose);
* LayerNorm ``scale`` -> ``weight``;
* the patch-embed kernel ``[u*p*p, C]`` -> Conv3d ``weight [C, 1, u, p, p]``;
* list-module suffixes ``blocks_1_3`` -> ``blocks_1.3``;
* the frozen sincos table(s) the reference stores as parameters are added.

``load_torch_checkpoint`` reads a reference-style torch file, whose names
are already the port's; ``load_any_checkpoint`` picks the reader by suffix,
as ``hsimae_tpu/cli/common.py::load_any_checkpoint`` does.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from hsimae_tpu_torch.checkpoints.msgpack_io import load_params
from hsimae_tpu_torch.config import ModelConfig
from hsimae_tpu_torch.models.pos_embed import sincos_3d


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, torch.Tensor):  # a bfloat16 leaf of msgpack_io
        yield prefix, tree.float().numpy()
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


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` file (``.pkl``/``.pth``/``.pt``/``.bin``), read
    on the CPU with ``weights_only``. A file ``{"state_dict": sd, ...}`` or
    ``{"model": sd, ...}`` (the port's ``ckpt_{step}.pt`` train state) whose
    other values are not tensors is unwrapped to ``sd``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict) and all(
                not hasattr(v, "shape") for k, v in sd.items() if k != key):
            return sd[key]
    return sd


def load_any_checkpoint(path: Optional[str], cfg: ModelConfig
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """``path`` as a port ``state_dict``: a torch file by its suffix, any
    other file as the JAX package's msgpack parameters (mapped by
    :func:`from_jax_params` with ``cfg``; a train state ``{step, params,
    opt_state}`` of its ``save_checkpoint`` is unwrapped to ``params``, as
    the JAX fine-tune loop does). None for no path."""
    if not path:
        return None
    if path.endswith((".pkl", ".pth", ".pt", ".bin")):
        return load_torch_checkpoint(path)
    tree = load_params(path)
    if isinstance(tree.get("params"), dict):
        tree = tree["params"]
    return from_jax_params(tree, cfg)

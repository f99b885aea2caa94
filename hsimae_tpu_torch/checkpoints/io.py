"""Resumable training checkpoints and final parameters, with ``torch.save``.

Counterpart of ``save_checkpoint`` / ``latest_checkpoint`` /
``restore_checkpoint`` / ``save_params`` / ``partial_restore`` in
``hsimae_tpu/checkpoints/io.py``.
A checkpoint ``ckpt_{step}.pt`` holds the model's state dict, the optimizer's
state and the step; ``ckpt_{step}.pt.json`` beside it holds the step and any
metadata. Every file is written to a temporary name, then moved into place
(``os.replace``), so a run killed mid-save leaves the last checkpoint whole.
Files are read with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import torch


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(directory: str, step: int, model: torch.nn.Module, optimizer,
                    metadata: Optional[dict] = None) -> str:
    """Save model, optimizer state and ``step`` as ``ckpt_{step}.pt``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step}.pt")
    _atomic_save({"model": _cpu_state(model), "optimizer": optimizer.state_dict(),
                  "step": int(step)}, path)
    mtmp = path + ".json.tmp"
    with open(mtmp, "w") as f:
        json.dump({"step": int(step), **(metadata or {})}, f)
    os.replace(mtmp, path + ".json")
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint of the highest step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.pt", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(directory, name)
    return best


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer) -> int:
    """Load a checkpoint into ``model`` (strict) and ``optimizer``; returns
    its step."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["model"], strict=True)
    optimizer.load_state_dict(ck["optimizer"])
    return int(ck["step"])


def save_params(path: str, model: torch.nn.Module) -> str:
    """Save the model's state dict alone (the reference's final
    ``torch.save(state_dict)``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_save(_cpu_state(model), path)
    return path


def partial_restore(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                    verbose: bool = True) -> Tuple[List[str], List[str]]:
    """Key-and-shape-intersection restore: every tensor of ``state_dict``
    whose key the model has, with the same shape, is copied in (cast to the
    model's dtype); the rest is ignored, and what the source does not cover
    keeps its value (a pretrain checkpoint leaves ``cls_head`` at its init).
    Returns ``(loaded, skipped)``, both source keys. With ``verbose`` it
    prints the JAX package's line, counting parameters (the JAX tree's
    leaves; the sincos buffers are not among them)."""
    own = model.state_dict()
    loaded, skipped = [], []
    for k, v in state_dict.items():
        fits = k in own and tuple(v.shape) == tuple(own[k].shape)
        (loaded if fits else skipped).append(k)
    model.load_state_dict({k: state_dict[k] for k in loaded}, strict=False)
    if verbose:
        params = {k for k, _ in model.named_parameters()}
        print(f"[partial_restore] loaded {sum(k in params for k in loaded)} / target "
              f"{len(params)} leaves; ignored {len(skipped)} source leaves")
    return loaded, skipped

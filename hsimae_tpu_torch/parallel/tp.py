"""Tensor parallelism over the mesh's ``model`` axis.

Counterpart of ``hsimae_tpu/parallel/tp.py``, with its Megatron-style
rules, as a plan per parameter name (the reference ``state_dict`` names):

* column-parallel (output features split): attention ``q``, ``k``, ``v``
  and SwiGLU ``w1``, ``w3``, weight and bias;
* row-parallel (input features split): attention ``proj`` and SwiGLU
  ``w2``, weight only (the bias is added once, after the all-reduce);
* replicated: ``patch_embed`` (its ``proj`` is the tokenizer, not an
  attention projection), every other parameter, and any split that does
  not divide the ``model`` axis. In PyTorch a split stays whole per
  sub-layer: an attention is split only when its heads divide the axis, a
  SwiGLU only when its hidden width does.

:func:`shard_model_tp` applies the plan with ``parallelize_module``
(``ColwiseParallel`` / ``RowwiseParallel`` on ``mesh["model"]``), which
inserts the all-reduces. As in the JAX package, TP serves the train step:
the fused-block kernel refuses a sharded block.
"""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

_COLUMN = ("q", "k", "v", "w1", "w3")  # split output features
_ROW = ("proj", "w2")  # split input features


def tp_spec(name: str) -> Optional[str]:
    """``"column"``, ``"row"`` or None (replicated) for the parameter
    ``name`` (e.g. ``blocks_1.0.attn.q.weight``), before the divisibility
    rule."""
    parts = name.split(".")
    leaf = parts[-1]
    module = parts[-2] if len(parts) >= 2 else ""
    if "patch_embed" in parts:
        return None
    if module in _COLUMN and leaf in ("weight", "bias"):
        return "column"
    if module in _ROW and leaf == "weight":
        return "row"
    return None


def _splits(model: nn.Module, model_size: int) -> Dict[str, str]:
    """Sub-layer name -> ``"column"`` / ``"row"`` for every Linear that the
    rules split and whose sub-layer divides ``model_size``."""
    from hsimae_tpu_torch.models.layers import Attention, SwiGLU

    out: Dict[str, str] = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, Attention):
            ok = mod.num_heads % model_size == 0
        elif isinstance(mod, SwiGLU):
            ok = mod.w1.out_features % model_size == 0
        else:
            continue
        if not ok:
            continue
        for child, _ in mod.named_children():
            kind = tp_spec(f"{prefix}.{child}.weight")
            if kind is not None:
                out[f"{prefix}.{child}"] = kind
    return out


def tp_plan(model: nn.Module, model_size: int) -> Dict[str, Optional[str]]:
    """Parameter name -> ``"column"``, ``"row"`` or None (replicated) under
    a ``model`` axis of ``model_size``."""
    splits = _splits(model, model_size) if model_size > 1 else {}
    plan = {}
    for name, _ in model.named_parameters():
        kind = tp_spec(name)
        plan[name] = kind if kind is not None and name.rsplit(".", 1)[0] in splits else None
    return plan


def shard_model_tp(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model``'s attention and SwiGLU layers over ``mesh["model"]``
    by :func:`tp_plan` (in place; returns ``model``). Parameters stay on
    their device; the split ones become ``DTensor`` shards."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    tp_mesh = mesh["model"]
    splits = _splits(model, tp_mesh.size())
    if tp_mesh.size() == 1 or not splits:
        return model
    styles = {"column": ColwiseParallel, "row": RowwiseParallel}
    return parallelize_module(model, tp_mesh, {k: styles[v]() for k, v in splits.items()})

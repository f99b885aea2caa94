"""Shared CLI plumbing: scene loading (``.npy`` cubes, a named dataset or
synthetic, one labeled scene or a pretraining corpus) and model-preset
selection, with the flags and defaults of ``hsimae_tpu/cli/common.py``.
Weight files of every kind are read by
:func:`hsimae_tpu_torch.checkpoints.convert.load_any_checkpoint`.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from hsimae_tpu_torch.config import ModelConfig, PRESETS, preset


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="HSIMAE-B", choices=sorted(PRESETS),
                   help="size preset [depth, dim, s_depth] per the reference")
    p.add_argument("--img-size", type=int, default=9)
    p.add_argument("--bands", type=int, default=32)
    p.add_argument("--patch-size", type=int, default=3)
    p.add_argument("--b-patch-size", type=int, default=8)
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute dtype (params stay f32)")
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute transformer blocks in the backward pass "
                   "(same numerics, less activation memory; ModelConfig.remat)")


def model_config(args) -> ModelConfig:
    return preset(
        args.model,
        img_size=args.img_size,
        bands=args.bands,
        patch_size=args.patch_size,
        b_patch_size=args.b_patch_size,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        remat=getattr(args, "remat", False),
    )


def add_data_args(p: argparse.ArgumentParser, labeled: bool) -> None:
    p.add_argument("--scene", default=None, help=".npy [h, w, bands] cube")
    if labeled:
        p.add_argument("--gt", default=None, help=".npy [h, w] labels; 0=background")
    p.add_argument("--dataset", default=None,
                   help="named dataset (Salinas/PaviaU/Houston2013/LongKou) "
                        "under --data-root or $HSIMAE_DATA_ROOT")
    p.add_argument("--data-root", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use a generated scene (no dataset needed)")
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--synthetic-bands", type=int, default=103)
    p.add_argument("--synthetic-classes", type=int, default=6)
    p.add_argument("--synthetic-seed", type=int, default=None,
                   help="scene-generation seed; defaults to --seed")
    p.add_argument("--synthetic-texture", action="store_true",
                   help="textured scene family (make_textured_scene)")
    p.add_argument("--synthetic-cells-per-class", type=int, default=None,
                   help="textured scene: balanced Voronoi layout with this "
                        "many cells per class")
    p.add_argument("--no-gwpca", dest="gwpca", action="store_false", default=True)


def resolve_synthetic_seed(args) -> int:
    """--synthetic-seed when given, else --seed."""
    seed = getattr(args, "synthetic_seed", None)
    if seed is None:
        seed = getattr(args, "seed", 0)
    return seed


def load_labeled_scene(args) -> Tuple[np.ndarray, np.ndarray]:
    if args.synthetic:
        from hsimae_tpu_torch.data.synthetic import make_synthetic_scene, make_textured_scene

        textured = getattr(args, "synthetic_texture", False)
        gen = make_textured_scene if textured else make_synthetic_scene
        kw = {}
        cpc = getattr(args, "synthetic_cells_per_class", None)
        if textured and cpc is not None:
            kw["cells_per_class"] = cpc
        return gen(args.synthetic_size, args.synthetic_size, bands=args.synthetic_bands,
                   n_classes=args.synthetic_classes, seed=resolve_synthetic_seed(args), **kw)
    if getattr(args, "dataset", None):
        from hsimae_tpu_torch.data.datasets import load_dataset

        return load_dataset(args.dataset, getattr(args, "data_root", None))
    if not args.scene or not getattr(args, "gt", None):
        raise SystemExit("need --scene and --gt, --dataset, or --synthetic")
    return np.load(args.scene), np.load(args.gt)


def load_pretrain_scenes(args) -> List[np.ndarray]:
    """The pretraining corpus: ``--synthetic`` (``--synthetic-texture`` for
    the textured family) or ``--scenes *.npy``."""
    if args.synthetic:
        from hsimae_tpu_torch.data.synthetic import (
            make_synthetic_pretrain_scenes,
            make_textured_pretrain_scenes,
        )

        textured = getattr(args, "synthetic_texture", False)
        gen = make_textured_pretrain_scenes if textured else make_synthetic_pretrain_scenes
        kw = {}
        cpc = getattr(args, "synthetic_cells_per_class", None)
        if textured and cpc is not None:
            kw["cells_per_class"] = cpc
        return gen(n_scenes=args.synthetic_scenes,
                   size_range=(args.synthetic_size // 2, args.synthetic_size),
                   bands=args.synthetic_bands, seed=resolve_synthetic_seed(args), **kw)
    if not args.scenes:
        raise SystemExit("need --scenes *.npy, or --synthetic")
    return [np.load(p) for p in args.scenes]

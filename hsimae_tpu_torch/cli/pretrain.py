"""MAE pretraining CLI: the flags and defaults of ``hsimae_tpu.cli.pretrain``
on one CUDA card (or the CPU with ``--device cpu``).

    python -m hsimae_tpu_torch.cli.pretrain --synthetic --epochs 2 \\
        --batch-size 64 --model HSIMAE-S --workdir runs/pt [--device cuda]

Writes a checkpoint every ``--checkpoint-every`` steps (at epoch ends),
``params_final.pt`` (a state dict with the reference's names) and
``train_log.npy`` into ``--workdir``, and resumes from its latest
checkpoint unless ``--no-resume``. ``--ckpt-backend msgpack`` (the default)
writes ``ckpt_{step}.pt`` on the training thread and keeps all;
``--ckpt-backend orbax`` (the JAX package's name; no orbax is used) writes
``<step>/state.pt`` on a background thread and keeps the newest
``--ckpt-max-keep``. ``--profile DIR`` writes a ``torch.profiler`` trace of
the second epoch. bf16 compute by default (``--no-bf16`` for f32).
``--fused-steps K`` trains K steps a dispatch: on a card each chunk of K
steps is one CUDA graph replay (captured once per kept-grid shape), on the
CPU the same steps run in a loop; the epoch is padded to whole chunks.

Data-parallel over N ranks (each rank trains its rows of every global
batch of ``--batch-size``; rank 0 logs and writes the workdir):
    python -m torch.distributed.run --nproc-per-node N \
        -m hsimae_tpu_torch.cli.pretrain --synthetic ... --workdir runs/pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hsimae_tpu_torch.cli.common import (
    add_model_args,
    join_launched_ranks,
    load_pretrain_scenes,
    model_config,
)
from hsimae_tpu_torch.config import PretrainConfig
from hsimae_tpu_torch.data.gwpca import apply_gwpca
from hsimae_tpu_torch.data.pipeline import MultiScenePatchSource
from hsimae_tpu_torch.data.windows import build_pretrain_cut_index
from hsimae_tpu_torch.parallel.mesh import is_main_process, shutdown_distributed
from hsimae_tpu_torch.train.pretrain import run_pretraining


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--scenes", nargs="*", default=None, help=".npy cubes")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-scenes", type=int, default=3)
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--synthetic-bands", type=int, default=103)
    p.add_argument("--synthetic-texture", action="store_true",
                   help="textured corpus (make_textured_pretrain_scenes)")
    p.add_argument("--synthetic-seed", type=int, default=None,
                   help="scene-generation seed; defaults to --seed")
    p.add_argument("--no-gwpca", dest="gwpca", action="store_false", default=True)
    p.add_argument("--scene-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="resident scene-buffer dtype (patches train in f32/compute dtype)")
    p.add_argument("--mask-ratio", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--wd", type=float, default=5e-2)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ratio", type=float, default=1.0,
                   help="subsample ratio for dense-cut scenes")
    p.add_argument("--coarse-from", type=int, default=14,
                   help="scene id from which cuts are non-overlapping")
    p.add_argument("--workdir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1000, dest="ckpt_every",
                   help="save a resumable checkpoint every N steps (0 = final only)")
    p.add_argument("--no-resume", dest="resume", action="store_false", default=True)
    p.add_argument("--ckpt-backend", choices=["msgpack", "orbax"], default="msgpack",
                   help="orbax = background saves + managed retention "
                        "(checkpoints/async_io.py; no orbax used); msgpack = one synchronous "
                        "self-contained file per checkpoint")
    p.add_argument("--ckpt-max-keep", type=int, default=3,
                   help="orbax backend: checkpoints retained on disk (0 = keep all); ignored "
                        "by msgpack, which keeps all")
    p.add_argument("--adam-mu-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="storage dtype of Adam's first moment")
    p.add_argument("--fused-steps", type=int, default=0,
                   help="train steps a dispatch, as one CUDA graph on a card (0 = eager steps)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one steady epoch")
    return p


def prepare(args):
    """(source, cut index, ModelConfig, PretrainConfig) as ``main`` uses them."""
    scenes = load_pretrain_scenes(args)
    if args.gwpca:
        scenes = [apply_gwpca(s, nc=args.bands) for s in scenes]
    source = MultiScenePatchSource(scenes, patch_size=args.img_size,
                                   storage_dtype=getattr(torch, args.scene_dtype),
                                   device=args.device)
    index = build_pretrain_cut_index([s.shape for s in scenes], args.img_size, ratio=args.ratio,
                                     coarse_from=args.coarse_from,
                                     rng=np.random.default_rng(args.seed))
    cfg = PretrainConfig(
        mask_ratio=args.mask_ratio, lr=args.lr, weight_decay=args.wd,
        batch_size=args.batch_size, epochs=args.epochs, seed=args.seed,
        checkpoint_every_steps=args.ckpt_every, fused_steps=args.fused_steps,
        checkpoint_backend=args.ckpt_backend,
        ckpt_max_to_keep=args.ckpt_max_keep or None,
        adam_mu_dtype=None if args.adam_mu_dtype == "float32" else args.adam_mu_dtype)
    return source, index, model_config(args), cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    joined = join_launched_ranks(args)
    try:
        source, index, mcfg, cfg = prepare(args)
        main_rank = is_main_process()
        if main_rank:
            print(f"[pretrain] {len(index.scene_max)} scenes, {len(index)} patches")
        model, hist = run_pretraining(source, index.locs, mcfg, cfg, workdir=args.workdir,
                                      resume=args.resume, device=args.device,
                                      profile_dir=args.profile)
        if hist["epoch_loss"] and main_rank:
            print(f"[pretrain] done; final epoch loss {hist['epoch_loss'][-1]:.4f}")
    finally:
        if joined:
            shutdown_distributed()
    return model, hist


if __name__ == "__main__":
    main()

"""Dual-branch fine-tuning CLI, the counterpart of ``hsimae_tpu.cli.finetune``
on one CUDA card (or the CPU with ``--device cpu``).

Single run:
    python -m hsimae_tpu_torch.cli.finetune --synthetic --samples-per-class 10 \\
        --epochs 20 --model HSIMAE-S --pretrained runs/pt/params_final.pt \\
        --eval --workdir runs/ft [--device cuda]

The multi-seed protocol (lr grid on 3 selection seeds, then 5 test seeds):
    python -m hsimae_tpu_torch.cli.finetune --synthetic --protocol \\
        --pretrained runs/pt/params_final.pt --workdir runs/protocol

``--pretrained`` takes a torch state dict (the pretrain CLI's
``params_final.pt``, a reference ``.pkl``) or the JAX package's
``.msgpack``; without it the model starts from a seeded init. bf16 compute
by default (``--no-bf16`` for f32). ``--eval`` classifies the whole scene
with the fine-tuned weights and scores the pixels not used in training.
``--workdir`` receives ``finetuned.pt``, ``train_log.npy``,
``finetune_curves.png``, the metric stream and (with ``--eval``) the
colormaps; under ``--protocol`` it holds
``protocol_runs.jsonl``, from which a restarted protocol resumes.

Under ``python -m torch.distributed.run --nproc-per-node N -m
hsimae_tpu_torch.cli.finetune ...`` every fine-tune (and ``--eval``, and
the protocol's runs) runs data-parallel over the N ranks; rank 0 prints and
writes the workdir.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from hsimae_tpu_torch.checkpoints.convert import load_any_checkpoint
from hsimae_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    join_launched_ranks,
    load_labeled_scene,
    model_config,
)
from hsimae_tpu_torch.config import EvalConfig, FinetuneConfig, ProtocolConfig
from hsimae_tpu_torch.data.sampling import dual_scene_split
from hsimae_tpu_torch.parallel.mesh import is_main_process, shutdown_distributed
from hsimae_tpu_torch.train.evaluate import evaluate_scene
from hsimae_tpu_torch.train.finetune import dual_branch_finetune
from hsimae_tpu_torch.train.protocol import run_protocol
from hsimae_tpu_torch.utils.seed import seed_everything


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    add_data_args(p, labeled=True)
    p.add_argument("--pretrained", default=None,
                   help="pretrained weights: .msgpack, or a torch .pt/.pkl state dict")
    p.add_argument("--samples-per-class", type=int, default=10)
    p.add_argument("--mask-ratio", type=float, default=0.8)
    p.add_argument("--lamda", type=float, default=10.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=5e-3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--drop-path", type=float, default=0.2)
    p.add_argument("--encoder-lr-scale", type=float, default=1.0,
                   help="lr multiplier for non-head params; 1.0 = reference "
                        "recipe, 0.0 = frozen encoder (linear-probe head)")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--eval", action="store_true", help="full-scene test after training")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--protocol", action="store_true",
                   help="run the full lr-grid x multi-seed protocol")
    p.add_argument("--lr-grid", nargs="+", type=float, default=list(ProtocolConfig().lr_grid))
    p.add_argument("--selection-seeds", type=int, default=ProtocolConfig().selection_seeds)
    p.add_argument("--test-seeds", type=int, default=ProtocolConfig().test_seeds)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def main(argv=None):
    """Returns ``(FinetuneResult, SceneEvalResult or None)``, or the
    ``ProtocolResult`` under ``--protocol``."""
    args = build_parser().parse_args(argv)
    joined = join_launched_ranks(args)
    try:
        return _run(args)
    finally:
        if joined:
            shutdown_distributed()


def _run(args):
    seed_everything(args.seed)
    main_rank = is_main_process()
    scene, gt = load_labeled_scene(args)
    mcfg = model_config(args)
    ft = FinetuneConfig(
        mask_ratio=args.mask_ratio, lamda=args.lamda, lr=args.lr,
        weight_decay=args.wd, batch_size=args.batch_size, epochs=args.epochs,
        drop_path=args.drop_path, seed=args.seed,
        encoder_lr_scale=args.encoder_lr_scale,
    )
    pretrained = load_any_checkpoint(args.pretrained, mcfg)

    if args.protocol:
        proto = ProtocolConfig(lr_grid=tuple(args.lr_grid), selection_seeds=args.selection_seeds,
                               test_seeds=args.test_seeds)
        res = run_protocol(scene, gt, mcfg, ft, proto, EvalConfig(),
                           samples_per_class=args.samples_per_class, pretrained=pretrained,
                           gwpca=args.gwpca, resume_dir=args.workdir, device=args.device,
                           verbose=main_rank)
        if main_rank:
            print(json.dumps({
                "best_lr": res.best_lr,
                "oa": f"{100 * res.oa_mean:.2f}±{100 * res.oa_std:.2f}",
                "aa": f"{100 * res.aa_mean:.2f}±{100 * res.aa_std:.2f}",
                "kappa": f"{100 * res.kappa_mean:.2f}±{100 * res.kappa_std:.2f}",
                "per_class": [round(100 * float(x), 2) for x in res.per_class_mean],
            }))
        return res

    split = dual_scene_split(scene, gt, patch_size=mcfg.img_size, num=args.samples_per_class,
                             gwpca=args.gwpca, nc=mcfg.bands,
                             rng=np.random.default_rng(args.seed))
    res = dual_branch_finetune(split, mcfg, ft, pretrained=pretrained, workdir=args.workdir,
                               eval_every=args.eval_every, device=args.device)
    if main_rank:
        print(f"[finetune] val: {res.val_metrics}")
    ev = None
    if args.eval:
        ev = evaluate_scene(split.scene, split.test_gt, res.params, res.model_cfg,
                            res.num_classes, EvalConfig(), device=args.device,
                            save_dir=args.workdir)
        m = ev.metrics
        if main_rank:
            print(json.dumps({"test_oa": round(100 * m.oa, 2),
                              "test_aa": round(100 * m.aa, 2),
                              "test_kappa": round(100 * m.kappa, 2),
                              "per_class": [round(100 * float(x), 2) for x in m.per_class]}))
    return res, ev


if __name__ == "__main__":
    main()

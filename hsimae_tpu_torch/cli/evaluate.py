"""Full-scene inference CLI: classify every pixel of a scene with an
encoder-only HSIMAE and report OA/AA/kappa/per-class as one JSON line.

    python -m hsimae_tpu_torch.cli.evaluate --synthetic --num-classes 7 \\
        [--params finetuned.pt] [--device cuda] [--batch-size 4096]

``--params`` takes a torch ``state_dict`` with the reference's names;
without it the model keeps a seeded random init (``--seed``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from hsimae_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    load_labeled_scene,
    load_state_dict,
    model_config,
)
from hsimae_tpu_torch.config import EvalConfig
from hsimae_tpu_torch.data.gwpca import apply_gwpca
from hsimae_tpu_torch.train.evaluate import evaluate_scene


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    add_data_args(p, labeled=True)
    p.add_argument("--params", default=None, help="torch state_dict (.pt)")
    p.add_argument("--num-classes", type=int, required=True,
                   help="including background class 0")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-gt", default=None,
                   help=".npy test gt (train pixels already zeroed)")
    return p


def prepare(args):
    """(scene [h, w, bands] f32, gt, ModelConfig) as ``main`` uses them."""
    scene, gt = load_labeled_scene(args)
    mcfg = model_config(args)
    if args.gwpca:
        scene = apply_gwpca(scene, nc=mcfg.bands)
    if args.test_gt:
        gt = np.load(args.test_gt)
    return scene.astype(np.float32), gt, mcfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    scene, gt, mcfg = prepare(args)
    res = evaluate_scene(scene, gt, load_state_dict(args.params), mcfg, args.num_classes,
                         EvalConfig(batch_size=args.batch_size), device=args.device,
                         seed=args.seed)
    m = res.metrics
    print(json.dumps({
        "oa": round(100 * m.oa, 2), "aa": round(100 * m.aa, 2),
        "kappa": round(100 * m.kappa, 2),
        "per_class": [round(100 * float(x), 2) for x in m.per_class],
    }))
    return res


if __name__ == "__main__":
    main()

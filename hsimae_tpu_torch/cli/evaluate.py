"""Full-scene inference CLI: classify every pixel of a scene with an
encoder-only HSIMAE, report OA/AA/kappa/per-class as one JSON line, and
save the prediction colormaps.

    python -m hsimae_tpu_torch.cli.evaluate --synthetic --num-classes 7 \\
        [--params finetuned.pt | --artifact model.pt2] \\
        [--samples-per-class 10 --seed 3407] \\
        [--out runs/eval] [--device cuda] [--batch-size 4096]

``--params`` takes a torch state dict with the reference's names (``.pt``,
``.pkl``, ``.pth``, ``.bin``) or the JAX package's ``.msgpack``; without it
(and without ``--artifact``) the model keeps a seeded random init
(``--seed``). ``--artifact`` classifies through a serving artifact of
``hsimae_tpu_torch.cli.export`` instead, on ``--device``, and reads the
class count from it; it excludes ``--params``. ``--samples-per-class``
draws the fine-tune's few-shot split again (the generator of ``--seed``) and
scores only the pixels it left out. ``--out`` receives ``scene_pred.png``
and ``scene_pred_masked.png``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from hsimae_tpu_torch.checkpoints.convert import load_any_checkpoint
from hsimae_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    load_labeled_scene,
    model_config,
)
from hsimae_tpu_torch.config import EvalConfig
from hsimae_tpu_torch.data.gwpca import apply_gwpca
from hsimae_tpu_torch.data.sampling import sample_per_class
from hsimae_tpu_torch.train.evaluate import evaluate_scene, evaluate_scene_artifact


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    add_data_args(p, labeled=True)
    p.add_argument("--params", default=None, help=".msgpack, or a torch .pt/.pkl state dict")
    p.add_argument("--artifact", default=None,
                   help="serving artifact (hsimae_tpu_torch.cli.export) to evaluate instead "
                        "of --params: full-scene eval without model source")
    p.add_argument("--num-classes", type=int, default=None,
                   help="including background class 0 (required without --artifact; read "
                        "from the artifact otherwise)")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--out", default=None, help="dir for colormap PNGs")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples-per-class", type=int, default=None,
                   help="draw the training split again (same seed) and zero its "
                        "pixels from the gt, so the metrics are test metrics")
    p.add_argument("--test-gt", default=None,
                   help=".npy test gt (train pixels already zeroed)")
    return p


def prepare(args):
    """(scene [h, w, bands] f32, the gt to score, ModelConfig) as ``main``
    uses them."""
    scene, gt = load_labeled_scene(args)
    mcfg = model_config(args)
    if args.gwpca:
        scene = apply_gwpca(scene, nc=mcfg.bands)
    if args.test_gt:
        gt = np.load(args.test_gt)
    elif args.samples_per_class:
        _, test_gt_flat = sample_per_class(gt.reshape(-1), num=args.samples_per_class,
                                           rng=np.random.default_rng(args.seed))
        gt = test_gt_flat.reshape(gt.shape)
    return scene.astype(np.float32), gt, mcfg


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.params and args.artifact:
        parser.error("--params and --artifact exclude each other")
    if not args.artifact and args.num_classes is None:
        parser.error("--num-classes is required without --artifact")
    scene, gt, mcfg = prepare(args)
    ecfg = EvalConfig(batch_size=args.batch_size)
    if args.artifact:
        from hsimae_tpu_torch.serving import load_classifier

        res = evaluate_scene_artifact(scene, gt, load_classifier(args.artifact, args.device),
                                      ecfg, save_dir=args.out, name="scene")
    else:
        res = evaluate_scene(scene, gt, load_any_checkpoint(args.params, mcfg), mcfg,
                             args.num_classes, ecfg, device=args.device, seed=args.seed,
                             save_dir=args.out, name="scene")
    m = res.metrics
    print(json.dumps({
        "oa": round(100 * m.oa, 2), "aa": round(100 * m.aa, 2),
        "kappa": round(100 * m.kappa, 2),
        "per_class": [round(100 * float(x), 2) for x in m.per_class],
    }))
    return res


if __name__ == "__main__":
    main()

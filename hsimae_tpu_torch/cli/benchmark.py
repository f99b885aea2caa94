"""Baseline benchmark CLI, the reference harness's ``__main__``: for each
model and label budget, select the lr on a seed grid by val
(OA+AA+kappa)/3, then run the test seeds of train + full-scene eval and
report mean±std and each seed's OA as one JSON object.

    python -m hsimae_tpu_torch.cli.benchmark --synthetic --models SSFTT SSRN \\
        --samples-per-class 10 --selection-seeds 1 --test-seeds 2 --epochs 20 \\
        [--device cuda]

Counterpart of ``hsimae_tpu/cli/benchmark.py``: its flags, defaults and
report keys, plus ``--device`` (``cuda`` by default; ``cpu`` on request).
``--models`` offers the ten nets and ``SVM-RBF`` (:func:`run_svm`; its
``best_lr`` is null).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from hsimae_tpu_torch.bench.harness import evaluate_baseline, train_baseline
from hsimae_tpu_torch.bench.registry import ALL_BASELINES, get_baseline_spec
from hsimae_tpu_torch.utils.seed import seed_everything


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+", default=["SSFTT"],
                   choices=ALL_BASELINES + ["SVM-RBF"])
    p.add_argument("--dataset", default="synthetic",
                   help="dataset name for per-dataset hyperparams")
    p.add_argument("--scene", default=None)
    p.add_argument("--gt", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=int, default=48)
    p.add_argument("--synthetic-bands", type=int, default=103)
    p.add_argument("--synthetic-classes", type=int, default=6)
    p.add_argument("--synthetic-texture", action="store_true",
                   help="textured scene (make_textured_scene): class = joint "
                        "spatial-spectral structure; pixel classifiers are "
                        "at chance")
    p.add_argument("--synthetic-cells-per-class", type=int, default=None,
                   help="textured-scene region granularity")
    p.add_argument("--samples-per-class", type=int, default=10)
    # the baseline harness's grid, one decade lower than HSIMAE fine-tuning's
    p.add_argument("--lr-grid", nargs="+", type=float,
                   default=[1e-3, 5e-4, 1e-4, 5e-5])
    p.add_argument("--selection-seeds", type=int, default=3)
    p.add_argument("--test-seeds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=None,
                   help="override the per-model epoch count (for smoke runs)")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--scene-seed", type=int, default=None,
                   help="synthetic-scene seed (default: --seed)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def _load(args):
    if args.synthetic:
        from hsimae_tpu_torch.data.synthetic import make_synthetic_scene, make_textured_scene

        gen = make_textured_scene if args.synthetic_texture else make_synthetic_scene
        kw = {}
        if args.synthetic_texture and args.synthetic_cells_per_class:
            kw["cells_per_class"] = args.synthetic_cells_per_class
        return gen(args.synthetic_size, args.synthetic_size,
                   bands=args.synthetic_bands, n_classes=args.synthetic_classes,
                   seed=args.scene_seed if args.scene_seed is not None else args.seed, **kw)
    if not args.scene or not args.gt:
        raise SystemExit("need --scene/--gt or --synthetic")
    return np.load(args.scene), np.load(args.gt)


def run_svm(scene, gt, args):
    """SVM-RBF on 1x1-pixel spectra, one run a test seed: the scene min-max
    normalised in float64, ``samples_per_class`` training pixels drawn from
    ``default_rng(seed)``, whose next draws split them in both grid stages;
    the scene predicted from its float32 rounding. -> one ``Metrics`` a seed."""
    from hsimae_tpu_torch.data.sampling import sample_per_class
    from hsimae_tpu_torch.models.baselines.svm_rbf import SVMRBF

    seeds = [args.seed + i for i in range(args.test_seeds)]
    ms = []
    sc = np.asarray(scene, np.float64)
    sc = (sc - sc.min()) / (sc.max() - sc.min())
    for seed in seeds:
        rng = np.random.default_rng(seed)
        tr_idx, test_gt = sample_per_class(gt.reshape(-1), num=args.samples_per_class, rng=rng)
        x = sc.reshape(-1, sc.shape[-1])[tr_idx]
        y = gt.reshape(-1)[tr_idx]
        svm = SVMRBF(seed, device=args.device).train(x, y, rng=rng)
        m, _ = svm.test(sc.astype(np.float32), test_gt.reshape(gt.shape))
        ms.append(m)
        print(f"[SVM-RBF] seed {seed}: {m} C={svm.best_c:g} gamma={svm.best_gamma:g}",
              flush=True)
    return ms


def main(argv=None):
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    scene, gt = _load(args)
    n_classes = int(gt.max()) + 1
    report = {}

    for name in args.models:
        if name == "SVM-RBF":
            ms = run_svm(scene, gt, args)
            best_lr = None
        else:
            spec = get_baseline_spec(name, args.dataset)
            if args.epochs:
                spec = dataclasses.replace(spec, epochs=args.epochs)

            scores = {}
            for lr in args.lr_grid:
                vals = []
                for s in range(args.selection_seeds):
                    run, _, _ = train_baseline(scene, gt, spec, lr=lr,
                                               samples_per_class=args.samples_per_class,
                                               seed=args.seed + s, device=args.device)
                    vals.append(run.val_metrics.mean3)
                scores[lr] = float(np.mean(vals))
                print(f"[{name}] lr={lr:g} selection {scores[lr]:.4f}", flush=True)
            best_lr = max(scores, key=scores.get)

            ms = []
            for s in range(args.test_seeds):
                run, test_gt, scene_p = train_baseline(
                    scene, gt, spec, lr=best_lr, samples_per_class=args.samples_per_class,
                    seed=args.seed + s, device=args.device)
                m = evaluate_baseline(run, scene_p, test_gt, spec, n_classes,
                                      device=args.device)
                ms.append(m)
                print(f"[{name}] seed {args.seed + s}: {m}", flush=True)

        oas = np.array([m.oa for m in ms])
        aas = np.array([m.aa for m in ms])
        kps = np.array([m.kappa for m in ms])
        report[name] = {
            "best_lr": best_lr,
            "oa": f"{100*oas.mean():.2f}±{100*oas.std():.2f}",
            "aa": f"{100*aas.mean():.2f}±{100*aas.std():.2f}",
            "kappa": f"{100*kps.mean():.2f}±{100*kps.std():.2f}",
            # per-seed values: paired per-seed comparisons need the raw draws
            "per_seed_oa": [round(100 * float(x), 2) for x in oas],
        }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()

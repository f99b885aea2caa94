#!/usr/bin/env python3
"""Train-step ms and full-scene pixels/s of the baseline zoo's nets, on one card.

    python3 scripts/time_zoo_runs.py [--models SSRN HiT ...]

On ``chip_smoke.py``'s phase-4 scene (145x145x200, 16 classes; its
``ZOO_ARGV``: 10 samples a class, lr 1e-3, seed as ``cli.benchmark``'s),
each net's registry spec (PaviaU's widths) is trained once through
``harness.train_baseline`` for ``ZOO_ARGV``'s epochs (2 steps an epoch at 10
samples a class; epoch 0 warms up and is not timed) and evaluated once
through ``harness.evaluate_baseline``, host clock with a synchronise around
it. Every logit of the scene is checked finite. One JSON line a net, then
one JSON object as the last line; exits 1 if a logit is not finite. Needs a
CUDA card. ``chip_smoke.py`` phase 16c runs the same nets through
``cli.benchmark`` and checks their scene logits there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the smoke run's argument lists)


def main() -> int:
    import torch
    from hsimae_tpu_torch.bench import harness, registry
    from hsimae_tpu_torch.cli import benchmark as bench_cli
    from hsimae_tpu_torch.data.pipeline import ScenePatchSource, batch_indices
    from hsimae_tpu_torch.data.synthetic import make_synthetic_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=registry.ALL_BASELINES)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_zoo_runs: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    args = bench_cli.build_parser().parse_args(chip_smoke.ZOO_ARGV)
    scene, gt = make_synthetic_scene(args.synthetic_size, args.synthetic_size,
                                     bands=args.synthetic_bands,
                                     n_classes=args.synthetic_classes, seed=args.scene_seed)
    n_classes = int(gt.max()) + 1
    rows, ok = {}, True
    for name in opts.models:
        spec = dataclasses.replace(registry.get_baseline_spec(name, args.dataset),
                                   epochs=args.epochs)
        run, test_gt, scene_p = harness.train_baseline(
            scene, gt, spec, lr=args.lr_grid[0], samples_per_class=args.samples_per_class,
            seed=args.seed, device=dev)
        h = run.history  # epoch 0 warms up
        step_ms = 1e3 * sum(h["train_seconds"][1:]) / sum(h["train_steps"][1:])
        torch.cuda.synchronize()
        t = time.perf_counter()
        harness.evaluate_baseline(run, scene_p, test_gt, spec, n_classes, device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        model = harness.build_model(spec, scene_p.shape[-1], n_classes, run.state, device=dev)
        source = ScenePatchSource(scene_p, spec.patch_size, device=dev)
        finite = bool(torch.stack([torch.isfinite(harness.eval_logits(
            model, source.gather_pixels(chunk))).all() for chunk, _ in batch_indices(
                test_gt.size, 2048, shuffle=False)]).all())
        ok = ok and finite
        rows[name] = {"model": name, "train_step_ms": step_ms,
                      "train_steps_timed": sum(h["train_steps"][1:]),
                      "scene_pixels_per_s": test_gt.size / eval_s, "scene_eval_s": eval_s,
                      "logits_finite": finite, "card": smi}
        print(json.dumps(rows[name]), flush=True)
        del model, source
        torch.cuda.empty_cache()
    print(json.dumps({"epochs": args.epochs, "ok": ok, "card": smi,
                      "train_step_ms": {k: v["train_step_ms"] for k, v in rows.items()},
                      "scene_pixels_per_s": {k: v["scene_pixels_per_s"]
                                             for k, v in rows.items()}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

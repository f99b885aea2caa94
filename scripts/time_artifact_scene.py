#!/usr/bin/env python3
"""Warm full-scene pixels/s through a serving artifact against the live model, on one card.

    python3 scripts/time_artifact_scene.py [--params FILE]

Exports HSIMAE-B weights (``--params``, or a seeded random init of the
classifier, 17 classes) through ``hsimae_tpu_torch.cli.export`` in each of
``chip_smoke.py``'s four serving variants (float32; bf16 weights and
compute; weight-only int8; int8 with bf16 compute; buckets 1, 64, 1024),
loads each artifact and builds the live classifier on the weights it serves
(``clf.weights()``), then classifies ``chip_smoke.py``'s phase-4 scene
(145x145x200, GWPCA to 32 bands) in turns, the artifact
(``classify_scene_artifact``) and the live model (``predict_scene``), four
turns of both at batch 4096, the first warming up: the median of the other
three, host clock with a synchronise around each. One JSON line a variant,
then one JSON object as the last line. Needs a CUDA card. ``chip_smoke.py``
phase 14 holds the same artifacts' launches, logits and maps.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the smoke run's argument lists)

TURNS = 4  # of artifact and live, in turns; the first warms up


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", default=None, help="HSIMAE-B classifier weights (.pt)")
    args = ap.parse_args()

    import torch
    from hsimae_tpu_torch.cli import evaluate as cli_evaluate
    from hsimae_tpu_torch.cli import export as cli_export
    from hsimae_tpu_torch.config import EvalConfig, preset
    from hsimae_tpu_torch.models.hsimae import build_hsi_vit
    from hsimae_tpu_torch.serving import load_classifier
    from hsimae_tpu_torch.train.evaluate import (
        build_classifier,
        classify_scene_artifact,
        predict_scene,
    )

    if not torch.cuda.is_available():
        print("time_artifact_scene: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    scene, _, _ = cli_evaluate.prepare(cli_evaluate.build_parser().parse_args(
        chip_smoke.SCENE_ARGV))
    n_pix = scene.shape[0] * scene.shape[1]
    ecfg = EvalConfig(batch_size=chip_smoke.BATCH)
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        params = args.params
        if params is None:
            params = str(Path(tmp) / "params.pt")
            torch.save(build_hsi_vit(preset("HSIMAE-B"), chip_smoke.FT_CLASSES,
                                     device="cpu").state_dict(), params)
        for variant in chip_smoke.SERVE_VARIANTS:
            flags, dname = chip_smoke.SERVE_VARIANTS[variant]
            art = Path(tmp) / f"serve_{variant}.pt2"
            with contextlib.redirect_stdout(sys.stderr):
                cli_export.main(["--params", params, "--num-classes", str(chip_smoke.FT_CLASSES),
                                 "--output", str(art), "--model", "HSIMAE-B", *flags])
            clf = load_classifier(str(art), device="cuda")
            live = build_classifier(clf.weights(),
                                    preset("HSIMAE-B", compute_dtype=getattr(torch, dname)),
                                    chip_smoke.FT_CLASSES, device="cuda")
            walls = {"artifact": [], "live": []}
            for i in range(TURNS):
                for name, fn in (("artifact", lambda: classify_scene_artifact(scene, clf, ecfg)),
                                 ("live", lambda: predict_scene(live, scene, ecfg))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    if i:
                        walls[name].append(time.perf_counter() - t0)
            art_s, live_s = (sorted(walls[k])[len(walls[k]) // 2] for k in ("artifact", "live"))
            rates[variant] = {"warm_artifact_pixels_per_s": n_pix / art_s,
                              "warm_predict_scene_pixels_per_s": n_pix / live_s}
            print(json.dumps({"variant": variant, "dtype": dname, "flags": flags,
                              **rates[variant], "warm_walls_s": walls, "card": smi}), flush=True)
            del clf, live
            torch.cuda.empty_cache()
    print(json.dumps({"pixels": n_pix, "rates": rates, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

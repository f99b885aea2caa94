#!/usr/bin/env python3
"""Where the time goes in the port's full-scene classification, on one card.

    python3 scripts/profile_torch_eval.py [--size 145] [--bands 200] [--batch-size 4096]

Runs the main path of ``hsimae_tpu_torch.cli.evaluate`` step by step
(synthetic scene, GWPCA, model build and upload, the scene's batch loop)
with a host clock around each step. Then it traces with ``torch.profiler``,
separately, (a) the batch loop of a model already built (``predict_scene``,
warm) and (b) one whole ``classify_scene`` (model build and upload, then the
batch loop), and reports for each the device's busy share and the device time
by kernel, so the idle time splits between the two parts. Prints one JSON
object as its last line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_eval: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hsimae_tpu_torch.config import EvalConfig, preset
    from hsimae_tpu_torch.data.gwpca import apply_gwpca
    from hsimae_tpu_torch.data.synthetic import make_synthetic_scene
    from hsimae_tpu_torch.ops import _build
    from hsimae_tpu_torch.train.evaluate import build_classifier, classify_scene, predict_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=145)
    ap.add_argument("--bands", type=int, default=200)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()

    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        return out

    step("build_kernels_s", lambda: _build.build("fused_block"))
    scene, gt = step("synthetic_scene_s", lambda: make_synthetic_scene(
        args.size, args.size, bands=args.bands, n_classes=args.classes, seed=0))
    scene = step("gwpca_s", lambda: apply_gwpca(scene, nc=32).astype("float32"))
    cfg = preset("HSIMAE-B", compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    ecfg = EvalConfig(batch_size=args.batch_size)
    n_cls = args.classes + 1
    step("build_classifier_first_s", lambda: build_classifier(None, cfg, n_cls, device="cuda"))
    model = step("build_classifier_warm_s", lambda: build_classifier(None, cfg, n_cls, device="cuda"))
    step("predict_first_s", lambda: predict_scene(model, scene, ecfg))  # + kernel weight layout
    step("predict_warm_s", lambda: predict_scene(model, scene, ecfg))
    step("classify_scene_warm_s",
         lambda: classify_scene(scene, None, cfg, n_cls, ecfg, device="cuda"))

    def traced(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        by_kernel = {}  # device-side events only (kernels, copies), so nothing counts twice
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                by_kernel[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
        busy_ms = sum(ms for ms, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        return {"wall_s": wall_s, "device_busy_ms": busy_ms,
                "device_busy_share": busy_ms / 1e3 / wall_s,
                "device_idle_ms": wall_s * 1e3 - busy_ms,
                "device_events": sum(c for _, c in by_kernel.values()),
                "top_device_ms": [{"name": k[:90], "ms": ms, "count": c}
                                  for k, (ms, c) in top]}

    predict_trace = traced(lambda: predict_scene(model, scene, ecfg))
    classify_trace = traced(lambda: classify_scene(scene, None, cfg, n_cls, ecfg, device="cuda"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    n_pix = args.size * args.size
    print(json.dumps({
        "device": smi, "dtype": "bfloat16" if args.bf16 else "float32", "pixels": n_pix,
        "steps_s": steps, "warm_predict_pixels_per_s": n_pix / steps["predict_warm_s"],
        "warm_classify_scene_pixels_per_s": n_pix / steps["classify_scene_warm_s"],
        "trace_predict_scene": predict_trace, "trace_classify_scene": classify_trace,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

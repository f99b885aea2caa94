#!/usr/bin/env python3
"""Where the time goes in the baseline zoo's train step and full-scene
batch, on one card.

    python3 scripts/profile_torch_zoo.py [--models SSRN DCTN ...] [--bands 200]

For each zoo net at ``cli.benchmark``'s widths on the phase-4 scene
(``--bands`` 200 and 17 classes; SSFTT on 30 PCA bands), seeded weights:
the harness's train step (``make_train_step``, batch 64) and one eval batch
of 2048 (``evaluate_baseline``'s size), each warm, timed with a host clock
around synchronised calls, then traced with ``torch.profiler``: the
device's busy share and the device time of the largest kernels. One JSON
line per net, the card's name and power limit in each. Needs a CUDA card.
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
        print("profile_torch_zoo: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hsimae_tpu_torch.bench import harness, registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=registry.ALL_BASELINES)
    ap.add_argument("--bands", type=int, default=200)
    ap.add_argument("--classes", type=int, default=17)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(fn, iters):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / iters

    def traced(fn, iters):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t) / iters
        by_kernel = {}  # device-side events only, so nothing counts twice
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                by_kernel[ev.key] = (ev.self_device_time_total / 1e3 / iters, ev.count / iters)
        busy_ms = sum(ms for ms, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_busy_share": busy_ms / wall_ms,
                "device_kernels": sum(c for _, c in by_kernel.values()),
                "top_device_ms": [{"name": k[:80], "ms": ms} for k, (ms, _) in top]}

    for name in args.models:
        spec = registry.get_baseline_spec(name, "synthetic")
        bands = spec.pca_nc or args.bands
        ps = spec.patch_size
        model = harness.build_model(spec, bands, args.classes, seed=0, device=dev)
        step = harness.make_train_step(model, harness.make_optimizer(spec, model, 1e-3))
        x = torch.rand(spec.batch_size, ps, ps, bands, generator=gen, device=dev)
        y = torch.randint(1, args.classes, (spec.batch_size,), generator=gen, device=dev)
        w = torch.ones(spec.batch_size, device=dev)
        xe = torch.rand(2048, ps, ps, bands, generator=gen, device=dev)
        with torch.no_grad():
            ev = lambda: harness.eval_logits(model, xe)  # noqa: E731
            row = {"model": name, "bands": bands, "patch": ps, "card": smi,
                   "eval_2048_ms": timed(ev, 3)}
            row["eval_trace"] = traced(ev, 2)
        row["train_step_ms"] = timed(lambda: step(x, y, w), args.iters)
        row["train_trace"] = traced(lambda: step(x, y, w), 3)
        row["eval_pixels_per_s"] = 2048 / row["eval_2048_ms"] * 1e3
        print(json.dumps(row), flush=True)
        del model, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

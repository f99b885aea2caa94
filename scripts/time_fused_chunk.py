#!/usr/bin/env python3
"""One fused pretraining chunk against as many warm eager steps, on one card.

    python3 scripts/time_fused_chunk.py [--model HSIMAE-B] [--dtypes bfloat16 float32]
        [--remat off|on|both] [--adam-mu-dtype float32|bfloat16]

At ``chip_smoke.py`` phase 9's setting (24 synthetic scenes of 145 px at 200
bands cut to 32 by GWPCA, batch 2048, mask ratio 0.5), on the kept grid
(2, 9): for each dtype and remat setting, ``FUSED_STEPS`` (16) steps built
as ``run_pretraining`` builds them, one batch of cut-index rows a step,

* as eager steps (``make_pretrain_step``, each with its patch gather): one
  warm-up pass, then ``REPLAYS`` timed passes;
* as one chunk (``make_fused_pretrain_chunk``): the first call captures the
  CUDA graph (its seconds are reported), then ``REPLAYS`` timed replays;

host clock with a synchronise around each, the medians per step, the
patches/s, each path's peak memory (``max_memory_allocated``), the last
chunk's loss (finite) and the block-kernel launches (none: training runs
the Block modules). Then a ``torch.profiler`` trace of one chunk of the
first setting: the device's busy share of its wall time. One JSON line a setting, then one JSON object as the last line.
Exits 1 if a loss is not finite or a block kernel launched. Needs a CUDA
card; ``chip_smoke.py`` phase 18b holds the same chunks' numbers
(resume, background checkpoints, ``--profile``) through the CLI.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the smoke run's argument lists)

REPLAYS = 3  # timed passes of each path; the median is reported
GRID = (2, 9)


def busy_share(prof, wall_ms: float) -> dict:
    """Device busy ms of a traced window (every CUDA kernel and copy's own
    time) and its share of the window's wall time."""
    from torch.autograd import DeviceType

    busy, events = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy += ev.self_device_time_total / 1e3
            events += ev.count
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
            "device_events": events}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="HSIMAE-B")
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"],
                    choices=["bfloat16", "float32"])
    ap.add_argument("--remat", choices=["off", "on", "both"], default="off")
    ap.add_argument("--adam-mu-dtype", choices=["float32", "bfloat16"], default="float32")
    args = ap.parse_args()

    import numpy as np
    import torch
    from hsimae_tpu_torch.cli import pretrain as cli
    from hsimae_tpu_torch.models.hsimae import build_hsimae
    from hsimae_tpu_torch.ops import fused_block as fb
    from hsimae_tpu_torch.train.optim import pretrain_optimizer
    from hsimae_tpu_torch.train.pretrain import make_fused_pretrain_chunk, make_pretrain_step

    if not torch.cuda.is_available():
        print("time_fused_chunk: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    argv = [args.model if a == "HSIMAE-B" else a for a in chip_smoke.PRETRAIN_ARGV]
    source, index, mcfg, pcfg = cli.prepare(cli.build_parser().parse_args(argv))
    batch, k = chip_smoke.PRETRAIN_BATCH, chip_smoke.FUSED_STEPS
    mu_dtype = torch.bfloat16 if args.adam_mu_dtype == "bfloat16" else None
    locs_dev = torch.as_tensor(index.locs, dtype=torch.int64).to("cuda")
    rows = locs_dev[torch.as_tensor(np.random.default_rng(12).integers(
        0, len(index), (k, batch))).to("cuda")]

    def launches() -> int:
        return sum(getattr(fb, c) for _, _, c in chip_smoke.KERNELS.values())

    def timed(fn):
        times = []
        for _ in range(REPLAYS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return times

    def trained(cfg):
        model = build_hsimae(cfg, seed=pcfg.seed, device="cuda")
        return (model, *pretrain_optimizer(model, pcfg.lr, pcfg.weight_decay, 10 * k,
                                           mu_dtype=mu_dtype))

    remats = {"off": [False], "on": [True], "both": [False, True]}[args.remat]
    out, traced, ok = [], None, True
    for dname in args.dtypes:
        for remat in remats:
            cfg = mcfg.replace(compute_dtype=getattr(torch, dname), remat=remat)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            n0 = launches()
            step = make_pretrain_step(*trained(cfg), seed=pcfg.seed)

            def eager():
                for i in range(k):
                    step(source.gather(rows[i]), *GRID)

            eager()  # warm-up
            eager_ms = timed(eager)
            peak_eager = torch.cuda.max_memory_allocated()
            del step
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            chunk = make_fused_pretrain_chunk(*trained(cfg), source, seed=pcfg.seed)
            chunk(rows, *GRID)  # the capture
            fused_ms = timed(lambda: chunk(rows, *GRID))
            loss = chunk(rows, *GRID).item()
            fused_med, eager_med = sorted(fused_ms)[REPLAYS // 2], sorted(eager_ms)[REPLAYS // 2]
            row = {"check": "one fused chunk against eager steps", "model": args.model,
                   "dtype": dname, "remat": remat, "adam_mu_dtype": args.adam_mu_dtype,
                   "k": k, "batch": batch, "grid": list(GRID),
                   "capture_s": {f"{lt}x{ll}": v for (lt, ll, _), v in
                                 chunk.capture_seconds.items()},
                   "chunk_ms": fused_ms, "eager_ms": eager_ms,
                   "fused_step_ms": fused_med / k, "eager_step_ms": eager_med / k,
                   "fused_patches_per_sec": k * batch / (fused_med / 1e3),
                   "eager_patches_per_sec": k * batch / (eager_med / 1e3),
                   "speedup": eager_med / fused_med, "loss": loss,
                   "max_memory_allocated_bytes_eager": peak_eager,
                   "max_memory_allocated_bytes_fused": torch.cuda.max_memory_allocated(),
                   "block_kernel_launches": launches() - n0, "card": smi}
            print(json.dumps(row), flush=True)
            out.append(row)
            ok = ok and math.isfinite(loss) and row["block_kernel_launches"] == 0
            if traced is None:
                traced = chunk
            else:
                del chunk
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced(rows, *GRID)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    trace = {"setting": {k_: out[0][k_] for k_ in ("dtype", "remat")},
             **busy_share(prof, traced_ms)}
    print(json.dumps({"check": "trace of one fused chunk", **trace, "card": smi}), flush=True)
    print(json.dumps({"model": args.model, "k": k, "batch": batch, "ok": ok, "trace": trace,
                      "fused_step_ms": {f"{r['dtype']} remat={r['remat']}": r["fused_step_ms"]
                                        for r in out},
                      "card": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

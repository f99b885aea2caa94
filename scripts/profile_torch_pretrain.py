#!/usr/bin/env python3
"""Where the time goes in the port's HSIMAE-B pretrain step, on one card.

    python3 scripts/profile_torch_pretrain.py [--bf16] [--batch-size 2048] [--grid 2,9]

Builds the pretraining model and optimizer as ``run_pretraining`` does and
runs ``make_pretrain_step`` on one patch batch already on the device (the
patch gather is timed apart). Host clock, with a synchronise, around warm
steps and around their parts: the forward alone (no graph kept), forward +
backward, the optimizer update. Then ``torch.profiler`` traces a few steps
and reports the device's busy share, the device events and CPU-side ops per
step, and the device time by kernel and by kind of kernel. Prints one JSON
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

KINDS = (  # kernel-name substring -> kind, first match wins
    ("gemm", "matmul (cuBLAS)"), ("xmma", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"),
    ("multi_tensor_apply", "optimizer (foreach)"), ("layer_norm", "layer norm"),
    ("softmax", "softmax"), ("scatter", "gather/scatter"), ("gather", "gather/scatter"),
    ("index", "gather/scatter"), ("reduce", "reductions"), ("elementwise", "elementwise"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)


def kind_of(name: str) -> str:
    for sub, kind in KINDS:
        if sub.lower() in name.lower():
            return kind
    return "other"


def trace_summary(prof, n_traced: int, wall_ms: float) -> dict:
    """Per traced step: device busy ms and share of the wall time, device
    events, aten ops, device ms by kind and the 15 costliest kernels."""
    from torch.autograd import DeviceType

    by_kernel, kinds, cpu_ops = {}, {}, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by_kernel[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
            k = kind_of(ev.key)
            kinds[k] = kinds.get(k, 0.0) + ev.self_device_time_total / 1e3 / n_traced
        elif ev.key.startswith("aten::"):
            cpu_ops += ev.count
    busy_ms = sum(v for v, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return {"steps": n_traced, "wall_ms_per_step": wall_ms / n_traced,
            "device_busy_ms_per_step": busy_ms / n_traced,
            "device_busy_share": busy_ms / wall_ms,
            "device_events_per_step": sum(c for _, c in by_kernel.values()) / n_traced,
            "aten_ops_per_step": cpu_ops / n_traced,
            "device_ms_per_step_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_device_ms_per_step": [{"name": k[:90], "ms": v / n_traced, "count": c / n_traced}
                                       for k, (v, c) in top]}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_pretrain: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from hsimae_tpu_torch.config import preset
    from hsimae_tpu_torch.data.pipeline import MultiScenePatchSource
    from hsimae_tpu_torch.models.hsimae import build_hsimae
    from hsimae_tpu_torch.train.optim import pretrain_optimizer, set_lr
    from hsimae_tpu_torch.train.pretrain import draw_pretrain, make_pretrain_step, step_generator

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--grid", default="2,9", help="kept len_t,len_l")
    ap.add_argument("--steps", type=int, default=10, help="timed warm steps")
    args = ap.parse_args()
    len_t, len_l = (int(v) for v in args.grid.split(","))
    dev = torch.device("cuda")
    cfg = preset("HSIMAE-B", compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    model = build_hsimae(cfg, seed=0, device=dev)
    opt, sched = pretrain_optimizer(model, 5e-3, 0.05, total_steps=1000)
    step = make_pretrain_step(model, opt, sched)
    bs = args.batch_size
    gen = torch.Generator().manual_seed(0)
    scenes = [torch.rand(145, 145, cfg.bands, generator=gen).numpy() for _ in range(4)]
    source = MultiScenePatchSource(scenes, cfg.img_size, device=dev)
    locs = torch.stack([torch.randint(0, 145 - cfg.img_size, (bs,), generator=gen),
                        torch.randint(0, 145 - cfg.img_size, (bs,), generator=gen),
                        torch.randint(0, 4, (bs,), generator=gen)], 1).numpy()
    imgs = source.gather(locs)

    def timed(fn, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    def forward():
        with torch.no_grad():
            model.forward_pretrain(imgs, len_t, len_l, generator=step_generator(0, 0, dev))

    def forward_backward():
        draws = draw_pretrain(model, bs, len_t, len_l, step_generator(0, 0, dev), dev)
        loss = model.forward_pretrain(imgs, len_t, len_l, grid=draws.grid)[0]
        opt.zero_grad()
        loss.backward()

    def update():
        set_lr(opt, sched(opt.count))
        opt.step()

    for _ in range(3):
        step(imgs, len_t, len_l)
    model.train()
    ms = {"step": timed(lambda: step(imgs, len_t, len_l), args.steps),
          "gather": timed(lambda: source.gather(locs), args.steps),
          "forward_no_grad": timed(forward, args.steps),
          "forward_backward": timed(forward_backward, args.steps),
          "optimizer": timed(update, args.steps)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(args.steps):
        step(imgs, len_t, len_l)
    enqueue_ms = (time.perf_counter() - t) / args.steps * 1e3  # host time, no wait for the card
    torch.cuda.synchronize()

    n_traced = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_traced):
            step(imgs, len_t, len_l)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    print(json.dumps({
        "device": card_line(), "model": "HSIMAE-B",
        "dtype": "bfloat16" if args.bf16 else "float32",
        "batch": bs, "grid": [len_t, len_l], "ms": ms, "enqueue_ms_per_step": enqueue_ms,
        "patches_per_sec_step": bs / ms["step"] * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "trace": trace_summary(prof, n_traced, wall_ms),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time goes in the port's HSIMAE-B fine-tuning epoch, on one card.

    python3 scripts/profile_torch_finetune.py [--bf16] [--labeled 32] [--unlabeled 48] [--val 80]

The reference recipe's sizes by default (10 labeled pixels a class on a
16-class scene: dual steps of 32 labeled and 48 unlabeled patches, a
validation batch of 80). Builds the fine-tuning model and optimizer as
``dual_branch_finetune`` does and runs ``make_dual_step`` at the kept grid
(2, 4) on batches already on the device. Host clock, with a synchronise,
around warm steps and around their parts: the draws, the forward alone (no
graph kept), forward + backward, the optimizer update, and the host time
to enqueue a step. Then one validation batch through
``make_eval_metrics_step``: with the kernel weights rebuilt first (as after
every update), without, and the rebuild alone. ``torch.profiler`` traces a
few dual steps and a few validation batches. Prints one JSON object as its
last line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from profile_torch_pretrain import card_line, trace_summary  # noqa: E402  (this directory)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_finetune: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from hsimae_tpu_torch.config import preset
    from hsimae_tpu_torch.models.hsimae import ENCODER_STACKS, build_dual_vit
    from hsimae_tpu_torch.train.finetune import (
        draw_dual,
        make_dual_step,
        make_eval_metrics_step,
    )
    from hsimae_tpu_torch.train.optim import finetune_optimizer, set_lr
    from hsimae_tpu_torch.train.pretrain import step_generator

    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--labeled", type=int, default=32)
    ap.add_argument("--unlabeled", type=int, default=48)
    ap.add_argument("--val", type=int, default=80, help="validation batch")
    ap.add_argument("--steps", type=int, default=20, help="timed warm steps")
    args = ap.parse_args()
    len_t, len_l = 2, 4
    n, n_u, classes = args.labeled, args.unlabeled, 17
    dev = torch.device("cuda")
    cfg = preset("HSIMAE-B", compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    model = build_dual_vit(cfg, classes, seed=0, device=dev)
    opt, sched = finetune_optimizer(model, 1e-3, 5e-3, epochs=200, steps_per_epoch=3)
    step = make_dual_step(model, opt, sched, lamda=10.0)
    ev = make_eval_metrics_step(model, classes)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(n, 9, 9, cfg.bands, device=dev, generator=gen)
    xu = torch.rand(n_u, 9, 9, cfg.bands, device=dev, generator=gen)
    y = torch.randint(1, classes, (n,), device=dev, generator=gen)
    w = torch.ones(n, device=dev)
    xv = torch.rand(args.val, 9, 9, cfg.bands, device=dev, generator=gen)
    yv = torch.randint(1, classes, (args.val,), device=dev, generator=gen)
    wv = torch.ones(args.val, device=dev)

    def timed(fn, k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / k * 1e3

    def draws():
        return draw_dual(model, n, n_u, len_t, len_l, step_generator(0, 0, dev), dev)

    def forward():
        d = draws()
        with torch.no_grad():
            model.forward_dual(x, xu, len_t, len_l, w, d.grid, d.drop_keep_cls, d.drop_keep_rec)

    def forward_backward():
        d = draws()
        rec, _ = model.forward_dual(x, xu, len_t, len_l, w, d.grid, d.drop_keep_cls,
                                    d.drop_keep_rec)
        opt.zero_grad()
        rec.backward()

    def update():
        set_lr(opt, sched(opt.count))
        opt.step()

    def touch():
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.0)  # a new version: the next eval rebuilds the kernel weights

    def val_pass():
        cm, ce, cnt = ev(xv, yv, wv)
        torch.cat([cm.flatten(), ce[None], cnt[None]]).cpu()

    def val_pass_repacked():
        touch()
        val_pass()

    def repack():
        touch()
        for name in ENCODER_STACKS:
            model.kernel_params(name)

    for _ in range(3):
        step(x, y, w, xu, len_t, len_l)
        val_pass_repacked()
    model.train()
    ms = {"dual_step": timed(lambda: step(x, y, w, xu, len_t, len_l), args.steps),
          "draws": timed(draws, args.steps),
          "forward_no_grad": timed(forward, args.steps),
          "forward_backward": timed(forward_backward, args.steps),
          "optimizer": timed(update, args.steps),
          "touch_weights": timed(touch, args.steps),
          "val_pass_with_repack": timed(val_pass_repacked, args.steps),
          "val_pass_without_repack": timed(val_pass, args.steps),
          "repack_with_touch": timed(repack, args.steps)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(args.steps):
        step(x, y, w, xu, len_t, len_l)
    enqueue_ms = (time.perf_counter() - t) / args.steps * 1e3  # host time, no wait for the card
    torch.cuda.synchronize()

    traces = {}
    for name, fn in (("dual_step", lambda: step(x, y, w, xu, len_t, len_l)),
                     ("val_pass_with_repack", val_pass_repacked)):
        k = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(k):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        traces[name] = trace_summary(prof, k, wall_ms)
    print(json.dumps({
        "device": card_line(), "model": "HSIMAE-B",
        "dtype": "bfloat16" if args.bf16 else "float32", "labeled": n, "unlabeled": n_u,
        "val_batch": args.val, "grid": [len_t, len_l], "ms": ms,
        "enqueue_ms_per_dual_step": enqueue_ms, "dual_steps_per_s": 1e3 / ms["dual_step"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "trace": traces,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

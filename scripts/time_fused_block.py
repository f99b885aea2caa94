#!/usr/bin/env python3
"""Time the fused-block kernels of one checkout of the port by two methods.

    python3 scripts/time_fused_block.py [--root DIR] [--label NAME] [--width 128|256]
                                        [--kernel all|wgmma_d256]

Imports ``hsimae_tpu_torch`` from ``--root`` (default: this repo), so the
same timer can read an older checkout of the port, unpacked into a
git-ignored directory, beside this one: run old, new, new, old in one
session on one card and compare within it. For float32 and bfloat16 at the
main-path shapes of batch 4096 of HSIMAE-B (``--width 128``: D 128, 8
heads, SwiGLU 344) or HSIMAE-L (``--width 256``: D 256, 16 heads, SwiGLU
684), the same seeded inputs in every checkout, it prints one JSON line per
case with the kernel's time by

- ``single_call_ms``: CUDA events around each single call, the median of
  40 (the wrapper's host time falls inside the events and varies by several
  percent from call to call), and
- ``back_to_back_ms``: CUDA events around 10 back-to-back calls divided by
  10, the median of 3 rounds (launch gaps hidden while the host stays ahead),

then a last line with the card's name and power limit. ``--kernel
wgmma_d256`` times only bfloat16 at HSIMAE-L's shapes: the D 256 kernel of
a checkout that has one, the D 128 kernel's D 256 instantiation of an older
one. Each kernel gets its
weights in the form that checkout's wrapper takes: ``kernel_weights`` where
the checkout has it (the float32 3xTF32 packs, the bfloat16 pack), else
``pack_block`` for bfloat16 and ``BlockParams`` for float32. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

MODELS = {128: ("HSIMAE-B", 8, 344), 256: ("HSIMAE-L", 16, 684)}  # width: (model, heads, hidden)


def shapes(d: int) -> dict:
    """[M, S, D] of the blocks_1, blocks_2 and fusion launches at batch 4096."""
    return {"blocks_1": (16384, 9, d), "blocks_2": (36864, 4, d), "fusion": (4096, 36, d)}


def single_call_ms(fn, iters: int = 40, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def back_to_back_ms(fn, iters: int = 10, rounds: int = 3, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--width", type=int, choices=sorted(MODELS), default=128)
    ap.add_argument("--kernel", choices=("all", "wgmma_d256"), default="all")
    args = ap.parse_args()
    if args.kernel == "wgmma_d256":
        args.width = 256
    d, (model, heads, hidden) = args.width, MODELS[args.width]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_fused_block: needs a CUDA card", file=sys.stderr)
        return 1
    from hsimae_tpu_torch.ops import fused_block as fb

    def weights(gen):
        """Seeded float32 block weights at unit-gain scale on the card."""
        def w(i, o):
            return torch.randn(i, o, generator=gen) / math.sqrt(i)

        def vec(n, base=0.0):
            return base + 0.1 * torch.randn(n, generator=gen)

        p = fb.BlockParams(vec(d, 1.0), vec(d), w(d, d), vec(d), w(d, d), vec(d), w(d, d), vec(d),
                           w(d, d), vec(d), vec(d, 1.0), vec(d), w(d, hidden), vec(hidden),
                           w(d, hidden), vec(hidden), w(hidden, d), vec(d))
        return fb.BlockParams(*(t.cuda() for t in p))

    def kernel_weights(p, dtype):
        if hasattr(fb, "kernel_weights"):
            return fb.kernel_weights(p, dtype)
        return fb.pack_block(p) if hasattr(fb, "pack_block") and dtype == torch.bfloat16 else p

    gen = torch.Generator().manual_seed(0)
    dtypes = (torch.bfloat16,) if args.kernel == "wgmma_d256" else (torch.float32, torch.bfloat16)
    for dtype in dtypes:
        for name, (m, s, _) in shapes(d).items():
            p = weights(gen)
            w = kernel_weights(p, dtype)
            x = torch.randn(m, s, d, generator=gen).to("cuda", dtype)
            with torch.inference_mode():
                run = lambda: fb.fused_encoder_block(x, w, heads)  # noqa: E731
                row = {"label": args.label, "model": model, "block": name,
                       "shape": [m, s, d], "dtype": str(dtype).removeprefix("torch."),
                       "single_call_ms": single_call_ms(run),
                       "back_to_back_ms": back_to_back_ms(run)}
            print(json.dumps(row), flush=True)
            del x, p, w
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "package": fb.__file__, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Pooling backward on the card against the CPU, by input and gradient strides.

    python3 scripts/check_torch_pool_strides.py

HybridFormer's stem feeds ``F.avg_pool2d`` (3x3, stride 1, padding 1) a
``[32, 103, 15, 15]`` tensor. When the zoo's nets took their channels-last
input as a permuted view, that tensor had channels-last strides while the
gradient flowing back was contiguous, and the card's gradient of the stem
was wrong (``chip_smoke.py`` 16b). This script holds ``avg_pool2d`` and
``max_pool2d`` backward on the card against the CPU on the same numbers,
for each pairing of contiguous and channels-last input and gradient, and
prints one JSON line per case with the miss scaled by the CPU gradient's
largest value, then the card's name and power limit. Exits 1 when a case
misses by more than 1e-5 (a pooling backward only adds and routes), so it
tells when a torch release has the fault. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(32, 103, 15, 15, generator=gen)
    pools = {"avg_pool2d 3x3 s1 p1": lambda t: F.avg_pool2d(t, 3, stride=1, padding=1),
             "max_pool2d 2x2 s2": lambda t: F.max_pool2d(t, 2, stride=2)}
    layouts = {"contiguous": torch.contiguous_format, "channels_last": torch.channels_last}
    worst = 0.0
    for name, pool in pools.items():
        g = torch.randn(pool(x).shape, generator=gen)
        for x_layout, x_fmt in layouts.items():
            for g_layout, g_fmt in layouts.items():
                grads = []
                for dev in ("cpu", "cuda"):
                    xi = x.to(dev).contiguous(memory_format=x_fmt).requires_grad_(True)
                    (gi,) = torch.autograd.grad(pool(xi), xi,
                                                g.to(dev).contiguous(memory_format=g_fmt))
                    grads.append(gi.cpu())
                miss = ((grads[1] - grads[0]).abs().max() / grads[0].abs().max()).item()
                worst = max(worst, miss)
                print(json.dumps({"pool": name, "input": x_layout, "grad": g_layout,
                                  "miss": miss}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version(), "worst_miss": worst}))
    return 0 if worst <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())

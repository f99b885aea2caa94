#!/usr/bin/env python3
"""Where the time goes inside the bf16 fused-block kernel, on one card.

    python3 scripts/profile_fused_block.py

Builds ``ops/csrc/fused_block_wgmma.cu`` a second time with
``-DHSIMAE_PHASE_CLOCKS``: the first consumer thread of every CTA then adds
the SM clocks it spends in each phase of a row tile to a device counter.
For the HSIMAE-B main-path shapes at batch 4096 (and the D 64 / D 256
fusion shapes) it prints, per shape, the kernel's time with and without the
instrumentation (CUDA events over back-to-back launches, the plain build
first and last), and the thousands of clocks per row tile in each phase
with their shares. Needs a CUDA card; prints one JSON object as its last
line.

Phases, in order: ``tile_start`` (waiting for the other consumer warpgroup
to finish the previous tile, and that tile's output store), ``x_to_smem``
(the prefetched x rows into shared memory), ``ln1``, ``qkv`` (three
products and their epilogues), ``attention`` (with the barriers around it),
``out_proj`` (product and residual), ``ln2``, ``w13`` (SwiGLU hidden tiles,
and the next tile's x prefetch), ``w2`` (product and residual).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PHASES = ("tile_start", "x_to_smem", "ln1", "qkv", "attention", "out_proj", "ln2", "w13", "w2")
SHAPES = {"blocks_1": (16384, 9, 128), "blocks_2": (36864, 4, 128), "fusion": (4096, 36, 128),
          "fusion_D64": (4096, 36, 64), "fusion_D256": (4096, 36, 256)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_fused_block: needs a CUDA card", file=sys.stderr)
        return 1
    from hsimae_tpu_torch.models.layers import swiglu_hidden_dim
    from hsimae_tpu_torch.ops import _build
    from hsimae_tpu_torch.ops import fused_block as fb

    from chip_smoke import random_block, time_ms

    # the wrapper launches the plain build; the instrumented one is called here directly
    probe = _build.load_library("fused_block_wgmma", ("-DHSIMAE_PHASE_CLOCKS",))
    gen = torch.Generator().manual_seed(0)
    sm_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    out = {}
    for label, (m, s, d) in SHAPES.items():
        p = random_block(d, swiglu_hidden_dim(d), gen, "cuda")
        pack = fb.pack_block(p)
        x = torch.randn(m, s, d, generator=gen).to("cuda", torch.bfloat16)
        out_probe = torch.empty_like(x)
        hp = fb.padded_hidden(p.w1.shape[-1])

        def run_probe():
            rc = probe.hsimae_fused_block_wgmma(
                x.data_ptr(), out_probe.data_ptr(), pack.image.data_ptr(), pack.vecs.data_ptr(),
                m, s, d, hp, d // 16, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"instrumented kernel launch failed: cudaError_t {rc}")

        run = lambda: fb.fused_encoder_block(x, pack, d // 16)  # noqa: E731
        plain_ms = [time_ms(run, iters=20)]
        probed_ms = time_ms(run_probe, iters=20)
        buf = np.zeros(16, np.uint64)
        ptr = buf.ctypes.data_as(ctypes.c_void_p)
        probe.hsimae_fused_block_wgmma_phase_clocks(ptr)  # zero the counters
        run_probe()
        if probe.hsimae_fused_block_wgmma_phase_clocks(ptr) != 0:
            raise RuntimeError("reading the phase clocks failed")
        plain_ms.append(time_ms(run, iters=20))
        probe_diff = (out_probe.float() - run().float()).abs().max().item()
        rows = 128 if d <= 128 else 64
        tiles = -(-m // (rows // s))
        kclk = {ph: float(buf[i]) / tiles / 1e3 for i, ph in enumerate(PHASES)}
        total = sum(kclk.values())
        out[label] = {"shape": [m, s, d], "ms": plain_ms, "ms_instrumented": probed_ms,
                      "instrumented_max_abs_diff": probe_diff,
                      "row_tiles": tiles, "kclk_per_tile": kclk,
                      "share": {ph: v / total for ph, v in kclk.items()}}
        print(json.dumps({label: out[label]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "max_sm_clock": sm_clock, "phases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time goes inside the fused-block wgmma kernels, on one card.

    python3 scripts/profile_fused_block.py [--kernel wgmma|wgmma_d256|tf32x3|d256|both|all]

Builds ``ops/csrc/fused_block_wgmma.cu`` (bfloat16 at D 64/128),
``ops/csrc/fused_block_wgmma_d256.cu`` (bfloat16 at D 256),
``ops/csrc/fused_block_tf32x3.cu`` (float32 at D 64/128, 3xTF32) and
``ops/csrc/fused_block_tf32x3_d256.cu`` (float32 at D 256) a second time
with ``-DHSIMAE_PHASE_CLOCKS``, all nvcc runs at once (``both`` is wgmma and
tf32x3, ``all`` adds wgmma_d256 and d256):
the first consumer thread of every CTA then adds the SM clocks it spends in
each phase of a row tile to a device counter. For the HSIMAE-B main-path
shapes at batch 4096, HSIMAE-L's at D 256 and the D 64 fusion shape (each
where the kernel takes it) it prints, per
kernel and shape, the kernel's time with and without the instrumentation
(CUDA events over back-to-back launches, the plain build first and last),
the thousands of clocks per row tile in each phase with their shares, and,
for each product phase, the weight bytes it pulls through the ring per
clock. Needs a CUDA card; prints one JSON object as its last line.

bf16 phases, in order: ``tile_start`` (waiting for the other consumer
warpgroup to finish the previous tile, and that tile's output store),
``x_to_smem`` (the prefetched x rows into shared memory), ``ln1``, ``qkv``
(three products and their epilogues), ``attention`` (with the barriers
around it), ``out_proj`` (product and residual), ``ln2``, ``w13`` (SwiGLU
hidden tiles, and the next tile's x prefetch), ``w2`` (product and
residual).

bf16 D 256 phases, summed over the four head groups and the hidden tiles:
``tile_start`` (the warpgroup's barrier), ``ln1`` (x from global memory),
``qkv`` (each group's [q | k] and v products, their epilogues and the
barriers around them), ``attention``, ``out_proj`` (Wo's product),
``ln2`` (the first residual add, LN2 in registers, the next tile's x
prefetch), ``w13`` (each hidden tile's two [W1 | W3] products and their
epilogues), ``w2`` (each tile's slice of W2), ``store`` (the second
residual add).

3xTF32 phases: ``tile_start`` (the barrier that frees q/k/v), ``x_ln1`` (x
rows into shared memory and the LN1 statistics), ``qkv`` (three products on
the fly-normalised residual, their epilogues, the barrier), ``attention``,
``out_proj``, ``ln2`` (statistics and the barrier before the hidden tile),
``w13``, ``w2``, ``store`` (the output rows).

D 256 phases, summed over the four head groups and the hidden
tiles: ``tile_start``, ``x_ln1``, ``qkv`` (each group's q/k/v product, its
epilogue and barriers), ``attention``, ``out_proj`` (each group's slice of
Wo, and the residual add), ``ln2``, ``w13`` (each gate tile and its
barrier), ``w2`` (each tile's slice of W2, and the residual add),
``store``; and, within them, the clocks spent waiting (counters 9-11):
``ring_wait`` (for a weight stage to land, issuing the next ones
meanwhile), ``wgmma_wait`` (for the warpgroup's wgmmas), ``bar_wait`` (at
the consumers' barriers).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = {"blocks_1": (16384, 9, 128), "blocks_2": (36864, 4, 128), "fusion": (4096, 36, 128),
          "fusion_D64": (4096, 36, 64), "blocks_1_D256": (16384, 9, 256),
          "blocks_2_D256": (36864, 4, 256), "fusion_D256": (4096, 36, 256)}
PROFILES = {
    "wgmma": {"lib": "fused_block_wgmma", "widths": (64, 128),
              "phases": ("tile_start", "x_to_smem", "ln1", "qkv", "attention", "out_proj", "ln2",
                         "w13", "w2")},
    "wgmma_d256": {"lib": "fused_block_wgmma_d256", "widths": (256,),
                   "phases": ("tile_start", "ln1", "qkv", "attention", "out_proj", "ln2", "w13",
                              "w2", "store")},
    "tf32x3": {"lib": "fused_block_tf32x3", "widths": (64, 128),
               "phases": ("tile_start", "x_ln1", "qkv", "attention", "out_proj", "ln2", "w13",
                          "w2", "store")},
    "d256": {"lib": "fused_block_tf32x3_d256", "widths": (256,),
             "phases": ("tile_start", "x_ln1", "qkv", "attention", "out_proj", "ln2", "w13",
                        "w2", "store"),
             "waits": ("ring_wait", "wgmma_wait", "bar_wait")},
}
CHOICES = {"wgmma": ("wgmma",), "wgmma_d256": ("wgmma_d256",), "tf32x3": ("tf32x3",),
           "d256": ("d256",), "both": ("wgmma", "tf32x3"),
           "all": ("wgmma", "wgmma_d256", "tf32x3", "d256")}


def phase_weight_bytes(kernel: str, d: int, hp: int) -> dict:
    """Bytes of packed weights each product phase takes from the ring per row
    tile (both images for the 3xTF32 kernels)."""
    if kernel == "d256":  # K atoms of 16; q/k/v by head group of 64 columns
        atom = d * 16 * 4 * 2  # a 256-row atom, hi and lo
        return {"qkv": 3 * d * d * 4 * 2, "out_proj": d // 16 * atom,
                "w13": 2 * hp * d * 4 * 2, "w2": -(-hp // 16) * atom}
    if kernel == "wgmma_d256":  # bf16; W2 by K atoms of 64 hidden columns, 256 rows each
        return {"qkv": 3 * d * d * 2, "out_proj": d * d * 2, "w13": 2 * hp * d * 2,
                "w2": -(-hp // 64) * d * 64 * 2}
    atom_k, images = (32, 2) if kernel == "tf32x3" else (64, 1)
    ka, hka = d // atom_k, -(-hp // atom_k)
    tile = d * 128 * images  # a D-wide product's K atom
    return {"qkv": 3 * ka * tile, "out_proj": ka * tile,
            "w13": 2 * hp * ka * 128 * images, "w2": hka * tile}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(CHOICES), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_fused_block: needs a CUDA card", file=sys.stderr)
        return 1
    from hsimae_tpu_torch.models.layers import swiglu_hidden_dim
    from hsimae_tpu_torch.ops import _build
    from hsimae_tpu_torch.ops import fused_block as fb

    from chip_smoke import random_block, time_ms

    kernels = CHOICES[args.kernel]
    flags = ("-DHSIMAE_PHASE_CLOCKS",)
    libs = tuple(PROFILES[k]["lib"] for k in kernels)
    with ThreadPoolExecutor(2) as pool:  # the instrumented and the plain builds, all at once
        list(pool.map(lambda f: _build.build_all(libs, f), (flags, ())))
    gen = torch.Generator().manual_seed(0)
    sm_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    out = {}
    for kernel in kernels:
        prof = PROFILES[kernel]
        # the wrapper launches the plain build; the instrumented one is called here directly
        probe = _build.load_library(prof["lib"], flags)
        read_clocks = getattr(probe, f"hsimae_{prof['lib']}_phase_clocks")
        for label, (m, s, d) in SHAPES.items():
            if d not in prof["widths"]:
                continue
            p = random_block(d, swiglu_hidden_dim(d), gen, "cuda")
            stream = torch.cuda.current_stream().cuda_stream
            if kernel in ("tf32x3", "d256"):
                pack = fb.kernel_weights(p, torch.float32)
                x = torch.randn(m, s, d, generator=gen).cuda()
                hp = fb.padded_hidden(p.w1.shape[-1], fb.TF32_HIDDEN_MULTIPLE)
                ptrs = (pack.hi.data_ptr(), pack.lo.data_ptr(), pack.vecs.data_ptr())
                rows = 64
            else:  # both bf16 kernels take 128-row tiles
                pack = fb.kernel_weights(p, torch.bfloat16)
                x = torch.randn(m, s, d, generator=gen).to("cuda", torch.bfloat16)
                hp = fb.padded_hidden(p.w1.shape[-1])
                ptrs = (pack.image.data_ptr(), pack.vecs.data_ptr())
                rows = 128
            out_probe = torch.empty_like(x)
            fn = getattr(probe, f"hsimae_{prof['lib']}")

            def run_probe():
                rc = fn(x.data_ptr(), out_probe.data_ptr(), *ptrs, m, s, d, hp, d // 16, stream)
                if rc != 0:
                    raise RuntimeError(f"instrumented kernel launch failed: cudaError_t {rc}")

            run = lambda: fb.fused_encoder_block(x, pack, d // 16)  # noqa: E731
            plain_ms = [time_ms(run, iters=20)]
            probed_ms = time_ms(run_probe, iters=20)
            buf = np.zeros(16, np.uint64)
            ptr = buf.ctypes.data_as(ctypes.c_void_p)
            read_clocks(ptr)  # zero the counters
            run_probe()
            if read_clocks(ptr) != 0:
                raise RuntimeError("reading the phase clocks failed")
            plain_ms.append(time_ms(run, iters=20))
            probe_diff = (out_probe.float() - run().float()).abs().max().item()
            tiles = -(-m // (rows // s))
            kclk = {ph: float(buf[i]) / tiles / 1e3 for i, ph in enumerate(prof["phases"])}
            total = sum(kclk.values())
            waits = {w: float(buf[9 + i]) / tiles / 1e3 for i, w in enumerate(prof.get("waits", ()))}
            wbytes = phase_weight_bytes(kernel, d, hp)
            out[f"{kernel}:{label}"] = {
                "kernel": prof["lib"], "shape": [m, s, d], "ms": plain_ms,
                "ms_instrumented": probed_ms, "instrumented_max_abs_diff": probe_diff,
                "row_tiles": tiles, "kclk_per_tile": kclk,
                "share": {ph: v / total for ph, v in kclk.items()},
                "kclk_waiting_per_tile": waits,
                "weight_bytes_per_tile": sum(wbytes.values()),
                "weight_bytes_per_clock": {ph: b / (kclk[ph] * 1e3) for ph, b in wbytes.items()},
                "weight_bytes_per_clock_whole_tile": sum(wbytes.values()) / (total * 1e3)}
            print(json.dumps({f"{kernel}:{label}": out[f"{kernel}:{label}"]}), flush=True)
            del x, out_probe, pack, p
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "max_sm_clock": sm_clock, "phases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

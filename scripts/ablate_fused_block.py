#!/usr/bin/env python3
"""What bounds the float32 D 256 fused-block kernel: time it beside copies
with one part of its work taken out, on one card.

    python3 scripts/ablate_fused_block.py

Builds ``ops/csrc/fused_block_tf32x3_d256.cu`` and variants of it, all
nvcc runs at once, each with a piece of its source removed:

- ``nomma``: no wgmma (the weight stream, the A split, attention, the
  epilogues and every barrier stay);
- ``nosplit``: no A split (the fragments are not loaded from shared memory
  nor cut into TF32 hi and lo);
- ``nomma_nosplit``: neither;
- ``noattn``: no attention;
- ``hionly``: only the hi image streamed (half the weight bytes; the lo
  tiles are read from where the hi tiles land).

and times each at HSIMAE-L's blocks_1 and fusion launch shapes (CUDA events
over back-to-back launches, ``chip_smoke.time_ms``), printing one JSON line
per variant and shape with its scaled error against
``block_reference`` (only ``base`` computes the block), then the card's
name and power limit. A variant whose text no longer matches the source
raises. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "hsimae_tpu_torch/ops/csrc/fused_block_tf32x3_d256.cu"
MMA = """#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    Wgmma<N>::mma(d, lo[s], sw64_desc(b_hi + 32 * s), s == 0 && !ACCUMULATE ? 0 : 1);
    Wgmma<N>::mma(d, hi[s], sw64_desc(b_lo + 32 * s), 1);
    Wgmma<N>::mma(d, hi[s], sw64_desc(b_hi + 32 * s), 1);
  }"""
SPLIT = "  for (int s = 0; s < STEPS; ++s) split4(a.at(k0 + 8 * s), hi[s], lo[s]);"
ATTENTION = "    attention_any(qs, ks, vs, S, nvalid);"
LO_COPY = "    bulk_load(dst + kSlotBytes, lo + off, n, bar);"
EXPECT = ("    mbar_expect_tx(bar, 2 * n);", "    mbar_expect_tx(bar, n);")
SHAPES = {"blocks_1": (16384, 9, 256), "fusion": (4096, 36, 256)}


def variants(src: str) -> dict:
    for snippet in (MMA, SPLIT, ATTENTION, LO_COPY, EXPECT[0]):
        if snippet not in src:
            raise RuntimeError(f"variant text not in the source: {snippet[:60]!r}")
    hionly = src.replace(EXPECT[0], EXPECT[1]).replace(LO_COPY, "")
    return {"base": src, "nomma": src.replace(MMA, ""), "nosplit": src.replace(SPLIT, ""),
            "nomma_nosplit": src.replace(MMA, "").replace(SPLIT, ""),
            "noattn": src.replace(ATTENTION, ""), "hionly": hionly}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ablate_fused_block: needs a CUDA card", file=sys.stderr)
        return 1
    from hsimae_tpu_torch.ops import _build
    from hsimae_tpu_torch.ops import fused_block as fb

    from chip_smoke import random_block, time_ms

    tmp = Path(tempfile.mkdtemp(prefix="ablate_"))
    procs = {}
    for name, src in variants(SOURCE.read_text()).items():
        (tmp / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entry = "hsimae_fused_block_tf32x3_d256"
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        ptxas = [line.strip() for line in log.splitlines() if "spill" in line or "Used " in line]
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        fn = getattr(ctypes.CDLL(str(tmp / f"{name}.so")), entry)
        fn.restype, fn.argtypes = _build.SIGNATURES["fused_block_tf32x3_d256"][entry]
        fns[name] = fn
    gen = torch.Generator().manual_seed(0)
    p = random_block(256, 684, gen, "cuda")
    pack = fb.pack_block_tf32_d256(p)
    hp = fb.padded_hidden(684, fb.TF32_HIDDEN_MULTIPLE)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (m, s, d) in SHAPES.items():
        x = torch.randn(m, s, d, generator=gen).cuda()
        ref = fb.block_reference(x, p, d // 16)
        out = torch.empty_like(x)
        for name, fn in fns.items():
            def run():
                rc = fn(x.data_ptr(), out.data_ptr(), pack.hi.data_ptr(), pack.lo.data_ptr(),
                        pack.vecs.data_ptr(), m, s, d, hp, d // 16, stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name} launch failed: cudaError_t {rc}")

            ms = time_ms(run, iters=10)
            run()
            torch.cuda.synchronize()
            err = ((out - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
            print(json.dumps({"variant": name, "block": label, "shape": [m, s, d], "ms": ms,
                              "scaled_err": err}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

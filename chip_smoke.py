#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hsimae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of a fixed size; any failure exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles every ``hsimae_tpu_torch/ops/csrc/*.cu`` with nvcc;
3. kernel against plain version: the fused-block kernel and
   ``block_reference`` on the same seeded inputs, f32 and bf16, at the
   HSIMAE-B shapes (M cut to 4096) plus D=64 and D=256; then, at the full
   batch-4096 shapes the main path gives the kernel, both compared again and
   timed with CUDA events, one JSON line per case;
4. main path: ``hsimae_tpu_torch.cli.evaluate.main`` classifies a 145x145x200
   synthetic scene (GWPCA to 32 bands) with HSIMAE-B, seeded random weights,
   f32, batch 4096. The kernel's launch count must be 21 per batch, and the
   prediction map must agree with the same run through the plain PyTorch
   Block modules (``use_kernel=False``) on >= 99.9% of pixels;
5. a ``kernels`` JSON line, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Published dense peaks of an H100 SXM (NVIDIA data sheet) at its 700 W limit.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 without tensor cores
HBM_BYTES_PER_S = 3.35e12

# HSIMAE-B: D 128, 8 heads, SwiGLU hidden 344; [M, S] per block stack at batch 4096
D_B, HEADS_B, HID_B = 128, 8, 344
BATCH = 4096
MAIN_SHAPES = {  # name: ([M, S, D], blocks per batch)
    "blocks_1": ((BATCH * 4, 9, D_B), 9),
    "blocks_2": ((BATCH * 9, 4, D_B), 9),
    "blocks": ((BATCH, 36, D_B), 3),
}
CHECK_SHAPES = [  # (M, S, D, hidden); M cut to 4096 rows
    (4096, 9, 128, 344), (4096, 4, 128, 344), (4096, 36, 128, 344),
    (4096, 9, 64, 172), (4096, 36, 256, 684),
]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}  # |kernel - ref| <= tol * max(1, |ref|)

MAIN_ARGV = ["--synthetic", "--synthetic-size", "145", "--synthetic-bands", "200",
             "--synthetic-classes", "16", "--num-classes", "17", "--no-bf16",
             "--batch-size", str(BATCH), "--device", "cuda"]
MIN_AGREEMENT = 0.999


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def random_block(d: int, hid: int, gen, device):
    """Seeded float32 block weights at unit-gain scale (1/sqrt(fan_in))."""
    import torch
    from hsimae_tpu_torch.ops.fused_block import BlockParams

    def w(i, o):
        return torch.randn(i, o, generator=gen) / math.sqrt(i)

    def vec(n, base=0.0):
        return base + 0.1 * torch.randn(n, generator=gen)

    p = BlockParams(vec(d, 1.0), vec(d), w(d, d), vec(d), w(d, d), vec(d), w(d, d), vec(d),
                    w(d, d), vec(d), vec(d, 1.0), vec(d), w(d, hid), vec(hid), w(d, hid),
                    vec(hid), w(hid, d), vec(d))
    return BlockParams(*(t.to(device) for t in p))


def block_cost(m: int, s: int, d: int, hid: int, esize: int):
    """(FLOPs, bytes) one block needs: the seven products and the two
    attention products; x read once, the output written once, f32 weights
    read once."""
    flops = 2 * m * s * (4 * d * d + 3 * d * hid) + 4 * m * s * s * d
    weights = 4 * (4 * d * d + 3 * d * hid + 6 * d + 2 * hid)
    return flops, 2 * m * s * d * esize + weights


def compare(got, ref, dname: str, what: dict) -> float:
    """Print one check line; fail unless |got - ref| <= tol * max(1, |ref|)
    everywhere. Returns the max absolute error."""
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        fail(f"non-finite kernel output at {what}")
    err = (got - ref).abs()
    worst = (err / ref.abs().clamp(min=1.0)).max().item()
    ok = worst <= TOL[dname]
    print(json.dumps({"check": "fused_block", **what, "max_abs_err": err.max().item(),
                      "max_scaled_err": worst, "tol": TOL[dname], "ok": ok}), flush=True)
    if not ok:
        fail(f"kernel disagrees with block_reference at {what}: {worst}")
    return err.max().item()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1

    from hsimae_tpu_torch.cli import evaluate as cli_evaluate
    from hsimae_tpu_torch.config import EvalConfig
    from hsimae_tpu_torch.ops import _build
    from hsimae_tpu_torch.ops import fused_block as fb
    from hsimae_tpu_torch.train.evaluate import build_classifier, predict_scene

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}", flush=True)

    # ---- 2. build ----
    print(f"build: fused_block {_build.build('fused_block'):.2f} s (0.00: already built)",
          flush=True)
    for line in _build.build_log("fused_block").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel against plain version ----
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for m, s, d, hid in CHECK_SHAPES:
            p = random_block(d, hid, gen, dev)
            x = torch.randn(m, s, d, generator=gen).to(dev, dtype)
            err = compare(fb.fused_encoder_block(x, p, d // 16), fb.block_reference(x, p, d // 16),
                          dname, {"shape": [m, s, d], "dtype": dname})
            max_err[dname] = max(max_err[dname], err)

    per_batch = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_kinds = set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for name, ((m, s, d), count) in MAIN_SHAPES.items():
            p = random_block(d, HID_B, gen, dev)
            x = torch.randn(m, s, d, generator=gen).to(dev, dtype)
            err = compare(fb.fused_encoder_block(x, p, HEADS_B), fb.block_reference(x, p, HEADS_B),
                          dname, {"block": name, "shape": [m, s, d], "dtype": dname})
            max_err[dname] = max(max_err[dname], err)
            ms = time_ms(lambda: fb.fused_encoder_block(x, p, HEADS_B), iters=10)
            plain_ms = time_ms(lambda: fb.block_reference(x, p, HEADS_B), iters=5)
            flops, nbytes = block_cost(m, s, d, HID_B, x.element_size())
            t_ops, t_bytes = flops / PEAK_FLOPS[dname] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            print(json.dumps({"kernel": "fused_block", "block": name, "shape": [m, s, d],
                              "dtype": dname, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
                              "mbytes": nbytes / 1e6, "tflops": flops / ms / 1e9}), flush=True)
            if dtype == torch.float32:  # the main path's dtype
                per_batch["ms"] += count * ms
                per_batch["plain_ms"] += count * plain_ms
                per_batch["bound_ms"] += count * bound_ms
                bound_kinds.add(bound_by)
            del x, p
    torch.cuda.empty_cache()

    # ---- 4. main path ----
    args = cli_evaluate.build_parser().parse_args(MAIN_ARGV)
    fb.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cli_evaluate.main(MAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fb.LAUNCHES

    n_pix = args.synthetic_size ** 2
    n_batches = math.ceil(n_pix / args.batch_size)
    pred = res.pred_map
    if launches != 21 * n_batches:
        fail(f"kernel launched {launches} times on the main path, expected {21 * n_batches}")
    if pred.shape != (args.synthetic_size, args.synthetic_size) or pred.min() < 1 \
            or pred.max() >= args.num_classes:
        fail(f"bad prediction map: shape {pred.shape}, labels {pred.min()}..{pred.max()}")
    m = res.metrics
    if not all(math.isfinite(v) for v in (m.oa, m.aa, m.kappa)):
        fail("non-finite metrics")

    scene, _, mcfg = cli_evaluate.prepare(args)
    ecfg = EvalConfig(batch_size=args.batch_size)

    def run(use_kernel: bool):
        """The scene through a model built once: (map, warm predict seconds)."""
        model = build_classifier(None, mcfg.replace(use_kernel=use_kernel), args.num_classes,
                                 device="cuda", seed=args.seed)
        predict_scene(model, scene, ecfg)  # first call: the kernel layout of the weights
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict_scene(model, scene, ecfg)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    plain_map, plain_s = run(False)
    kernel_map, kernel_s = run(True)
    agree = float((plain_map == pred).mean())
    print(json.dumps({"main_path": "cli.evaluate", "pixels": n_pix, "batches": n_batches,
                      "launches": launches, "wall_s": wall, "pixels_per_s": n_pix / wall,
                      "warm_predict_kernel_s": kernel_s, "warm_predict_plain_s": plain_s,
                      "warm_kernel_pixels_per_s": n_pix / kernel_s,
                      "warm_plain_pixels_per_s": n_pix / plain_s,
                      "agreement_with_plain": agree,
                      "repeat_equal": bool((kernel_map == pred).all())}), flush=True)
    if agree < MIN_AGREEMENT:
        fail(f"prediction map agrees with the plain run on {agree:.5f} of pixels (< {MIN_AGREEMENT})")

    # ---- 5. result ----
    print(json.dumps({"kernels": [{
        "name": "fused_block", "route": "cuda",
        "source": "hsimae_tpu_torch/ops/csrc/fused_block.cu",
        "replaces": "hsimae_tpu/ops/fused_block.py:158",
        "launches": launches, "max_abs_err": max_err["float32"],
        "ms": per_batch["ms"], "plain_ms": per_batch["plain_ms"],
        "bound_ms": per_batch["bound_ms"],
        "bound_by": "operations" if bound_kinds == {"operations"} else "bytes",
        "library_ms": None,
    }]}))
    print(f"nvidia-smi: {smi_line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

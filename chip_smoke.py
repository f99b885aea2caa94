#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hsimae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of a fixed size; any failure exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles every ``hsimae_tpu_torch/ops/csrc/*.cu`` with nvcc, one
   process per source, all at once, and prints ptxas's register lines;
3. kernels against plain version: the fused-block kernels and
   ``block_reference`` on the same seeded inputs, each route with the
   weights ``kernel_weights`` gives it: float32 at D 64 and 128 on the
   3xTF32 wgmma kernel (TF32 hi/lo pack), float32 at D 256 on the 3xTF32
   D 256 kernel (its own hi/lo pack), bfloat16 on the bf16 wgmma kernel
   (bf16 pack), at the HSIMAE-B shapes (M cut to 4096) plus D=64 and D=256
   (float32 at D 256 also at S 64, the longest, and at an M whose last row
   tile is partly filled); then, at the
   full batch-4096 shapes the main paths give the kernels (HSIMAE-B and
   HSIMAE-L, both dtypes), compared again and timed with CUDA events beside
   the plain version and the port's Block modules (cuBLAS products), one
   JSON line per case, each read against the bound of the arithmetic the
   kernel does (three TF32 products per float32 product for the float32
   kernels, bf16 products for the bf16 one) and of the bytes it moves;
4. main path, float32: ``hsimae_tpu_torch.cli.evaluate.main`` classifies a
   145x145x200 synthetic scene (GWPCA to 32 bands) with HSIMAE-B, seeded
   random weights, batch 4096. The 3xTF32 kernel must launch 21 times per
   batch (the other kernels never), and the prediction map must agree with
   the same run through the plain PyTorch Block modules
   (``use_kernel=False``) on >= 99.9% of pixels;
5. main path, bfloat16 (the CLI's default dtype): the same scene; the bf16
   wgmma kernel must launch 21 times per batch (the others never), and the
   map must agree on >= 99.9% of pixels with the same bf16 model whose
   blocks all run ``block_reference`` (the kernel's own semantics);
6. warm batch loops (model built once): kernel against Block modules, in
   both dtypes;
11. main path at HSIMAE-L's width (D 256, 16 heads, SwiGLU 684, depth 12,
   s_depth 9), full width and depth: phases 4-6 again with ``--model
   HSIMAE-L`` on the same scene: float32 on the 3xTF32 D 256 kernel (21
   launches a batch, the others never; map against the Block modules),
   bfloat16 on the wgmma kernel (21 a batch; map against
   ``block_reference``), warm loops and ``max_memory_allocated``;
8. pretrain steps, card against CPU: three float32 HSIMAE-B steps (batch
   64, one seeded init, injected draws on both kept grids) on the card and
   the same three on the CPU; each loss within 1e-4 relative, the final
   parameters within ``1e-4 * max(1, |p|)``;
9. pretraining through ``hsimae_tpu_torch.cli.pretrain``, bf16 (bench.py's
   setting: HSIMAE-B, batch 2048, mask ratio 0.5) on 24 synthetic scenes of
   72-144 px at 200 bands cut to 32 by GWPCA: two epochs (finite losses,
   the second below the first; warm patches/s of epoch 2 and peak memory
   printed), then a run stopped after epoch 1 and resumed, whose epoch-2
   loss must equal the uninterrupted run's within 1e-3 relative; f. the same
   with the background checkpoint writer (``--ckpt-backend orbax
   --ckpt-max-keep 2``): a run stopped after epoch 1 and resumed by the CLI
   (epoch-2 loss within 1e-3, exactly 2 checkpoints left), then a fresh
   two-epoch run with ``--profile`` (one trace, of epoch 2); the step loop's
   stall per checkpoint, synchronous against background; then one float32
   epoch; training launches no block kernel;
10. the kernel on the masked encoder: eval-mode ``forward_pretrain`` at
   batch 2048 on the kept grids (2, 9) and (3, 6), in both dtypes: 21
   launches a call of the dtype's kernel and none of the others; latent,
   pred and loss against the Block modules (float32: latent scaled error
   2e-5) or every block as ``block_reference`` (bfloat16: 5e-2); each new
   launch shape checked and timed like phase 3;
12. fine-tuning (HSIMAE-B, the reference recipe on the phase-4 scene: 10
   labeled pixels a class, 80 train and 80 val): a. the kernels at the
   validation pass's launch shapes (a val batch of 80, and a full one of
   512), both dtypes, checked and timed like phase 3; b. three float32 dual
   steps (labeled 32 with a padded tail, unlabeled 43, mask ratio 0.8,
   lambda 10, drop-path 0.2, injected draws on both kept grids) on the card
   against the same three on the CPU, held like phase 8; c. the chain
   pretrain -> fine-tune -> full-scene eval through
   ``hsimae_tpu_torch.cli.finetune`` from phase 9's bf16 ``params_final.pt``,
   bf16, 200 epochs, ``--eval``: finite losses, no kernel launch in the dual
   steps, 21 launches of the bf16 kernel per val batch and 126 in
   ``--eval`` (the others never), the ``--eval`` map against the same
   weights with every block as ``block_reference`` on >= 99.9% of pixels;
   d. the same run in float32 for 20 epochs on ``fused_block_tf32x3`` only,
   the map against the Block modules. The runs' per-epoch logs go to
   ``chiprun_out/smoke_finetune_*.log``; the numbers are a synthetic
   scene's, not the paper's;
13. the paper's protocol (HSIMAE-B, bf16, the phase-4 scene, from phase 9's
   bf16 ``params_final.pt``): a. ``hsimae_tpu_torch.cli.finetune
   --protocol`` with the lr grid cut to (1e-3, 1e-4), 1 selection seed and
   2 test seeds, 20 epochs a run (cut from 4 lrs x 3 seeds + 5 seeds and
   200 epochs to fit the time limit): 4 fine-tunes, 21 launches of the
   bf16 kernel a val batch and 126 a test run's scene evaluation, 1,932 in
   all and none of the others; 4 records with the JAX package's keys in
   ``protocol_runs.jsonl``, ``best_lr`` in the grid, finite OA/AA/kappa in
   [0, 100]; ``memory_allocated`` may not grow by more than 64 MB across
   the protocol; b. the workdir copied, its record file cut to 3 records
   and a torn line, and the same command again: exactly one fine-tune (546
   launches), the 3 records kept byte for byte, the same ``best_lr``, the
   re-run seed's metrics within 1 point of 13a's; c. the last test run's
   weights through ``cli.evaluate --samples-per-class 10 --seed <its seed>
   --out``: the scored pixels are the labeled ones less the 160 drawn for
   training (the protocol's own test split), both PNGs decode to the
   palette's colours of the map, and the map agrees with
   ``block_reference``'s on >= 99.9% of pixels. Logs and PNGs go to
   ``chiprun_out/smoke_protocol*``;
14. serving (HSIMAE-B, from phase 13's last test run's weights, so the
   chain pretrain -> fine-tune -> export -> serve runs on the card): a. the
   kernels at the launch shapes of batch buckets 1, 64 and 1024, both dtypes,
   checked and timed like phase 3; b. ``hsimae_tpu_torch.cli.export`` in four
   variants (float32; ``--params-dtype bfloat16`` with bf16 compute; ``--quantize
   int8``; int8 with bfloat16), buckets 1, 64, 1024, platforms cpu and cuda;
   the int8 artifact under 0.6x the float32 one's bytes; c. each artifact
   loaded in a fresh process where ``hsimae_tpu_torch.models`` cannot be
   imported and asked for n = 1, 63, 64, 65, 1024 and 1500 patches: 21
   launches of the route's kernel a program call (1500: two calls), none of
   the others, no kernel pack built in a request, logits within the kernel's
   tolerance of the live model on the same (dequantized) weights; d.
   ``cli.evaluate --artifact`` on the phase-4 scene: exactly 504 launches of
   the route's kernel (6 gathers of 4096, 4 calls of bucket 1024, 21 a call),
   the map against ``cli.evaluate --params`` on the same weights on >= 99.9%
   of pixels; the int8 map's agreement with the float32 map is printed (not
   a gate); e. warm pixels/s through the artifact against ``predict_scene``,
   one ``predict_logits`` of 1024 in ms, peak memory;
15. data parallelism (HSIMAE-B). The script needs one card and NCCL refuses
   two ranks on one device, so 2 ranks share cuda:0 over gloo, in jobs of
   ``python3 -m torch.distributed.run ... chip_smoke.py --rank-job ...``:
   a/b. phase 8's three float32 pretrain steps (batch 64, the last 3 rows
   padding) and phase 12b's three dual steps (unlabeled 43 wrapped to 44)
   on 2 ranks against one process on the card, held like phase 8;
   c. ``cli.pretrain`` (phase 9's bf16 setting) on 2 ranks: two epochs,
   then a run stopped after epoch 1 and resumed (epoch-2 loss within 1e-3),
   epoch 1 within 1e-2 of phase 9's one process, the workdirs holding one
   writer's files; global patches/s printed (two ranks on one card: not a
   speed claim); d. the same CLI's parts at one rank over NCCL, epoch 1
   within 1e-3 of phase 9's; e. ``cli.evaluate --dp 2`` on the phase-4
   scene in both dtypes: each rank 126 launches of the dtype's kernel and
   none of the others, the map against phases 4/5 on >= 99.9% of pixels;
   f. ``cli.finetune`` on 2 ranks (bf16, 20 epochs, ``--eval``, from phase
   9's ``params_final.pt``): no launch in a dual step, 21 a val batch
   share, 126 a rank in ``--eval``, the map against ``block_reference`` on
   the same weights on >= 99.9% of pixels. Logs in
   ``chiprun_out/smoke_dp*.log`` and ``smoke_nccl.log``;
16. the baseline zoo (``hsimae_tpu_torch.models.baselines``, the bench
   harness and ``cli.benchmark``; plain PyTorch ops, no kernel of ours):
   a. each of the ten nets at its registry widths (PaviaU: 103 bands, 10
   classes; SSFTT on 30 PCA bands at patch 13), seeded weights and
   BatchNorm statistics, eval logits of a batch of 16 on the card against
   the CPU (float32, 1e-4 scaled); b. one harness train step of each net
   (batch 32, the last 3 rows padding, flips and dropout masks injected, the
   spec's optimizer at rate 1e-3) on the card against the CPU: the loss
   within 1e-4; every gradient tensor against float64 on the CPU, scaled by
   its largest float64 gradient (at least 1e-3 of the net's largest), the
   card's miss within 1e-4 or within 10 times the CPU's float32 miss, no
   element left out; the parameters after the step against the CPU's
   optimizer run on the card's gradients, the BatchNorm buffers against the
   CPU's step, within 1e-4 scaled. The CPU's steps take the card's
   max-pool routing (DCTN; rounding can flip a near-tie), each routed
   element within 1e-4 of its float64 window's maximum; c.
   ``hsimae_tpu_torch.cli.benchmark.main`` on the phase-4 scene (145x145x200,
   16 classes), all ten nets, 10 samples a class, lr grid 1e-3, 1 selection
   seed, 2 test seeds, 20 epochs: its report keys and OA; then one 10-epoch
   ``train_baseline`` and one ``evaluate_baseline`` of each net on that
   scene, outside the CLI: the train-step ms (epochs 1-9), the full-scene
   pixels/s, every logit of the scene finite; 0 fused-block launches over
   the CLI run and these;
7. (last) a ``kernels`` JSON line, with each kernel's launches on each path
   (counts set to 0 just before the path), the card's name and power limit,
   then ``{"ok": true, "device": {...}}``.

Phases run in the order 1-6, 11, 8-10, 12, 13, 14, 15, 16, 7.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

# Published dense peaks of an H100 SXM (NVIDIA data sheet) at its 700 W limit.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12  # the float32 kernels do three TF32 products per f32 product
HBM_BYTES_PER_S = 3.35e12

# HSIMAE-B: D 128, 8 heads, SwiGLU hidden 344; HSIMAE-L: D 256, 16 heads, 684
D_B, HEADS_B, HID_B = 128, 8, 344
HIDDEN = {64: 172, D_B: HID_B, 256: 684}  # SwiGLU hidden width by model width
BATCH = 4096


def main_shapes(d: int) -> dict:
    """name: ([M, S, D], blocks per batch) of the encoder stacks at batch 4096."""
    return {"blocks_1": ((BATCH * 4, 9, d), 9), "blocks_2": ((BATCH * 9, 4, d), 9),
            "blocks": ((BATCH, 36, d), 3)}


MAIN_SHAPES = {"HSIMAE-B": main_shapes(D_B), "HSIMAE-L": main_shapes(256)}
CHECK_SHAPES = [  # (M, S, D, hidden); M cut to 4096 rows
    (4096, 9, 128, 344), (4096, 4, 128, 344), (4096, 36, 128, 344),
    (4096, 9, 64, 172), (4096, 36, 256, 684),
    (4093, 9, 256, 684),  # 585 row tiles of 7 sequences, the last holding 5
]
F32_CHECK_SHAPES = [(449, 64, 256, 684)]  # the longest S at D 256 (the bf16 kernel takes 40)
TOL = {"float32": 2e-5, "bfloat16": 5e-2}  # |kernel - ref| <= tol * max(1, |ref|)
# the kernels, by route (stream dtype and width): name -> (dtype, source, launch counter)
KERNELS = {
    "fused_block_tf32x3": ("float32", "hsimae_tpu_torch/ops/csrc/fused_block_tf32x3.cu",
                           "TF32X3_LAUNCHES"),
    "fused_block_tf32x3_d256": ("float32",
                                   "hsimae_tpu_torch/ops/csrc/fused_block_tf32x3_d256.cu",
                                   "TF32X3_D256_LAUNCHES"),
    "fused_block_wgmma": ("bfloat16", "hsimae_tpu_torch/ops/csrc/fused_block_wgmma.cu",
                          "WGMMA_LAUNCHES"),
}
TF32X3_KERNELS = ("fused_block_tf32x3", "fused_block_tf32x3_d256")  # read against 3xTF32
MAIN_KERNEL = {"float32": "fused_block_tf32x3", "bfloat16": "fused_block_wgmma"}  # HSIMAE-B
MAIN_KERNELS = {"HSIMAE-B": MAIN_KERNEL,
                "HSIMAE-L": {"float32": "fused_block_tf32x3_d256", "bfloat16": "fused_block_wgmma"}}

SCENE_ARGV = ["--synthetic", "--synthetic-size", "145", "--synthetic-bands", "200",
              "--synthetic-classes", "16", "--num-classes", "17",
              "--batch-size", str(BATCH), "--device", "cuda"]
MAIN_ARGV = {"float32": SCENE_ARGV + ["--no-bf16"], "bfloat16": SCENE_ARGV}
MIN_AGREEMENT = 0.999

# phase 8: float32 pretrain steps, card against CPU
STEP_BATCH, STEP_TOTAL = 64, 20
STEP_GRIDS = [(2, 9), (3, 6), (2, 9)]  # kept (len_t, len_l) per step, drawn and injected
STEP_LOSS_RTOL, STEP_PARAM_TOL = 1e-4, 1e-4  # param: |card - cpu| <= tol * max(1, |cpu|)
# phase 9: pretraining through the CLI (bench.py's setting: HSIMAE-B, bf16, batch 2048);
# 24 synthetic scenes of 72-144 px, all cut densely, ~29 k cuts, ~15 steps an epoch
PRETRAIN_BATCH = 2048
PRETRAIN_ARGV = ["--synthetic", "--synthetic-scenes", "24", "--synthetic-size", "145",
                 "--synthetic-bands", "200", "--coarse-from", "24", "--model", "HSIMAE-B",
                 "--batch-size", str(PRETRAIN_BATCH), "--mask-ratio", "0.5", "--epochs", "2",
                 "--seed", "0", "--device", "cuda"]
RESUME_RTOL = 1e-3
BG_KEEP = 2  # phase 9f: checkpoints the background writer keeps
# phase 10: the kernel at the masked encoder's shapes (mask ratio 0.5 on T 4 x L 9)
MASKED_GRIDS = [(2, 9), (3, 6)]
MASKED_SHAPES = {  # name: ([M, S, D], launches per call, grids)
    "blocks_1 (2,9)": ((PRETRAIN_BATCH * 2, 9, D_B), 9, [[2, 9]]),
    "blocks_2 (2,9)": ((PRETRAIN_BATCH * 9, 2, D_B), 9, [[2, 9]]),
    "blocks_1 (3,6)": ((PRETRAIN_BATCH * 3, 6, D_B), 9, [[3, 6]]),
    "blocks_2 (3,6)": ((PRETRAIN_BATCH * 6, 3, D_B), 9, [[3, 6]]),
    "fusion": ((PRETRAIN_BATCH, 18, D_B), 3, [[2, 9], [3, 6]]),
}
MASKED_TOL = {  # scaled error |x - ref| / max(1, |ref|); loss relative
    "float32": {"latent": 2e-5, "pred": 1e-4, "loss_rel": 1e-5},
    "bfloat16": {"latent": 5e-2, "pred": 5e-2, "loss_rel": 1e-2},
}

# phase 12: fine-tuning, the reference recipe on the phase-4 scene (16 classes, 10 labeled
# pixels a class: 80 train, 80 val). The val pass's launch shapes at its batch of 80, and at
# a full val batch of 512: name -> ([M, S, D], launches per val batch)
FT_VAL_SHAPES = {
    f"{name} val {b}": ((b * k, s, D_B), n) for b in (80, 512)
    for name, k, s, n in (("blocks_1", 4, 9, 9), ("blocks_2", 9, 4, 9), ("fusion", 1, 36, 3))}
DUAL_BATCH, DUAL_VALID, DUAL_UNLABELED = 32, 27, 43  # labeled 32, the last 5 padding
DUAL_GRIDS = [(2, 4), (4, 2), (2, 4)]  # the two kept grids of mask ratio 0.8 on T 4 x L 9
FT_CLASSES = 17  # the phase-4 scene's 16 classes and background
FINETUNE_ARGV = ["--synthetic", "--synthetic-size", "145", "--synthetic-bands", "200",
                 "--synthetic-classes", "16", "--synthetic-seed", "0", "--model", "HSIMAE-B",
                 "--samples-per-class", "10", "--batch-size", "32", "--mask-ratio", "0.8",
                 "--lamda", "10", "--lr", "1e-3", "--wd", "5e-3", "--drop-path", "0.2",
                 "--eval", "--device", "cuda"]
FINETUNE_EPOCHS = {"bfloat16": 200, "float32": 20}

# phase 13: the protocol on the phase-4 scene, cut to fit the time limit: 2 lrs x 1
# selection seed + 2 test seeds at 20 epochs (the paper's: 4 lrs x 3 seeds + 5 seeds, 200)
PROTOCOL_LRS, PROTOCOL_EPOCHS = (1e-3, 1e-4), 20
PROTOCOL_ARGV = [a for a in FINETUNE_ARGV if a != "--eval"] + [
    "--protocol", "--lr-grid", *map(str, PROTOCOL_LRS), "--selection-seeds", "1",
    "--test-seeds", "2", "--epochs", str(PROTOCOL_EPOCHS)]
PROTOCOL_RUNS = 4  # 2 selection runs, 2 test runs
PROTOCOL_LAUNCHES = 4 * 20 * 21 + 2 * 126  # val batches, then the test runs' scene batches
RESUME_LAUNCHES = 20 * 21 + 126  # the one test run left
PROTOCOL_RECORD_KEYS = {"select": {"stage", "lr", "seed", "spc", "val_mean3"},
                        "test": {"stage", "lr", "seed", "spc", "oa", "aa", "kappa", "per_class"}}
MAX_MEMORY_GROWTH = 64 << 20  # bytes left allocated on the card after the protocol
FULL_PROTOCOL = {"runs": 4 * 3 + 5, "test_runs": 5, "epochs": 200}  # the paper's recipe

# phase 14: serving. The artifact's launch shapes at bucket b: blocks_1 [4b, 9, D] (x9),
# blocks_2 [9b, 4, D] (x9), fusion [b, 36, D] (x3)
SERVE_BUCKETS = (1, 64, 1024)
SERVE_SHAPES = {f"{name} bucket {b}": ((b * k, s, D_B), n) for b in SERVE_BUCKETS
                for name, k, s, n in (("blocks_1", 4, 9, 9), ("blocks_2", 9, 4, 9),
                                      ("fusion", 1, 36, 3))}
SERVE_NS = (1, 63, 64, 65, 1024, 1500)  # requests: pads into 1, 64, 1024; 1500 takes 2 calls
# the exports of phase 13's last weights: name -> (cli.export flags, stream dtype)
SERVE_VARIANTS = {"f32": (["--no-bf16"], "float32"),
                  "bf16": (["--params-dtype", "bfloat16"], "bfloat16"),
                  "int8": (["--quantize", "int8", "--no-bf16"], "float32"),
                  "int8_bf16": (["--quantize", "int8", "--params-dtype", "bfloat16"], "bfloat16")}
MAX_INT8_SIZE = 0.6  # the int8 artifact's bytes over the f32 one's, as JAX's test holds

# phase 15: data parallelism. The script needs one card and NCCL refuses two ranks on one
# device, so 2 ranks share cuda:0 over gloo; NCCL runs at one rank
DP_RANKS = 2
DP_STEP_VALID = 61  # 15a: phase 8's global batch of 64, its last 3 rows padding (weight 0)
DP_UNLABELED = 44  # 15b: phase 12b's 43 unlabeled rows padded (wrapped) to a multiple of 2
DP_FINETUNE_EPOCHS = 20  # 15f
DP_SINGLE_RTOL = 1e-2  # 15c: epoch-1 loss against phase 9's single process, relative
DP_EVAL_LAUNCHES = 6 * 21  # 15e/f: 6 scene batches of 4096, 2048 rows a rank, 21 a batch
SCENE_LAUNCHES = 6 * 4 * 21  # 6 gathers of 4096, 4 calls of bucket 1024 each, 21 a call
# phase 16: the baseline zoo at its registry widths
ZOO_DATASET, ZOO_CLASSES = "PaviaU", 10
ZOO_EVAL_BATCH, ZOO_STEP_BATCH, ZOO_STEP_PAD, ZOO_LR = 16, 32, 3, 1e-3
ZOO_TOL = 1e-4  # logits, loss, parameters, buffers: |card - cpu| <= tol * max(1, |cpu|)
# gradients, against float64 on the CPU, each tensor scaled by its largest float64 gradient
# (at least ZOO_GRAD_FLOOR of the net's largest: a conv bias in front of a BatchNorm has true
# gradient 0): the card within ZOO_TOL, or within ZOO_GRAD_K times the CPU's float32 miss
ZOO_GRAD_FLOOR, ZOO_GRAD_K = 1e-3, 10.0
ZOO_ARGV = ["--synthetic", "--synthetic-size", "145", "--synthetic-bands", "200",
            "--synthetic-classes", "16", "--samples-per-class", "10", "--lr-grid", "1e-3",
            "--selection-seeds", "1", "--test-seeds", "2", "--epochs", "20",
            "--scene-seed", "0", "--device", "cuda"]  # phase 4's scene
ZOO_REPORT_KEYS = ["best_lr", "oa", "aa", "kappa", "per_seed_oa"]
ZOO_TIMED_EPOCHS = 10  # 16c's timed run of each net: 2 steps an epoch, epoch 0 not timed
# the serving child: loads an artifact where hsimae_tpu_torch.models cannot be imported,
# answers each request size, and prints one JSON line (launches, pack builds, timings)
SERVE_CHILD = """
import json, sys, time
import numpy as np


class NoModelSource:
    def find_spec(self, name, path=None, target=None):
        if name == "hsimae_tpu_torch.models" or name.startswith("hsimae_tpu_torch.models."):
            raise ImportError("the model source is not deployed")


sys.meta_path.insert(0, NoModelSource())
import torch
from hsimae_tpu_torch.ops import fused_block as fb
from hsimae_tpu_torch.serving import load_classifier

art, xs, out, ns = sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
names = ("TF32X3_LAUNCHES", "TF32X3_D256_LAUNCHES", "WGMMA_LAUNCHES")
t0 = time.perf_counter()
torch.cuda.init()
torch.empty(1, device="cuda")
cuda_init_s = time.perf_counter() - t0
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
clf = load_classifier(art, device="cuda")
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
builds = []
real = fb.kernel_weights
fb.kernel_weights = lambda *a: builds.append(1) or real(*a)
x_host = np.load(xs)
x = torch.from_numpy(x_host).cuda()
launches, logits = {}, {}
for n in ns:
    for c in names:
        setattr(fb, c, 0)
    y = clf.predict_logits(x_host[:n] if n == 63 else x[:n])  # numpy in, numpy out at 63
    torch.cuda.synchronize()
    launches[str(n)] = [getattr(fb, c) for c in names]
    if n == 63:
        numpy_out = isinstance(y, np.ndarray)
    logits[str(n)] = y if isinstance(y, np.ndarray) else y.cpu().numpy()
times = []
for i in range(23):
    torch.cuda.synchronize()
    t = time.perf_counter()
    clf.predict_logits(x[:1024])
    torch.cuda.synchronize()
    if i >= 3:
        times.append(time.perf_counter() - t)
np.savez(out, **logits)
print(json.dumps({"launches": launches, "pack_builds_in_requests": len(builds),
                  "models_imported": any(m.startswith("hsimae_tpu_torch.models")
                                         for m in sys.modules),
                  "cuda_init_s": cuda_init_s, "load_s": load_s,
                  "predict_1024_ms": 1e3 * sorted(times)[len(times) // 2],
                  "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                  "numpy_out_at_63": numpy_out}))
"""


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


def kernel_of(dname: str, d: int) -> str:
    """The kernel the wrapper launches for stream dtype ``dname`` at width d."""
    from hsimae_tpu_torch.ops.fused_block import TF32X3_D

    if dname == "bfloat16":
        return "fused_block_wgmma"
    return "fused_block_tf32x3" if d in TF32X3_D else "fused_block_tf32x3_d256"


def launch_counts(fb) -> dict:
    return {name: getattr(fb, counter) for name, (_, _, counter) in KERNELS.items()}


def reset_counts(fb) -> None:
    for _, _, counter in KERNELS.values():
        setattr(fb, counter, 0)


def weight_bytes(w) -> int:
    """Bytes of the weights the kernel reads: the f32 BlockParams, the bf16
    pack or the TF32 hi + lo pack (vectors included)."""
    if hasattr(w, "hi"):
        return 4 * (w.hi.numel() + w.lo.numel() + w.vecs.numel())
    if hasattr(w, "image"):
        return 2 * w.image.numel() + 4 * w.vecs.numel()
    return sum(t.numel() * 4 for t in w)


def block_cost(m: int, s: int, d: int, hid: int, esize: int, weight_bytes: int):
    """(FLOPs, bytes) one block needs: the seven products and the two
    attention products; x read once, the output written once, the kernel's
    weights (f32, or the bf16 pack) read once."""
    flops = 2 * m * s * (4 * d * d + 3 * d * hid) + 4 * m * s * s * d
    return flops, 2 * m * s * d * esize + weight_bytes


def block_module(p, heads: int, dtype):
    """The port's Block module (cuBLAS products, plain ops) holding ``p``."""
    import torch
    from hsimae_tpu_torch.models.layers import Block

    blk = Block(p.w1.shape[0], heads, 4.0, True, dtype)  # HSIMAE's mlp_ratio
    lin = {"attn.q": (p.wq, p.bq), "attn.k": (p.wk, p.bk), "attn.v": (p.wv, p.bv),
           "attn.proj": (p.wo, p.bo), "mlp.w1": (p.w1, p.b1), "mlp.w3": (p.w3, p.b3),
           "mlp.w2": (p.w2, p.b2)}
    with torch.no_grad():
        for name, (w, b) in lin.items():
            mod = blk.get_submodule(name)
            mod.weight.copy_(w.t())
            mod.bias.copy_(b)
        blk.norm1.weight.copy_(p.ln1_scale)
        blk.norm1.bias.copy_(p.ln1_bias)
        blk.norm2.weight.copy_(p.ln2_scale)
        blk.norm2.bias.copy_(p.ln2_bias)
    return blk.to(p.wq.device).eval()


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


def time_ms(fn, iters: int, rounds: int = 3, warmup: int = 2) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls (the host stays ahead, so launch gaps do not count),
    the median over ``rounds``."""
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


def bounds(kernel: str, m: int, s: int, d: int, hid: int, esize: int, w):
    """(bound_ms, bound_by, extra keys): the larger of the kernel's
    operations over the peak rate of the arithmetic it does (the float32
    kernels: three TF32 products per float32 product; the bf16 kernel: bf16
    products) and the bytes it must move (x, the output, its weight pack)
    over 3.35 TB/s."""
    flops, nbytes = block_cost(m, s, d, hid, esize, weight_bytes(w))
    t_ops = (3 * flops / PEAK_TF32 if kernel in TF32X3_KERNELS else flops / PEAK_BF16) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            {"gflop": flops / 1e9, "mbytes": nbytes / 1e6})


def l2_weight_mb(kernel: str, m: int, s: int, d: int, w):
    """Weight bytes a launch pulls from L2: the whole pack once per row tile."""
    rows = 64 if kernel in TF32X3_KERNELS or d > 128 else 128
    return -(-m // (rows // s)) * weight_bytes(w) / 1e6


def time_case(fb, dtype, dname: str, name: str, shape, gen, dev, **tags):
    """Check the route's kernel against ``block_reference`` on seeded
    weights and input of ``shape``, then time the kernel, the plain version
    and the port's Block module with CUDA events; prints and returns the
    row and the kernel's max absolute error."""
    import torch

    m, s, d = shape
    hid = HIDDEN[d]
    kernel = kernel_of(dname, d)
    p = random_block(d, hid, gen, dev)
    w = fb.kernel_weights(p, dtype)
    blk = block_module(p, d // 16, dtype)
    x = torch.randn(m, s, d, generator=gen).to(dev, dtype)
    err = compare(fb.fused_encoder_block(x, w, d // 16), fb.block_reference(x, p, d // 16),
                  dname, {"kernel": kernel, "block": name, "shape": [m, s, d], "dtype": dname,
                          **tags})
    with torch.inference_mode():
        ms = time_ms(lambda: fb.fused_encoder_block(x, w, d // 16), iters=10)
        plain_ms = time_ms(lambda: fb.block_reference(x, p, d // 16), iters=3)
        modules_ms = time_ms(lambda: blk(x), iters=5)
    bound_ms, bound_by, extra = bounds(kernel, m, s, d, hid, x.element_size(), w)
    row = {"kernel": kernel, "block": name, **tags, "shape": [m, s, d], "dtype": dname, "ms": ms,
           "plain_ms": plain_ms, "modules_ms": modules_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, **extra, "share_of_bound": bound_ms / ms,
           "tflops": extra["gflop"] / ms, "l2_weight_mb": l2_weight_mb(kernel, m, s, d, w)}
    print(json.dumps(row), flush=True)
    return row, err


def to_device(draws, dev):
    """A step's injected draws (flips, kept grid; no drop-path) on ``dev``."""
    from hsimae_tpu_torch.models.masking import GridMask
    from hsimae_tpu_torch.train.pretrain import PretrainDraws

    return PretrainDraws(tuple(f.to(dev) for f in draws.flips),
                         GridMask(*(t.to(dev) for t in draws.grid)), None)


def pretrain_step_card_vs_cpu(smi_line: str) -> dict:
    """Phase 8: three float32 HSIMAE-B pretrain steps on the card and the
    same three on the CPU, from one seeded init, one batch and injected
    draws (both kept grids); losses and final parameters must agree."""
    import torch
    from hsimae_tpu_torch.config import preset
    from hsimae_tpu_torch.models.hsimae import build_hsimae
    from hsimae_tpu_torch.train.optim import pretrain_optimizer
    from hsimae_tpu_torch.train.pretrain import draw_pretrain, make_pretrain_step

    cfg = preset("HSIMAE-B", compute_dtype=torch.float32)
    x = torch.rand(STEP_BATCH, cfg.img_size, cfg.img_size, cfg.bands,
                   generator=torch.Generator().manual_seed(7))
    probe = build_hsimae(cfg, device="cpu")
    gen = torch.Generator().manual_seed(8)
    draws = [draw_pretrain(probe, STEP_BATCH, lt, ll, gen, "cpu") for lt, ll in STEP_GRIDS]

    def run(device):
        model = build_hsimae(cfg, seed=0, device=device)
        opt, sched = pretrain_optimizer(model, 5e-3, 0.05, total_steps=STEP_TOTAL)
        step = make_pretrain_step(model, opt, sched)
        losses = [step(x.to(device), lt, ll, draws=to_device(d, device)).item()
                  for (lt, ll), d in zip(STEP_GRIDS, draws)]
        return losses, {k: v.detach().cpu() for k, v in model.named_parameters()}, sched

    t0 = time.perf_counter()
    card_losses, card_params, sched = run("cuda")
    t_card = time.perf_counter() - t0
    cpu_losses, cpu_params, _ = run("cpu")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    param_err = max(((card_params[k] - v).abs() / v.abs().clamp(min=1.0)).max().item()
                    for k, v in cpu_params.items())
    moved = max((card_params[k] - v).abs().max().item() for k, v in
                build_hsimae(cfg, seed=0, device="cpu").named_parameters())
    ok = loss_rel <= STEP_LOSS_RTOL and param_err <= STEP_PARAM_TOL
    row = {"phase": "pretrain_step_card_vs_cpu", "model": "HSIMAE-B", "dtype": "float32",
           "batch": STEP_BATCH, "grids": STEP_GRIDS, "lr": [sched(k) for k in range(3)],
           "card_losses": card_losses, "cpu_losses": cpu_losses, "max_loss_rel": loss_rel,
           "loss_rtol": STEP_LOSS_RTOL, "max_param_scaled_err": param_err,
           "param_tol": STEP_PARAM_TOL, "max_param_move": moved, "card_s": t_card,
           "card": smi_line, "ok": ok}
    print(json.dumps(row), flush=True)
    if not all(math.isfinite(v) for v in card_losses + cpu_losses) or not ok:
        fail(f"pretrain steps on the card disagree with the CPU: {row}")
    return row


def cli_pretrain(smi_line: str, fb, workdir: Path) -> dict:
    """Phase 9: HSIMAE-B pretraining through ``hsimae_tpu_torch.cli.pretrain``
    on the card. bf16: two epochs (a checkpoint each epoch), then a run
    stopped after epoch 1 and resumed, whose epoch-2 loss must equal the
    uninterrupted run's; then one float32 epoch. Training launches no
    kernel (the Block modules run under autograd). The workdirs stay for
    phase 12, which fine-tunes ``bf16/params_final.pt``."""
    import torch
    from hsimae_tpu_torch.cli import pretrain as cli
    from hsimae_tpu_torch.train.pretrain import run_pretraining

    shutil.rmtree(workdir, ignore_errors=True)
    source, index, _, _ = cli.prepare(cli.build_parser().parse_args(PRETRAIN_ARGV))
    n_cuts = len(index)
    spe = math.ceil(n_cuts / PRETRAIN_BATCH)
    del source
    argv = PRETRAIN_ARGV + ["--checkpoint-every", str(spe)]

    def run(tag, extra):
        reset_counts(fb)
        torch.cuda.reset_peak_memory_stats()
        _, hist = cli.main(argv + ["--workdir", str(workdir / tag)] + extra)
        torch.cuda.synchronize()
        counts = launch_counts(fb)
        if any(counts.values()):
            fail(f"the pretrain step launched a block kernel: {counts}")
        return hist, torch.cuda.max_memory_allocated()

    hist, peak = run("bf16", [])
    losses = hist["epoch_loss"]
    row = {"main_path": "cli.pretrain", "model": "HSIMAE-B", "dtype": "bfloat16",
           "batch": PRETRAIN_BATCH, "cuts": n_cuts, "steps_per_epoch": spe,
           "epoch_loss": losses, "patches_per_sec": hist["patches_per_sec"],
           "hsimae_b_pretrain_patches_per_sec_per_chip": hist["patches_per_sec"][1],
           "max_memory_allocated_bytes": peak, "kernel_launches": 0, "card": smi_line}
    print(json.dumps(row), flush=True)
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses) or not losses[1] < losses[0]:
        fail(f"bf16 pretraining epoch losses not finite and falling: {losses}")

    # preemption after epoch 1 (same schedule), then the CLI resumes
    args = cli.build_parser().parse_args(argv + ["--workdir", str(workdir / "resumed")])
    source, index, mcfg, pcfg = cli.prepare(args)
    run_pretraining(source, index.locs, mcfg, pcfg, workdir=args.workdir, resume=False,
                    stop_after_epochs=1, device="cuda")
    del source
    resumed, _ = run("resumed", [])
    rel = abs(resumed["epoch_loss"][0] - losses[1]) / abs(losses[1])
    row_r = {"check": "resume", "dtype": "bfloat16", "uninterrupted_epoch_2": losses[1],
             "resumed_epoch_2": resumed["epoch_loss"], "rel": rel, "rtol": RESUME_RTOL,
             "card": smi_line, "ok": len(resumed["epoch_loss"]) == 1 and rel <= RESUME_RTOL}
    print(json.dumps(row_r), flush=True)
    if not row_r["ok"]:
        fail(f"resumed run disagrees with the uninterrupted one: {row_r}")

    # 9f. the background writer with retention: a run stopped after epoch 1, resumed by the
    # CLI; then a fresh two-epoch run with --profile (the trace is of its second epoch)
    from hsimae_tpu_torch.checkpoints.async_io import checkpoint_steps

    bg = ["--ckpt-backend", "orbax", "--ckpt-max-keep", str(BG_KEEP)]
    args = cli.build_parser().parse_args(argv + bg + ["--workdir", str(workdir / "bg")])
    source, index, mcfg, pcfg = cli.prepare(args)
    _, stopped = run_pretraining(source, index.locs, mcfg, pcfg, workdir=args.workdir,
                                 resume=False, stop_after_epochs=1, device="cuda")
    del source
    resumed_bg, _ = run("bg", bg)
    kept = checkpoint_steps(str(workdir / "bg"))
    rel_bg = abs(resumed_bg["epoch_loss"][0] - losses[1]) / abs(losses[1])
    prof_dir = workdir / "profile"
    t0 = time.perf_counter()
    profiled, _ = run("bg_profiled", bg + ["--profile", str(prof_dir)])
    profiled_s = time.perf_counter() - t0
    traces = sorted(p.name for p in prof_dir.iterdir())
    sync_ms = [1e3 * t for t in hist["checkpoint_seconds"] + resumed["checkpoint_seconds"]]
    bg_ms = [1e3 * t for t in stopped["checkpoint_seconds"] + resumed_bg["checkpoint_seconds"]]
    row_bg = {"check": "background checkpoints", "dtype": "bfloat16", "max_keep": BG_KEEP,
              "kept_steps": kept, "uninterrupted_epoch_2": losses[1],
              "resumed_epoch_2": resumed_bg["epoch_loss"], "rel": rel_bg, "rtol": RESUME_RTOL,
              "stall_ms_sync": sync_ms, "stall_ms_background": bg_ms,
              "profile_traces": traces,
              "profile_trace_bytes": sum(p.stat().st_size for p in prof_dir.iterdir()),
              "profiled_run_s": profiled_s, "profiled_epoch_loss": profiled["epoch_loss"],
              "card": smi_line}
    print(json.dumps(row_bg), flush=True)
    if kept != [spe, 2 * spe] or len(resumed_bg["epoch_loss"]) != 1 or rel_bg > RESUME_RTOL:
        fail(f"the background-checkpoint resume is wrong: {row_bg}")
    if traces != ["epoch_1.trace.json"]:
        fail(f"--profile wrote {traces}, expected the second epoch's trace only")

    f32, peak32 = run("f32", ["--no-bf16", "--epochs", "1"])
    row32 = {"main_path": "cli.pretrain", "model": "HSIMAE-B", "dtype": "float32",
             "batch": PRETRAIN_BATCH, "epoch_loss": f32["epoch_loss"],
             "patches_per_sec_epoch_1": f32["patches_per_sec"][0],
             "max_memory_allocated_bytes": peak32, "card": smi_line}
    print(json.dumps(row32), flush=True)
    if not all(math.isfinite(v) for v in f32["epoch_loss"]):
        fail(f"float32 pretraining loss not finite: {f32['epoch_loss']}")
    return row


def masked_encoder_kernel(smi_line: str, fb, hsimae_model, gen, max_err: dict) -> dict:
    """Phase 10: eval-mode ``forward_pretrain`` of HSIMAE-B at batch 2048 on
    both kept grids, both dtypes: 21 launches a call of the dtype's kernel
    and none of the others; loss, pred and latent against the same model
    run through the Block modules (float32) or with every block as
    ``block_reference`` (bfloat16); then each new launch shape checked and
    timed (its error raises ``max_err``). Returns the launches per kernel."""
    import torch
    from hsimae_tpu_torch.config import preset
    from hsimae_tpu_torch.models.masking import spatial_spectral_mask

    launches = dict.fromkeys(KERNELS, 0)
    x = torch.rand(PRETRAIN_BATCH, 9, 9, 32, generator=torch.Generator().manual_seed(11)).cuda()
    for dtype, dname in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        cfg = preset("HSIMAE-B", compute_dtype=dtype)
        model = hsimae_model.build_hsimae(cfg, seed=0, device="cuda").eval()
        ref = model if dname == "bfloat16" else hsimae_model.build_hsimae(
            cfg.replace(use_kernel=False), seed=0, device="cuda").eval()
        own = MAIN_KERNEL[dname]
        for lt, ll in MASKED_GRIDS:
            grid = spatial_spectral_mask(PRETRAIN_BATCH, cfg.t_size, cfg.l_size, lt, ll,
                                         torch.Generator(device="cuda").manual_seed(lt), "cuda")
            with torch.inference_mode():
                reset_counts(fb)
                loss, pred, _, _ = model.forward_pretrain(x, lt, ll, grid=grid)
                torch.cuda.synchronize()
                counts = launch_counts(fb)
                latent = model.encode_masked(x, lt, ll, grid=grid)[0]
                orig = hsimae_model.fused_encoder_block
                if dname == "bfloat16":  # every block as block_reference, nothing else changed
                    hsimae_model.fused_encoder_block = lambda h, w, nh: fb.block_reference(
                        h, w if isinstance(w, fb.BlockParams) else w.params, nh)
                try:
                    rloss, rpred, _, _ = ref.forward_pretrain(x, lt, ll, grid=grid)
                    rlatent = ref.encode_masked(x, lt, ll, grid=grid)[0]
                finally:
                    hsimae_model.fused_encoder_block = orig
            if counts != {k: 21 * (k == own) for k in KERNELS}:
                fail(f"{dname} masked encoder at grid ({lt}, {ll}) launched {counts}, "
                     f"expected 21 of {own} only")
            launches[own] += counts[own]

            def scaled(a, b):
                return ((a.float() - b.float()).abs() / b.float().abs().clamp(min=1.0)).max().item()

            errs = {"latent": scaled(latent, rlatent), "pred": scaled(pred, rpred),
                    "loss_rel": abs(loss.item() - rloss.item()) / abs(rloss.item())}
            tol = MASKED_TOL[dname]
            ok = all(errs[k] <= tol[k] for k in tol) and math.isfinite(loss.item())
            print(json.dumps({"check": "forward_pretrain_eval", "dtype": dname, "grid": [lt, ll],
                              "batch": PRETRAIN_BATCH, "launches": counts[own],
                              "reference": "block_modules" if dname == "float32"
                              else "block_reference", **errs, "tol": tol, "card": smi_line,
                              "ok": ok}), flush=True)
            if not ok:
                fail(f"{dname} masked encoder at grid ({lt}, {ll}) disagrees: {errs}")
        del model, ref
        torch.cuda.empty_cache()
        for name, (shape, count, grids) in MASKED_SHAPES.items():
            row, err = time_case(fb, dtype, dname, name, shape, gen, torch.device("cuda"),
                                 grids=grids, launches_per_call=count)
            max_err[row["kernel"]] = max(max_err[row["kernel"]], err)
    return launches


def keep_to(keep, dev):
    """Drop-path keep masks (per stack, per block, a pair or None) on ``dev``."""
    if keep is None:
        return None
    return {k: [None if p is None else tuple(t.to(dev) for t in p) for p in v]
            for k, v in keep.items()}


def dual_draws_to(d, dev):
    """A dual step's injected draws on ``dev``."""
    from hsimae_tpu_torch.models.masking import GridMask
    from hsimae_tpu_torch.train.finetune import DualDraws

    return DualDraws(tuple(f.to(dev) for f in d.flips), tuple(f.to(dev) for f in d.flips_u),
                     GridMask(*(t.to(dev) for t in d.grid)), keep_to(d.drop_keep_cls, dev),
                     keep_to(d.drop_keep_rec, dev))


def dual_step_card_vs_cpu(smi_line: str, fb) -> dict:
    """Phase 12b: three float32 HSIMAE-B dual steps on the card and the same
    three on the CPU, from one seeded init, one labeled batch with a padded
    tail, one unlabeled batch and injected draws (flips, both kept grids,
    drop-path masks of both encodes); each loss and every final parameter
    must agree, and the card's steps launch no block kernel."""
    import torch
    from hsimae_tpu_torch.config import preset
    from hsimae_tpu_torch.models.hsimae import build_dual_vit
    from hsimae_tpu_torch.train.finetune import draw_dual, make_dual_step
    from hsimae_tpu_torch.train.optim import finetune_optimizer

    cfg = preset("HSIMAE-B", compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(12)
    x = torch.rand(DUAL_BATCH, cfg.img_size, cfg.img_size, cfg.bands, generator=g)
    xu = torch.rand(DUAL_UNLABELED, cfg.img_size, cfg.img_size, cfg.bands, generator=g)
    y = torch.randint(1, FT_CLASSES, (DUAL_BATCH,), generator=g)
    w = torch.ones(DUAL_BATCH)
    y[DUAL_VALID:], w[DUAL_VALID:] = 0, 0.0
    probe = build_dual_vit(cfg, FT_CLASSES, device="cpu")
    draws = [draw_dual(probe, DUAL_BATCH, DUAL_UNLABELED, lt, ll, g, "cpu")
             for lt, ll in DUAL_GRIDS]

    def run(device):
        model = build_dual_vit(cfg, FT_CLASSES, seed=0, device=device)
        opt, sched = finetune_optimizer(model, 1e-3, 5e-3, epochs=len(DUAL_GRIDS),
                                        steps_per_epoch=1)
        step = make_dual_step(model, opt, sched, lamda=10.0)
        losses = []
        reset_counts(fb)
        for (lt, ll), d in zip(DUAL_GRIDS, draws):
            loss, rec, _ = step(x.to(device), y.to(device), w.to(device), xu.to(device),
                                lt, ll, draws=dual_draws_to(d, device))
            losses += [loss.item(), rec.item()]
        if any(launch_counts(fb).values()):
            fail(f"a dual step launched a block kernel: {launch_counts(fb)}")
        return losses, {k: v.detach().cpu() for k, v in model.named_parameters()}, sched

    t0 = time.perf_counter()
    card_losses, card_params, sched = run("cuda")
    t_card = time.perf_counter() - t0
    cpu_losses, cpu_params, _ = run("cpu")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    param_err = max(((card_params[k] - v).abs() / v.abs().clamp(min=1.0)).max().item()
                    for k, v in cpu_params.items())
    moved = max((card_params[k] - v).abs().max().item() for k, v in
                build_dual_vit(cfg, FT_CLASSES, seed=0, device="cpu").named_parameters())
    ok = loss_rel <= STEP_LOSS_RTOL and param_err <= STEP_PARAM_TOL
    row = {"phase": "dual_step_card_vs_cpu", "model": "HSIMAE-B", "dtype": "float32",
           "batch": DUAL_BATCH, "valid": DUAL_VALID, "unlabeled": DUAL_UNLABELED,
           "grids": DUAL_GRIDS, "lr": [sched(k) for k in range(len(DUAL_GRIDS))],
           "card_losses_loss_rec": card_losses, "cpu_losses_loss_rec": cpu_losses,
           "max_loss_rel": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
           "max_param_scaled_err": param_err, "param_tol": STEP_PARAM_TOL,
           "max_param_move": moved, "card_s": t_card, "card": smi_line, "ok": ok}
    print(json.dumps(row), flush=True)
    if not all(math.isfinite(v) for v in card_losses + cpu_losses) or not ok:
        fail(f"dual steps on the card disagree with the CPU: {row}")
    return row


def cli_finetune(smi_line: str, fb, hsimae_model, dname: str, pretrained: Path,
                 log_dir: Path) -> dict:
    """Phases 12c (bfloat16) and 12d (float32): ``cli.finetune.main`` from
    the bf16 pretrain's ``params_final.pt`` with ``--eval``. The loop's
    steps are wrapped to read the launch counts: each dual step launches no
    block kernel, each validation batch 21 of the dtype's kernel (counts set
    to 0 before each pass), ``--eval`` 21 a scene batch (counts set to 0
    before it). Then the ``--eval`` map against the same fine-tuned weights
    through the Block modules (float32) or with every block as
    ``block_reference`` (bfloat16), and one validation pass timed again
    with the kernel weights rebuilt first and without. Returns the launches
    per kernel on the validation and the ``--eval`` path."""
    import torch
    from hsimae_tpu_torch.cli import finetune as cli
    from hsimae_tpu_torch.config import EvalConfig
    from hsimae_tpu_torch.train import finetune as ft
    from hsimae_tpu_torch.train.evaluate import build_classifier, predict_scene

    own = MAIN_KERNEL[dname]
    want = {k: 21 * (k == own) for k in KERNELS}
    launches = {"cli.finetune val": dict.fromkeys(KERNELS, 0),
                "cli.finetune --eval": dict.fromkeys(KERNELS, 0)}
    seen = {"steps": 0, "val_batches": 0}
    make_step, make_ev, evaluate_scene = ft.make_dual_step, ft.make_eval_metrics_step, \
        cli.evaluate_scene

    def counted_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*sa, **skw):
            reset_counts(fb)
            out = step(*sa, **skw)
            if any(launch_counts(fb).values()):
                fail(f"{dname} dual step launched a block kernel: {launch_counts(fb)}")
            seen["steps"] += 1
            return out
        return run

    def counted_ev(model, n_classes):
        ev = make_ev(model, n_classes)

        def run(x, y, w):
            reset_counts(fb)
            out = ev(x, y, w)
            counts = launch_counts(fb)
            if counts != want:
                fail(f"{dname} validation batch launched {counts}, expected 21 of {own} only")
            for k in KERNELS:
                launches["cli.finetune val"][k] += counts[k]
            seen.update(val_batches=seen["val_batches"] + 1, model=model, ev=ev, batch=(x, y, w))
            return out
        return run

    def counted_eval(*a, **kw):
        reset_counts(fb)
        out = evaluate_scene(*a, **kw)
        torch.cuda.synchronize()
        launches["cli.finetune --eval"] = launch_counts(fb)
        seen["eval_args"] = a
        return out

    epochs = FINETUNE_EPOCHS[dname]
    argv = FINETUNE_ARGV + ["--epochs", str(epochs), "--pretrained", str(pretrained)]
    argv += [] if dname == "bfloat16" else ["--no-bf16"]
    log_dir.mkdir(parents=True, exist_ok=True)
    log_path = log_dir / f"smoke_finetune_{dname}.log"
    ft.make_dual_step, ft.make_eval_metrics_step, cli.evaluate_scene = \
        counted_step, counted_ev, counted_eval
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            res, ev = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        ft.make_dual_step, ft.make_eval_metrics_step, cli.evaluate_scene = \
            make_step, make_ev, evaluate_scene
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = res.history
    size = cli.build_parser().parse_args(argv).synthetic_size
    n_batches = math.ceil(size * size / EvalConfig().batch_size)
    if launches["cli.finetune --eval"] != {k: 21 * n_batches * (k == own) for k in KERNELS}:
        fail(f"{dname} --eval launched {launches['cli.finetune --eval']}, expected "
             f"{21 * n_batches} of {own} only")
    curves = [hist[k] for k in ("loss", "loss_rec", "val_loss")]
    if len(hist["loss"]) != epochs or not all(math.isfinite(v) for c in curves for v in c):
        fail(f"{dname} fine-tuning losses not finite: {curves}")

    # one validation pass again, with the kernel weights rebuilt first and without
    model, val_ev, batch = seen["model"], seen["ev"], seen["batch"]

    def val_pass_ms(repack: bool) -> float:
        if repack:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.0)  # a new version: the next pass rebuilds the kernel weights
        torch.cuda.synchronize()
        t = time.perf_counter()
        cm, ce, cnt = val_ev(*batch)
        torch.cat([cm.flatten(), ce[None], cnt[None]]).cpu()
        return (time.perf_counter() - t) * 1e3

    val_ms = {k: sorted(val_pass_ms(k) for _ in range(5))[2] for k in (True, False)}

    # the --eval map against the same weights through the reference blocks
    scene, test_gt, params, mcfg, num_classes = seen["eval_args"][:5]
    by_reference = dname == "bfloat16"
    clf = build_classifier(params, mcfg.replace(use_kernel=by_reference), num_classes,
                           device="cuda")
    orig = hsimae_model.fused_encoder_block
    if by_reference:  # every block as block_reference, nothing else changed
        hsimae_model.fused_encoder_block = lambda h, wt, nh: fb.block_reference(
            h, wt if isinstance(wt, fb.BlockParams) else wt.params, nh)
    try:
        ref_map = predict_scene(clf, scene, EvalConfig())
    finally:
        hsimae_model.fused_encoder_block = orig
    agree = float((ref_map == ev.pred_map).mean())
    steady = hist["epoch_seconds"][1:] or hist["epoch_seconds"]
    steps_per_epoch = seen["steps"] // epochs
    vm, tm = res.val_metrics, ev.metrics
    row = {"main_path": "cli.finetune", "model": "HSIMAE-B", "dtype": dname, "epochs": epochs,
           "pretrained": pretrained.name, "dual_steps": seen["steps"],
           "steps_per_epoch": steps_per_epoch, "val_passes": len(hist["val_seconds"]),
           "val_batches": seen["val_batches"], "kernel": own,
           "val_launches": launches["cli.finetune val"][own],
           "eval_launches": launches["cli.finetune --eval"][own], "wall_s": wall,
           "dual_steps_per_s": steps_per_epoch * len(steady) / sum(steady),
           "epoch_s_median": sorted(hist["epoch_seconds"])[epochs // 2],
           "val_pass_ms_in_loop_median": 1e3 * sorted(hist["val_seconds"])[
               len(hist["val_seconds"]) // 2],
           "val_pass_ms_with_repack": val_ms[True], "val_pass_ms_without_repack": val_ms[False],
           "max_memory_allocated_bytes": peak,
           "val": {"oa": vm.oa, "aa": vm.aa, "kappa": vm.kappa},
           "test": {"oa": tm.oa, "aa": tm.aa, "kappa": tm.kappa},
           "final_loss": hist["loss"][-1], "final_loss_rec": hist["loss_rec"][-1],
           "reference": "block_reference" if by_reference else "block_modules",
           "agreement": agree, "log": str(log_path.relative_to(log_dir.parent)),
           "note": "synthetic scene, not the paper's numbers", "card": smi_line}
    print(json.dumps(row), flush=True)
    if agree < MIN_AGREEMENT:
        fail(f"{dname} fine-tuned --eval map agrees with {row['reference']} on {agree:.5f} "
             f"of pixels (< {MIN_AGREEMENT})")
    torch.cuda.empty_cache()
    return launches


def read_png_rgb(path: Path):
    """An 8-bit RGB PNG whose rows all use filter 0 (what ``save_colormap``
    writes), decoded with zlib, every chunk's CRC checked -> [h, w, 3] uint8."""
    import numpy as np

    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            fail(f"{path}: bad CRC in chunk {kind}")
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                fail(f"{path}: bit depth {depth}, colour type {ctype}; expected 8-bit RGB")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        fail(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def cli_protocol(smi_line: str, fb, hsimae_model, pretrained: Path, runs: Path,
                 out_dir: Path) -> dict:
    """Phase 13 (module docstring): the protocol through ``cli.finetune``, its
    resume, and the evaluate CLI on the last test run's weights with the
    test split and colormaps. Returns the launches per kernel on each path."""
    import numpy as np
    import torch
    from hsimae_tpu_torch.cli import evaluate as cli_evaluate
    from hsimae_tpu_torch.cli import finetune as cli
    from hsimae_tpu_torch.config import EvalConfig
    from hsimae_tpu_torch.train import finetune as ft
    from hsimae_tpu_torch.train import protocol as proto
    from hsimae_tpu_torch.train.evaluate import build_classifier, predict_scene
    from hsimae_tpu_torch.utils.colormap import _PALETTE

    own = MAIN_KERNEL["bfloat16"]
    epochs = PROTOCOL_EPOCHS
    argv = PROTOCOL_ARGV + ["--pretrained", str(pretrained)]
    real = (ft.make_dual_step, ft.make_eval_metrics_step, proto.dual_branch_finetune,
            proto.evaluate_scene, proto._run_one)
    make_step, make_ev, finetune_fn, evaluate_fn, run_one = real
    rec: dict = {}

    def delta(before: dict) -> dict:
        now = launch_counts(fb)
        return {k: now[k] - before[k] for k in KERNELS}

    def counted_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*sa, **skw):
            rec["steps"] += 1
            return step(*sa, **skw)
        return run

    def counted_ev(model, n_classes):
        ev = make_ev(model, n_classes)

        def run(x, y, w):
            before = launch_counts(fb)
            out = ev(x, y, w)
            got = delta(before)
            if got != {k: 21 * (k == own) for k in KERNELS}:
                fail(f"protocol validation batch launched {got}, expected 21 of {own} only")
            return out
        return run

    def counted_eval(scene, test_gt, *a, **kw):
        before = launch_counts(fb)
        res = evaluate_fn(scene, test_gt, *a, **kw)
        torch.cuda.synchronize()
        n = 21 * math.ceil(scene.shape[0] * scene.shape[1] / EvalConfig().batch_size)
        if delta(before) != {k: n * (k == own) for k in KERNELS}:
            fail(f"protocol test evaluation launched {delta(before)}, expected {n} of {own}")
        rec["maps"].append(res.pred_map)
        return res

    def recorded_finetune(split, model_cfg, ft_cfg, **kw):
        res = finetune_fn(split, model_cfg, ft_cfg, **kw)
        rec["histories"].append({k: res.history[k] for k in ("epoch_seconds", "val_seconds")})
        rec["last"] = (res.params, split.test_gt, kw["seed"])
        return res

    def timed_run_one(*a, **kw):
        t = time.perf_counter()
        out = run_one(*a, **kw)
        torch.cuda.synchronize()
        rec["run_seconds"].append(time.perf_counter() - t)
        return out

    def run(workdir: Path, log_path: Path):
        rec.clear()
        rec.update(steps=0, maps=[], histories=[], run_seconds=[])
        ft.make_dual_step, ft.make_eval_metrics_step = counted_step, counted_ev
        proto.dual_branch_finetune, proto.evaluate_scene = recorded_finetune, counted_eval
        proto._run_one = timed_run_one
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        reset_counts(fb)
        t0 = time.perf_counter()
        try:
            with open(log_path, "w") as log, contextlib.redirect_stdout(log):
                res = cli.main(argv + ["--workdir", str(workdir)])
            torch.cuda.synchronize()
        finally:
            (ft.make_dual_step, ft.make_eval_metrics_step, proto.dual_branch_finetune,
             proto.evaluate_scene, proto._run_one) = real
        wall = time.perf_counter() - t0
        counts = launch_counts(fb)
        line = json.loads(log_path.read_text().strip().splitlines()[-1])
        return (res, counts, wall, mem0, torch.cuda.memory_allocated(),
                torch.cuda.max_memory_allocated(), line)

    def records(workdir: Path) -> list:
        return (workdir / "protocol_runs.jsonl").read_text().splitlines()

    def pm(text: str):
        mean, std = (float(v) for v in text.split("±"))
        return mean, std

    # ---- 13a. the protocol ----
    out_dir.mkdir(parents=True, exist_ok=True)
    workdir = runs / "protocol"
    shutil.rmtree(workdir, ignore_errors=True)
    res, counts, wall, mem0, mem1, peak, line = run(workdir, out_dir / "smoke_protocol.log")
    want = {k: PROTOCOL_LAUNCHES * (k == own) for k in KERNELS}
    if counts != want:
        fail(f"the protocol launched {counts}, expected {want}")
    if len(rec["run_seconds"]) != PROTOCOL_RUNS:
        fail(f"the protocol ran {len(rec['run_seconds'])} fine-tunes, expected {PROTOCOL_RUNS}")
    lines = records(workdir)
    parsed = [json.loads(x) for x in lines]
    if len(parsed) != PROTOCOL_RUNS or any(set(r) != PROTOCOL_RECORD_KEYS[r["stage"]]
                                           for r in parsed):
        fail(f"protocol_runs.jsonl holds {parsed}, expected {PROTOCOL_RUNS} records with the "
             "JAX package's keys")
    stats = {k: pm(line[k]) for k in ("oa", "aa", "kappa")}
    if res.best_lr not in PROTOCOL_LRS or line["best_lr"] != res.best_lr or not all(
            math.isfinite(v) and 0.0 <= v <= 100.0 for m, sd in stats.values() for v in (m, sd)):
        fail(f"bad protocol result: {line}")
    if mem1 - mem0 > MAX_MEMORY_GROWTH:
        fail(f"card memory grew by {mem1 - mem0} bytes across the protocol (> "
             f"{MAX_MEMORY_GROWTH}): runs are not freed")
    hists = rec["histories"]
    steady = [t for h in hists for t in h["epoch_seconds"][1:]]
    val_s = sorted(t for h in hists for t in h["val_seconds"])
    sel_s = rec["run_seconds"][:2]
    test_extra = sum(rec["run_seconds"][2:]) / 2 - sum(sel_s) / 2  # a test run's scene eval
    extrapolated = (FULL_PROTOCOL["runs"] * sum(sel_s) / 2 * FULL_PROTOCOL["epochs"] / epochs
                    + FULL_PROTOCOL["test_runs"] * test_extra)
    row = {"main_path": "cli.finetune --protocol", "model": "HSIMAE-B", "dtype": "bfloat16",
           "cut": "lr grid (1e-3, 1e-4), 1 selection seed, 2 test seeds, 20 epochs a run; the "
                  "paper's is 4 lrs x 3 seeds + 5 test seeds, 200 epochs",
           "runs": len(rec["run_seconds"]), "epochs": epochs, "run_wall_s": rec["run_seconds"],
           "wall_s": wall, "dual_steps": rec["steps"],
           "dual_steps_per_s": rec["steps"] * (epochs - 1) / epochs / sum(steady),
           "val_pass_ms_median": 1e3 * val_s[len(val_s) // 2], "kernel": own,
           "launches": counts[own], "max_memory_allocated_bytes": peak,
           "memory_allocated_before": mem0, "memory_allocated_after": mem1,
           "best_lr": res.best_lr, "selection_scores": {str(k): v for k, v in
                                                        res.selection_scores.items()},
           "result": line, "extrapolated_full_protocol_s": extrapolated,
           "extrapolation": "17 runs x the mean selection run's wall x 200/20 epochs + 5 x a "
                            "test run's extra wall (its scene evaluation); not measured",
           "note": "synthetic scene, not the paper's numbers", "card": smi_line}
    print(json.dumps(row), flush=True)
    launches = {"protocol": counts}
    last_params, last_test_gt, last_seed = rec["last"]
    last_map = rec["maps"][-1]

    # ---- 13b. resume from a cut record file with a torn line ----
    resumed = runs / "protocol_resume"
    shutil.rmtree(resumed, ignore_errors=True)
    shutil.copytree(workdir, resumed)
    (resumed / "protocol_runs.jsonl").write_text("\n".join(lines[:3]) + '\n{"stage": "test", "lr": ')
    res_r, counts_r, wall_r, _, _, _, line_r = run(resumed, out_dir / "smoke_protocol_resume.log")
    want_r = {k: RESUME_LAUNCHES * (k == own) for k in KERNELS}
    new_lines = records(resumed)
    redo, again = json.loads(lines[3]), json.loads(new_lines[-1])
    diff = {k: 100 * (again[k] - redo[k]) for k in ("oa", "aa", "kappa")}
    row_r = {"check": "protocol resume", "fine_tunes": len(rec["run_seconds"]),
             "launches": counts_r[own], "wall_s": wall_r, "kept_records_equal":
             new_lines[:3] == lines[:3], "best_lr": res_r.best_lr, "rerun_seed": again["seed"],
             "rerun_minus_first_points": diff, "result": line_r, "card": smi_line}
    print(json.dumps(row_r), flush=True)
    if len(rec["run_seconds"]) != 1 or counts_r != want_r:
        fail(f"the resumed protocol ran {len(rec['run_seconds'])} fine-tunes and launched "
             f"{counts_r}, expected 1 and {want_r}")
    if new_lines[:3] != lines[:3] or res_r.best_lr != res.best_lr or again["seed"] != redo["seed"]:
        fail(f"the resumed protocol changed the kept records or the result: {row_r}")
    if any(abs(v) > 1.0 for v in diff.values()):
        fail(f"the re-run seed's metrics moved by more than 1 point: {diff}")
    launches["protocol resume"] = counts_r

    # ---- 13c. the evaluate CLI on the last test run's weights: test split, colormaps ----
    params_path = runs / "protocol_last.pt"
    torch.save(last_params, params_path)
    png_dir = out_dir / "smoke_protocol_eval"
    shutil.rmtree(png_dir, ignore_errors=True)
    argv_e = SCENE_ARGV + ["--synthetic-seed", "0", "--params", str(params_path),
                           "--samples-per-class", "10", "--seed", str(last_seed),
                           "--out", str(png_dir)]
    args = cli_evaluate.build_parser().parse_args(argv_e)
    reset_counts(fb)
    with contextlib.redirect_stdout(sys.stderr):
        ev = cli_evaluate.main(argv_e)
    torch.cuda.synchronize()
    counts_e = launch_counts(fb)
    n_batches = math.ceil(args.synthetic_size ** 2 / args.batch_size)
    if counts_e != {k: 21 * n_batches * (k == own) for k in KERNELS}:
        fail(f"cli.evaluate launched {counts_e}, expected {21 * n_batches} of {own} only")
    launches["cli.evaluate --samples-per-class"] = counts_e
    scene, scored_gt, mcfg = cli_evaluate.prepare(args)
    full_gt = cli_evaluate.load_labeled_scene(args)[1]
    n_classes = int(full_gt.max())
    pred = ev.pred_map
    rgb = read_png_rgb(png_dir / "scene_pred.png")
    rgb_masked = read_png_rgb(png_dir / "scene_pred_masked.png")
    clf = build_classifier(last_params, mcfg, args.num_classes, device="cuda")
    orig = hsimae_model.fused_encoder_block
    hsimae_model.fused_encoder_block = lambda h, wt, nh: fb.block_reference(
        h, wt if isinstance(wt, fb.BlockParams) else wt.params, nh)
    try:
        ref_map = predict_scene(clf, scene, EvalConfig(batch_size=args.batch_size))
    finally:
        hsimae_model.fused_encoder_block = orig
    agree = float((ref_map == pred).mean())
    m = ev.metrics
    row_e = {"main_path": "cli.evaluate --samples-per-class", "model": "HSIMAE-B",
             "dtype": "bfloat16", "seed": last_seed, "scored_pixels": int((scored_gt != 0).sum()),
             "labeled_pixels": int((full_gt != 0).sum()), "train_draw": 10 * n_classes,
             "launches": counts_e[own], "test": {"oa": m.oa, "aa": m.aa, "kappa": m.kappa},
             "test_split_equal_protocol": bool(np.array_equal(scored_gt, last_test_gt)),
             "map_equal_protocol_share": float((pred == last_map).mean()),
             "reference": "block_reference", "agreement": agree,
             "pngs": sorted(p.name for p in png_dir.iterdir()), "card": smi_line}
    print(json.dumps(row_e), flush=True)
    if row_e["scored_pixels"] != row_e["labeled_pixels"] - row_e["train_draw"] \
            or not row_e["test_split_equal_protocol"]:
        fail(f"cli.evaluate --samples-per-class scored the wrong pixels: {row_e}")
    if not (np.array_equal(rgb, _PALETTE[pred])
            and np.array_equal(rgb_masked, _PALETTE[np.where(scored_gt != 0, pred, 0)])):
        fail("the colormap PNGs do not decode to the palette's colours of the map")
    if agree < MIN_AGREEMENT:
        fail(f"cli.evaluate map agrees with block_reference on {agree:.5f} of pixels "
             f"(< {MIN_AGREEMENT})")
    torch.cuda.empty_cache()
    return launches


def scene_main_path(smi_line: str, fb, hsimae_model, model: str) -> dict:
    """Phases 4-6 (HSIMAE-B) and 11 (HSIMAE-L): the 145x145 scene through
    ``cli.evaluate.main`` at ``model``'s full width and depth, float32 then
    bfloat16, each run with the counts set to 0 just before it: 21 launches
    a batch of the dtype's kernel and none of the others, a sane map and
    finite metrics; then each map against its reference (float32: the same
    model through the Block modules; bfloat16: every block as
    ``block_reference``, the kernel's own semantics) on >= 99.9% of pixels,
    and the warm batch loops through the kernel and the modules. Returns the
    launches per kernel on this path and the maps by dtype."""
    import torch
    from hsimae_tpu_torch.cli import evaluate as cli_evaluate
    from hsimae_tpu_torch.config import EvalConfig
    from hsimae_tpu_torch.train.evaluate import build_classifier, predict_scene

    launches = dict.fromkeys(KERNELS, 0)
    results = {}
    for dname, argv in MAIN_ARGV.items():
        argv = argv + ["--model", model]
        own = MAIN_KERNELS[model][dname]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fb)
        t0 = time.perf_counter()
        res = cli_evaluate.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts(fb)
        peak = torch.cuda.max_memory_allocated()
        args = cli_evaluate.build_parser().parse_args(argv)
        n_pix = args.synthetic_size ** 2
        n_batches = math.ceil(n_pix / args.batch_size)
        if counts != {k: 21 * n_batches * (k == own) for k in KERNELS}:
            fail(f"{model} {dname} main path launched {counts}, expected {21 * n_batches} of "
                 f"{own} only")
        launches[own] += counts[own]
        pred = res.pred_map
        if pred.shape != (args.synthetic_size, args.synthetic_size) or pred.min() < 1 \
                or pred.max() >= args.num_classes:
            fail(f"bad {model} {dname} prediction map: shape {pred.shape}, "
                 f"labels {pred.min()}..{pred.max()}")
        m = res.metrics
        if not all(math.isfinite(v) for v in (m.oa, m.aa, m.kappa)):
            fail(f"non-finite {model} {dname} metrics")
        results[dname] = (args, res, wall, n_pix, n_batches, counts[own], peak)

    for dname, (args, res, wall, n_pix, n_batches, n_launch, peak) in results.items():
        scene, _, mcfg = cli_evaluate.prepare(args)
        ecfg = EvalConfig(batch_size=args.batch_size)

        def run(use_kernel: bool, blocks_by_reference: bool = False):
            """The scene through a model built once: (map, warm predict seconds)."""
            clf = build_classifier(None, mcfg.replace(use_kernel=use_kernel), args.num_classes,
                                   device="cuda", seed=args.seed)
            orig = hsimae_model.fused_encoder_block
            if blocks_by_reference:  # every block as block_reference, nothing else changed
                hsimae_model.fused_encoder_block = lambda x, w, h: fb.block_reference(
                    x, w if isinstance(w, fb.BlockParams) else w.params, h)
            try:
                predict_scene(clf, scene, ecfg)  # first call: the kernel layout of the weights
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = predict_scene(clf, scene, ecfg)
                torch.cuda.synchronize()
            finally:
                hsimae_model.fused_encoder_block = orig
            return out, time.perf_counter() - t

        modules_map, modules_s = run(False)
        kernel_map, kernel_s = run(True)
        if dname == "float32":  # the Block modules compute the same f32 block
            ref_map, ref_name = modules_map, "block_modules"
        else:  # bf16: the kernel's semantics (residual rounded to bf16), block by block
            ref_map, ref_name = run(True, blocks_by_reference=True)[0], "block_reference"
        pred = res.pred_map
        agree = float((ref_map == pred).mean())
        print(json.dumps({"main_path": "cli.evaluate", "model": model, "dtype": dname,
                          "pixels": n_pix, "batches": n_batches,
                          "kernel": MAIN_KERNELS[model][dname], "launches": n_launch,
                          "wall_s": wall, "pixels_per_s": n_pix / wall,
                          "max_memory_allocated_bytes": peak,
                          "warm_predict_kernel_s": kernel_s, "warm_predict_modules_s": modules_s,
                          "warm_kernel_pixels_per_s": n_pix / kernel_s,
                          "warm_modules_pixels_per_s": n_pix / modules_s,
                          "reference": ref_name, "agreement": agree,
                          "repeat_equal": bool((kernel_map == pred).all()),
                          "card": smi_line}), flush=True)
        if agree < MIN_AGREEMENT:
            fail(f"{model} {dname} prediction map agrees with {ref_name} on {agree:.5f} of "
                 f"pixels (< {MIN_AGREEMENT})")
        torch.cuda.empty_cache()
    return launches, {dname: r[1].pred_map for dname, r in results.items()}


def serving(smi_line: str, fb, params_path: Path, runs: Path, gen, max_err: dict) -> dict:
    """Phase 14 (module docstring): the kernels at the artifact's launch
    shapes, then phase 13's last weights exported in four variants, each
    served in a fresh process without the model source and through
    ``cli.evaluate --artifact`` on the phase-4 scene. Returns the launches
    per kernel on each path."""
    import numpy as np
    import torch
    from hsimae_tpu_torch.cli import evaluate as cli_evaluate
    from hsimae_tpu_torch.cli import export as cli_export
    from hsimae_tpu_torch.config import EvalConfig, preset
    from hsimae_tpu_torch.serving import load_classifier
    from hsimae_tpu_torch.train.evaluate import (
        build_classifier,
        classify_scene_artifact,
        predict_scene,
    )

    # ---- 14a. the kernels at the buckets' launch shapes ----
    dev = torch.device("cuda")
    for dtype, dname in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        for name, (shape, count) in SERVE_SHAPES.items():
            row, err = time_case(fb, dtype, dname, name, shape, gen, dev, model="HSIMAE-B",
                                 path="serving", launches_per_call=count)
            max_err[row["kernel"]] = max(max_err[row["kernel"]], err)
        torch.cuda.empty_cache()

    launches = {"serving predict": dict.fromkeys(KERNELS, 0),
                "cli.evaluate --artifact": dict.fromkeys(KERNELS, 0)}
    x = torch.rand(max(SERVE_NS), 9, 9, 32, generator=torch.Generator().manual_seed(14))
    xs = runs / "serve_x.npy"
    np.save(xs, x.numpy())
    scene_args = cli_evaluate.build_parser().parse_args(SCENE_ARGV)
    scene, gt, _ = cli_evaluate.prepare(scene_args)
    sizes, maps = {}, {}
    for variant, (flags, dname) in SERVE_VARIANTS.items():
        own = MAIN_KERNEL[dname]
        cfg = preset("HSIMAE-B", compute_dtype=getattr(torch, dname))
        # ---- 14b. export through the CLI ----
        art = runs / f"serve_{variant}.pt2"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            cli_export.main(["--params", str(params_path), "--num-classes", str(FT_CLASSES),
                             "--output", str(art), "--model", "HSIMAE-B", *flags])
        export_s = time.perf_counter() - t0
        sizes[variant] = art.stat().st_size

        # ---- 14c. load and serve in a fresh process without the model source ----
        out = runs / f"serve_{variant}.npz"
        child = subprocess.run([sys.executable, "-c", SERVE_CHILD, str(art), str(xs), str(out),
                                json.dumps(SERVE_NS)], cwd=Path(__file__).resolve().parent,
                               capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            fail(f"serving {variant} in a fresh process failed:\n{child.stderr[-3000:]}")
        info = json.loads(child.stdout.strip().splitlines()[-1])
        got = np.load(out)
        clf = load_classifier(str(art), device="cuda")
        weights = clf.weights()  # the (dequantized) weights the artifact serves
        live = build_classifier(weights, cfg, FT_CLASSES, device="cuda")
        with torch.inference_mode():
            want = torch.cat([live.classify(c.cuda()) for c in x.split(1024)]).float().cpu()
        worst = 0.0
        for n in SERVE_NS:
            calls = -(-n // 1024)
            if info["launches"][str(n)] != [21 * calls * (k == own) for k in KERNELS]:
                fail(f"serving {variant} at n={n} launched {info['launches'][str(n)]}, expected "
                     f"{21 * calls} of {own} only")
            if got[str(n)].shape != (n, FT_CLASSES) or not np.isfinite(got[str(n)]).all():
                fail(f"serving {variant} at n={n} gave logits of shape {got[str(n)].shape}")
            ref = want[:n].numpy()
            worst = max(worst, float((np.abs(got[str(n)] - ref) / np.maximum(1, np.abs(ref)))
                                     .max()))
            for k, c in zip(KERNELS, info["launches"][str(n)]):
                launches["serving predict"][k] += c
        if worst > TOL[dname] or info["pack_builds_in_requests"] or info["models_imported"] \
                or not info["numpy_out_at_63"]:
            fail(f"serving {variant}: scaled logits error {worst} (tol {TOL[dname]}), {info}")

        # ---- 14d. cli.evaluate --artifact on the phase-4 scene, against --params ----
        reset_counts(fb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = cli_evaluate.main(SCENE_ARGV + ["--artifact", str(art)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts(fb)
        if counts != {k: SCENE_LAUNCHES * (k == own) for k in KERNELS}:
            fail(f"cli.evaluate --artifact ({variant}) launched {counts}, expected "
                 f"{SCENE_LAUNCHES} of {own} only")
        for k in KERNELS:
            launches["cli.evaluate --artifact"][k] += counts[k]
        wpath = runs / f"serve_{variant}_weights.pt"
        torch.save(weights, wpath)
        with contextlib.redirect_stdout(sys.stderr):
            res_p = cli_evaluate.main(SCENE_ARGV + ["--params", str(wpath)]
                                      + (["--no-bf16"] if dname == "float32" else []))
        agree = float((res.pred_map == res_p.pred_map).mean())
        maps[variant] = res.pred_map

        # ---- 14e. warm scene through the artifact against predict_scene, in turns ----
        ecfg = EvalConfig(batch_size=BATCH)
        walls = {"artifact": [], "live": []}
        for i in range(4):
            for name, fn in (("artifact", lambda: classify_scene_artifact(scene, clf, ecfg)),
                             ("live", lambda: predict_scene(live, scene, ecfg))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i:  # the first turn warms up
                    walls[name].append(time.perf_counter() - t0)
        art_s, live_s = (sorted(walls[k])[1] for k in ("artifact", "live"))  # medians of 3
        n_pix = scene.shape[0] * scene.shape[1]
        row = {"main_path": "serving", "variant": variant, "model": "HSIMAE-B", "dtype": dname,
               "flags": flags, "artifact_bytes": sizes[variant], "export_s": export_s,
               "kernel": own, "request_launches": info["launches"],
               "pack_builds_in_requests": info["pack_builds_in_requests"],
               "max_scaled_logit_err": worst, "tol": TOL[dname],
               "cuda_init_s": info["cuda_init_s"], "load_s": info["load_s"],
               "predict_1024_ms": info["predict_1024_ms"],
               "serve_max_memory_allocated_bytes": info["max_memory_allocated_bytes"],
               "scene_launches": counts[own], "scene_cli_wall_s": wall,
               "scene_cli_max_memory_allocated_bytes": peak,
               "agreement_with_params_run": agree,
               "warm_artifact_pixels_per_s": n_pix / art_s,
               "warm_predict_scene_pixels_per_s": n_pix / live_s,
               "warm_walls_s": walls, "card": smi_line}
        print(json.dumps(row), flush=True)
        if agree < MIN_AGREEMENT:
            fail(f"cli.evaluate --artifact ({variant}) agrees with --params on {agree:.5f} of "
                 f"pixels (< {MIN_AGREEMENT})")
        del clf, live
        torch.cuda.empty_cache()
    ratio = sizes["int8"] / sizes["f32"]
    print(json.dumps({"check": "serving sizes", "bytes": sizes, "int8_over_f32": ratio,
                      "max_int8_over_f32": MAX_INT8_SIZE,
                      "int8_map_agreement_with_f32_map": float(
                          (maps["int8"] == maps["f32"]).mean()),
                      "int8_bf16_map_agreement_with_bf16_map": float(
                          (maps["int8_bf16"] == maps["bf16"]).mean()),
                      "card": smi_line}), flush=True)
    if ratio >= MAX_INT8_SIZE:
        fail(f"the int8 artifact is {ratio:.3f} of the f32 one's bytes (>= {MAX_INT8_SIZE})")
    return launches


# ----------------------------- phase 15: data parallelism -----------------------------


def dp_pretrain_steps(device, mesh=None):
    """Phase 15a's three float32 HSIMAE-B pretrain steps: phase 8's batch of
    64 with its last 3 rows padding (weight 0), one seeded init, injected
    draws on both kept grids; under ``mesh``, this rank's rows of it ->
    (losses, parameters on the CPU)."""
    import torch
    from hsimae_tpu_torch.config import preset
    from hsimae_tpu_torch.models.hsimae import build_hsimae
    from hsimae_tpu_torch.parallel.mesh import mesh_slice
    from hsimae_tpu_torch.train.optim import pretrain_optimizer
    from hsimae_tpu_torch.train.pretrain import draw_pretrain, make_pretrain_step

    cfg = preset("HSIMAE-B", compute_dtype=torch.float32)
    x = torch.rand(STEP_BATCH, cfg.img_size, cfg.img_size, cfg.bands,
                   generator=torch.Generator().manual_seed(7))
    w = torch.ones(STEP_BATCH)
    w[DP_STEP_VALID:] = 0.0
    probe = build_hsimae(cfg, device="cpu")
    gen = torch.Generator().manual_seed(8)
    draws = [draw_pretrain(probe, STEP_BATCH, lt, ll, gen, "cpu") for lt, ll in STEP_GRIDS]
    model = build_hsimae(cfg, seed=0, device=device)
    opt, sched = pretrain_optimizer(model, 5e-3, 0.05, total_steps=STEP_TOTAL)
    step = make_pretrain_step(model, opt, sched, mesh=mesh)
    rows = mesh_slice(STEP_BATCH, mesh)
    losses = [step(x[rows].to(device), lt, ll, w.to(device), draws=to_device(d, device)).item()
              for (lt, ll), d in zip(STEP_GRIDS, draws)]
    return losses, {k: v.detach().cpu() for k, v in model.named_parameters()}


def dp_dual_steps(device, mesh=None):
    """Phase 15b's three float32 HSIMAE-B dual steps at phase 12b's setting
    (labeled 32 with a padded tail, its 43 unlabeled rows wrapped to 44,
    mask ratio 0.8, lambda 10, drop-path 0.2, injected draws on both kept
    grids); under ``mesh``, this rank's rows of both batches -> (losses and
    reconstruction losses, parameters on the CPU)."""
    import torch
    from hsimae_tpu_torch.config import preset
    from hsimae_tpu_torch.models.hsimae import build_dual_vit
    from hsimae_tpu_torch.parallel.mesh import mesh_slice
    from hsimae_tpu_torch.train.finetune import draw_dual, make_dual_step
    from hsimae_tpu_torch.train.optim import finetune_optimizer

    cfg = preset("HSIMAE-B", compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(12)
    x = torch.rand(DUAL_BATCH, cfg.img_size, cfg.img_size, cfg.bands, generator=g)
    xu = torch.rand(DUAL_UNLABELED, cfg.img_size, cfg.img_size, cfg.bands, generator=g)
    xu = torch.cat([xu, xu[:DP_UNLABELED - DUAL_UNLABELED]])  # wrapped, as the loop pads
    y = torch.randint(1, FT_CLASSES, (DUAL_BATCH,), generator=g)
    w = torch.ones(DUAL_BATCH)
    y[DUAL_VALID:], w[DUAL_VALID:] = 0, 0.0
    probe = build_dual_vit(cfg, FT_CLASSES, device="cpu")
    draws = [draw_dual(probe, DUAL_BATCH, DP_UNLABELED, lt, ll, g, "cpu") for lt, ll in DUAL_GRIDS]
    model = build_dual_vit(cfg, FT_CLASSES, seed=0, device=device)
    opt, sched = finetune_optimizer(model, 1e-3, 5e-3, epochs=len(DUAL_GRIDS), steps_per_epoch=1)
    step = make_dual_step(model, opt, sched, lamda=10.0, mesh=mesh)
    rows, rows_u = mesh_slice(DUAL_BATCH, mesh), mesh_slice(DP_UNLABELED, mesh)
    losses = []
    for (lt, ll), d in zip(DUAL_GRIDS, draws):
        loss, rec, _ = step(x[rows].to(device), y.to(device), w.to(device),
                            xu[rows_u].to(device), lt, ll, draws=dual_draws_to(d, device))
        losses += [loss.item(), rec.item()]
    return losses, {k: v.detach().cpu() for k, v in model.named_parameters()}


def dp_finetune_ranks(fb, pretrained: str, log_path: Path) -> dict:
    """Phase 15f on one rank: ``cli.finetune.main`` (bf16, 20 epochs,
    ``--eval``) with its steps wrapped to read this rank's launch counts:
    none in a dual step, 21 of the bf16 kernel in each val batch share, and
    the ``--eval`` launches. Returns them, the losses and (rank 0) what the
    map's reference needs."""
    import torch
    from hsimae_tpu_torch.cli import finetune as cli
    from hsimae_tpu_torch.parallel.mesh import is_main_process
    from hsimae_tpu_torch.train import finetune as ft

    own = MAIN_KERNEL["bfloat16"]
    seen = {"steps": 0, "val_batches": 0, "val_launches": dict.fromkeys(KERNELS, 0)}
    make_step, make_ev, evaluate_scene = ft.make_dual_step, ft.make_eval_metrics_step, \
        cli.evaluate_scene

    def counted_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*sa, **skw):
            reset_counts(fb)
            out = step(*sa, **skw)
            if any(launch_counts(fb).values()):
                fail(f"a data-parallel dual step launched a block kernel: {launch_counts(fb)}")
            seen["steps"] += 1
            return out
        return run

    def counted_ev(model, n_classes):
        ev = make_ev(model, n_classes)

        def run(x, y, w):
            reset_counts(fb)
            out = ev(x, y, w)
            counts = launch_counts(fb)
            if counts != {k: 21 * (k == own) for k in KERNELS}:
                fail(f"a data-parallel val batch share launched {counts}, expected 21 of {own}")
            seen["val_batches"] += 1
            for k in KERNELS:
                seen["val_launches"][k] += counts[k]
            return out
        return run

    def counted_eval(*a, **kw):
        reset_counts(fb)
        out = evaluate_scene(*a, **kw)
        torch.cuda.synchronize()
        seen["eval_launches"] = launch_counts(fb)
        seen["eval_args"] = a
        return out

    argv = FINETUNE_ARGV + ["--epochs", str(DP_FINETUNE_EPOCHS), "--pretrained", pretrained]
    ft.make_dual_step, ft.make_eval_metrics_step, cli.evaluate_scene = \
        counted_step, counted_ev, counted_eval
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log, contextlib.redirect_stdout(log):
            res, ev = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        ft.make_dual_step, ft.make_eval_metrics_step, cli.evaluate_scene = \
            make_step, make_ev, evaluate_scene
    hist = res.history
    out = {"wall_s": time.perf_counter() - t0, "steps": seen["steps"],
           "val_batches": seen["val_batches"], "val_launches": seen["val_launches"],
           "eval_launches": seen["eval_launches"], "pred_map": ev.pred_map,
           "curves": [hist[k] for k in ("loss", "loss_rec", "val_loss")],
           "val": [res.val_metrics.oa, res.val_metrics.aa, res.val_metrics.kappa],
           "test": [ev.metrics.oa, ev.metrics.aa, ev.metrics.kappa],
           "epoch_seconds": hist["epoch_seconds"]}
    if is_main_process():
        scene, _, params, mcfg, num_classes = seen["eval_args"][:5]
        out["reference_inputs"] = (scene, params, mcfg, num_classes)
    return out


def rank_job(kind: str, report_dir: str, extra: list) -> int:
    """One rank of a ``torch.distributed.run`` job of phase 15 (``python3
    -m torch.distributed.run ... chip_smoke.py --rank-job KIND DIR ...``):
    ``dp`` runs 15a, 15b, 15c and 15f on this rank; ``nccl`` runs 15d.
    Writes ``DIR/rank{r}.pt``."""
    import torch
    import torch.distributed as dist
    from hsimae_tpu_torch.ops import fused_block as fb
    from hsimae_tpu_torch.parallel.mesh import (
        default_mesh,
        init_distributed,
        is_main_process,
        shutdown_distributed,
    )

    device = init_distributed(device="cuda")
    rank, out = dist.get_rank(), {"backend": dist.get_backend()}
    runs = Path(report_dir).parent
    try:
        if kind == "dp":
            spe = int(extra[0])
            mesh = default_mesh()
            t0 = time.perf_counter()
            out["pretrain_steps"] = dp_pretrain_steps(device, mesh)
            out["dual_steps"] = dp_dual_steps(device, mesh)
            out["steps_s"] = time.perf_counter() - t0
            if not is_main_process():  # the parameters are compared once
                out["pretrain_steps"] = out["pretrain_steps"][0]
                out["dual_steps"] = out["dual_steps"][0]
            torch.cuda.empty_cache()

            # 15c: cli.pretrain, two epochs; then a run stopped after epoch 1, resumed
            from hsimae_tpu_torch.cli import pretrain as cli
            from hsimae_tpu_torch.train.pretrain import run_pretraining

            argv = PRETRAIN_ARGV + ["--checkpoint-every", str(spe)]
            reset_counts(fb)
            t0 = time.perf_counter()
            out["full"] = cli.main(argv + ["--workdir", str(runs / "dp_full")])[1]
            out["full_s"] = time.perf_counter() - t0
            args = cli.build_parser().parse_args(argv + ["--workdir", str(runs / "dp_resumed")])
            source, index, mcfg, pcfg = cli.prepare(args)
            run_pretraining(source, index.locs, mcfg, pcfg, workdir=args.workdir,
                            resume=False, stop_after_epochs=1, device=args.device)
            del source
            out["resumed"] = cli.main(argv + ["--workdir", str(runs / "dp_resumed")])[1]
            out["pretrain_launches"] = launch_counts(fb)
            torch.cuda.empty_cache()

            # 15f: cli.finetune from phase 9's bf16 weights, --eval
            out["finetune"] = dp_finetune_ranks(
                fb, extra[1], Path(extra[2]) / f"smoke_dp_finetune_rank{rank}.log")
        else:  # nccl: cli.pretrain's parts at one rank, stopped after epoch 1
            from hsimae_tpu_torch.cli import pretrain as cli
            from hsimae_tpu_torch.train.pretrain import run_pretraining

            args = cli.build_parser().parse_args(PRETRAIN_ARGV)
            source, index, mcfg, pcfg = cli.prepare(args)
            out["mesh"] = str(default_mesh())
            reset_counts(fb)
            _, out["hist"] = run_pretraining(source, index.locs, mcfg, pcfg, resume=False,
                                             stop_after_epochs=1, device=args.device)
            out["pretrain_launches"] = launch_counts(fb)
        torch.save(out, Path(report_dir) / f"rank{rank}.pt")
    finally:
        shutdown_distributed()
    return 0


def launch_ranks(n: int, kind: str, report_dir: Path, log_path: Path, extra: list,
                 timeout: int) -> list:
    """Run ``n`` ranks of :func:`rank_job` under ``python3 -m
    torch.distributed.run`` (output to ``log_path``) -> each rank's report."""
    import socket

    import torch

    shutil.rmtree(report_dir, ignore_errors=True)
    report_dir.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
           "--master-port", str(port), str(Path(__file__).resolve()), "--rank-job", kind,
           str(report_dir), *extra]
    # the ranks split the host's cores (torch.distributed.run would give each one thread)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // n)))
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, stdout=log,
                            stderr=subprocess.STDOUT, timeout=timeout, env=env).returncode
    if rc:
        tail = log_path.read_text()[-4000:]
        fail(f"torch.distributed.run of {n} ranks ({kind}) exited {rc}:\n{tail}")
    return [torch.load(report_dir / f"rank{r}.pt", weights_only=False) for r in range(n)]


def scaled_err(a: dict, b: dict) -> float:
    return max(((a[k] - v).abs() / v.abs().clamp(min=1.0)).max().item() for k, v in b.items())


def data_parallel(smi_line: str, fb, hsimae_model, runs: Path, log_dir: Path, spe: int,
                  single_epoch_1: float, scene_maps: dict) -> dict:
    """Phase 15: the data-parallel paths on the card. 15a/b: the steps of
    phases 8 and 12b on 2 ranks (gloo, both on cuda:0) against one process
    on the card; 15c: ``cli.pretrain`` under ``torch.distributed.run
    --nproc-per-node 2`` (two epochs; a run stopped after epoch 1 and
    resumed), rank 0's files only; 15d: the same CLI's parts at one rank,
    over NCCL; 15e: ``cli.evaluate --dp 2`` in both dtypes, each rank's
    launches and the map against phases 4/5; 15f: ``cli.finetune`` on 2
    ranks, bf16, ``--eval``. Returns the launches per kernel on each path
    that runs a kernel, summed over the ranks."""
    import torch
    from hsimae_tpu_torch.cli import evaluate as cli_evaluate
    from hsimae_tpu_torch.config import EvalConfig
    from hsimae_tpu_torch.train.evaluate import build_classifier, predict_scene

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    # ---- 15a, 15b: one process on the card, then the two ranks ----
    single_pt, single_dual = dp_pretrain_steps("cuda"), dp_dual_steps("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = launch_ranks(DP_RANKS, "dp", runs / "dp_reports", log_dir / "smoke_dp.log",
                           [str(spe), str(runs / "bf16" / "params_final.pt"), str(log_dir)],
                           timeout=900)
    job_s = time.perf_counter() - t0
    for name, (losses, params) in (("pretrain_steps", single_pt), ("dual_steps", single_dual)):
        rank_losses = [r[name][0] if isinstance(r[name], tuple) else r[name] for r in reports]
        loss_rel = max(abs(a - b) / abs(b) for rl in rank_losses for a, b in zip(rl, losses))
        param_err = scaled_err(reports[0][name][1], params)
        row = {"phase": f"data-parallel {name}", "model": "HSIMAE-B", "dtype": "float32",
               "ranks": DP_RANKS, "backend": reports[0]["backend"],
               "rank_losses": rank_losses, "single_process_losses": losses,
               "max_loss_rel": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
               "max_param_scaled_err": param_err, "param_tol": STEP_PARAM_TOL,
               "card": smi_line}
        print(json.dumps(row), flush=True)
        if reports[0]["backend"] != "gloo" or loss_rel > STEP_LOSS_RTOL \
                or param_err > STEP_PARAM_TOL or not all(math.isfinite(v) for v in losses):
            fail(f"data-parallel {name} disagree with one process: {row}")

    # ---- 15c: cli.pretrain on 2 ranks ----
    full, resumed = reports[0]["full"], reports[0]["resumed"]
    rel = abs(resumed["epoch_loss"][0] - full["epoch_loss"][1]) / abs(full["epoch_loss"][1])
    rel_single = abs(full["epoch_loss"][0] - single_epoch_1) / abs(single_epoch_1)
    files = {d: sorted(os.listdir(runs / d)) for d in ("dp_full", "dp_resumed")}
    want_files = sorted([f"ckpt_{spe}.pt", f"ckpt_{spe}.pt.json", f"ckpt_{2 * spe}.pt",
                         f"ckpt_{2 * spe}.pt.json", "params_final.pt", "train.jsonl",
                         "train_log.npy"])
    epochs_logged = [sum('"epoch_loss"' in line for line in open(runs / d / "train.jsonl"))
                     for d in ("dp_full", "dp_resumed")]
    row = {"main_path": "cli.pretrain (torch.distributed.run, 2 ranks)", "model": "HSIMAE-B",
           "dtype": "bfloat16", "ranks": DP_RANKS, "backend": reports[0]["backend"],
           "global_batch": PRETRAIN_BATCH, "epoch_loss": full["epoch_loss"],
           "rank_epoch_loss": [r["full"]["epoch_loss"] for r in reports],
           "resumed_epoch_2": resumed["epoch_loss"], "resume_rel": rel, "rtol": RESUME_RTOL,
           "single_process_epoch_1": single_epoch_1, "single_rel": rel_single,
           "single_rtol": DP_SINGLE_RTOL, "global_patches_per_sec": full["patches_per_sec"],
           "note": "both ranks share one card over gloo: not a speed claim",
           "files": files, "epoch_lines_in_train_jsonl": epochs_logged,
           "launches": [r["pretrain_launches"] for r in reports],
           "job_s": job_s, "rank0_full_run_s": reports[0]["full_s"], "card": smi_line}
    print(json.dumps(row), flush=True)
    if rel > RESUME_RTOL or len(resumed["epoch_loss"]) != 1 or rel_single > DP_SINGLE_RTOL:
        fail(f"data-parallel cli.pretrain: the resume or the single-process loss disagrees: "
             f"{row}")
    if any(f != want_files for f in files.values()) or epochs_logged != [2, 2]:
        fail(f"data-parallel cli.pretrain wrote other files than rank 0's: {files}, "
             f"{epochs_logged}")
    if any(any(r["pretrain_launches"].values()) for r in reports):
        fail("data-parallel pretraining launched a block kernel")

    # ---- 15d: NCCL at one rank ----
    t0 = time.perf_counter()
    nccl = launch_ranks(1, "nccl", runs / "nccl_reports", log_dir / "smoke_nccl.log", [],
                        timeout=600)[0]
    loss = nccl["hist"]["epoch_loss"]
    rel_nccl = abs(loss[0] - single_epoch_1) / abs(single_epoch_1)
    row = {"main_path": "cli.pretrain parts (torch.distributed.run, 1 rank)",
           "backend": nccl["backend"], "mesh": nccl["mesh"], "epoch_loss": loss,
           "single_process_epoch_1": single_epoch_1, "rel": rel_nccl, "rtol": RESUME_RTOL,
           "patches_per_sec": nccl["hist"]["patches_per_sec"],
           "job_s": time.perf_counter() - t0, "card": smi_line}
    print(json.dumps(row), flush=True)
    if nccl["backend"] != "nccl" or len(loss) != 1 or rel_nccl > RESUME_RTOL \
            or any(nccl["pretrain_launches"].values()):
        fail(f"the one-rank NCCL run disagrees with phase 9: {row}")

    # ---- 15e: cli.evaluate --dp 2, both dtypes ----
    launches = {"cli.evaluate --dp 2": dict.fromkeys(KERNELS, 0)}
    for dname, argv in MAIN_ARGV.items():
        own = MAIN_KERNEL[dname]
        t0 = time.perf_counter()
        res = cli_evaluate.main(argv + ["--model", "HSIMAE-B", "--dp", str(DP_RANKS)])
        wall = time.perf_counter() - t0
        want = {k: DP_EVAL_LAUNCHES * (k == own) for k in KERNELS}
        agree = float((res.pred_map == scene_maps[dname]).mean())
        row = {"main_path": "cli.evaluate --dp 2", "model": "HSIMAE-B", "dtype": dname,
               "kernel": own, "launches_by_rank": res.launches_by_rank,
               "agreement_with_single_process": agree, "wall_s": wall, "card": smi_line}
        print(json.dumps(row), flush=True)
        if any(r != want for r in res.launches_by_rank):
            fail(f"cli.evaluate --dp 2 {dname}: ranks launched {res.launches_by_rank}, "
                 f"expected {DP_EVAL_LAUNCHES} of {own} each")
        if agree < MIN_AGREEMENT:
            fail(f"cli.evaluate --dp 2 {dname} map agrees with the single process on "
                 f"{agree:.5f} of pixels (< {MIN_AGREEMENT})")
        for r in res.launches_by_rank:
            for k in KERNELS:
                launches["cli.evaluate --dp 2"][k] += r[k]

    # ---- 15f: cli.finetune on 2 ranks ----
    own = MAIN_KERNEL["bfloat16"]
    fts = [r["finetune"] for r in reports]
    scene, params, mcfg, num_classes = fts[0]["reference_inputs"]
    clf = build_classifier(params, mcfg.replace(use_kernel=True), num_classes, device="cuda")
    orig = hsimae_model.fused_encoder_block
    hsimae_model.fused_encoder_block = lambda h, wt, nh: fb.block_reference(
        h, wt if isinstance(wt, fb.BlockParams) else wt.params, nh)
    try:
        ref_map = predict_scene(clf, scene, EvalConfig())
    finally:
        hsimae_model.fused_encoder_block = orig
    agree = float((ref_map == fts[0]["pred_map"]).mean())
    row = {"main_path": "cli.finetune (torch.distributed.run, 2 ranks)", "model": "HSIMAE-B",
           "dtype": "bfloat16", "epochs": DP_FINETUNE_EPOCHS, "kernel": own,
           "dual_steps_by_rank": [f["steps"] for f in fts],
           "val_batch_shares_by_rank": [f["val_batches"] for f in fts],
           "val_launches_by_rank": [f["val_launches"][own] for f in fts],
           "eval_launches_by_rank": [f["eval_launches"] for f in fts],
           "maps_equal_across_ranks": bool((fts[0]["pred_map"] == fts[1]["pred_map"]).all()),
           "agreement_with_block_reference": agree, "val": fts[0]["val"],
           "test": fts[0]["test"], "final_loss": fts[0]["curves"][0][-1],
           "rank0_wall_s": fts[0]["wall_s"],
           "epoch_s_median": sorted(fts[0]["epoch_seconds"])[DP_FINETUNE_EPOCHS // 2],
           "note": "synthetic scene, not the paper's numbers", "card": smi_line}
    print(json.dumps(row), flush=True)
    want_eval = {k: DP_EVAL_LAUNCHES * (k == own) for k in KERNELS}
    if any(f["eval_launches"] != want_eval for f in fts) or \
            any(f["val_launches"][own] != 21 * f["val_batches"] for f in fts):
        fail(f"data-parallel cli.finetune launches are wrong: {row}")
    if not all(math.isfinite(v) for f in fts for c in f["curves"] for v in c) \
            or not row["maps_equal_across_ranks"] or agree < MIN_AGREEMENT:
        fail(f"data-parallel cli.finetune: losses not finite or the --eval map is wrong: {row}")
    launches["cli.finetune --dp val"] = {k: sum(f["val_launches"][k] for f in fts)
                                         for k in KERNELS}
    launches["cli.finetune --dp --eval"] = {k: sum(f["eval_launches"][k] for f in fts)
                                            for k in KERNELS}
    print(json.dumps({"phase": "data_parallel", "seconds": time.perf_counter() - t_phase,
                      "card": smi_line}), flush=True)
    torch.cuda.empty_cache()
    return launches


# ----------------------------- phase 16: the baseline zoo -----------------------------


def zoo_net(name: str, seed: int):
    """(spec, bands, net on the CPU): the registry's net at PaviaU's widths,
    initialised as flax does from ``seed``, its BatchNorm statistics drawn."""
    import torch
    from hsimae_tpu_torch.bench import harness, registry

    spec = registry.get_baseline_spec(name, ZOO_DATASET)
    bands = spec.pca_nc or registry.DATASETS[ZOO_DATASET]["bands"]
    model = harness.build_model(spec, bands, ZOO_CLASSES, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for buf_name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if buf_name.endswith("var")
                      else torch.randn(buf.shape, generator=g) * 0.1)
    return spec, bands, model


def scaled_err_of(got, ref) -> float:
    return ((got.double() - ref.double()).abs() / ref.double().abs().clamp(min=1.0)).max().item()


def worst_of(errs: dict):
    """(key, error) of the largest error, a NaN counted as infinite."""
    key = max(errs, key=lambda k: math.inf if math.isnan(errs[k]) else errs[k])
    return key, math.inf if math.isnan(errs[key]) else errs[key]


def zoo_step(spec, model, x, y, w, mask_seed: int, dtype=None):
    """One harness train step (``make_train_step`` with the spec's
    optimizer) on ``model``'s device, dropout masks drawn on the CPU from
    ``mask_seed``; with ``dtype``, the forward and backward alone in that
    dtype. Returns (loss, gradients on the CPU)."""
    import torch
    from hsimae_tpu_torch.bench import harness
    from hsimae_tpu_torch.models.baselines.common import set_dropout_masks

    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(mask_seed)
    set_dropout_masks(model, lambda shape, keep, d: (torch.rand(tuple(shape), generator=g)
                                                     < keep).to(d))
    if dtype is not None:  # the float64 reference gradient: forward and backward only
        model.train()
        loss = harness.cross_entropy_ignore0(model(x.to(dev, dtype)), y.to(dev), w.to(dev, dtype))
        loss.backward()
    else:
        opt = harness.make_optimizer(spec, model, ZOO_LR)
        loss = harness.make_train_step(model, opt)(x.to(dev), y.to(dev), w.to(dev))
    return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def baseline_zoo(smi_line: str, fb) -> dict:
    """Phase 16: the ten zoo nets on the card against the CPU (eval logits,
    one harness train step), then ``cli.benchmark`` over all ten. Returns
    the benchmark path's launches of each kernel (0 expected)."""
    import copy
    import dataclasses

    import torch
    from hsimae_tpu_torch.bench import harness, registry
    from hsimae_tpu_torch.cli import benchmark as bench_cli
    from hsimae_tpu_torch.data.pipeline import ScenePatchSource, augment_flips, batch_indices
    from hsimae_tpu_torch.data.synthetic import make_synthetic_scene
    from hsimae_tpu_torch.models.baselines.common import MaxPool2d

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(16)
    for name in registry.ALL_BASELINES:
        t0 = time.perf_counter()
        spec, bands, model = zoo_net(name, seed=16)
        ps = spec.patch_size
        # ---- 16a. eval logits, card against CPU ----
        x = torch.rand(ZOO_EVAL_BATCH, ps, ps, bands, generator=gen)
        with torch.no_grad():
            ref = model.eval()(x)
            got = copy.deepcopy(model).to(dev).eval()(x.to(dev)).cpu()
        if not torch.isfinite(got).all():
            fail(f"16a: {name} gave non-finite logits on the card")
        eval_err = scaled_err_of(got, ref)
        # ---- 16b. one harness train step, card against CPU ----
        n = ZOO_STEP_BATCH
        valid = torch.arange(n) < n - ZOO_STEP_PAD
        x = augment_flips(torch.rand(n, ps, ps, bands, generator=gen),
                          flips=(torch.rand(n, generator=gen) < 0.5,
                                 torch.rand(n, generator=gen) < 0.5))
        y = torch.randint(1, ZOO_CLASSES, (n,), generator=gen) * valid
        w = valid.float()
        before, card, ref64 = (copy.deepcopy(model), copy.deepcopy(model).to(dev),
                               copy.deepcopy(model).double())
        for m in card.modules():
            if isinstance(m, MaxPool2d):
                m.record = True
        loss_card, g_card = zoo_step(spec, card, x, y, w, 7)
        # the CPU's steps take the card's max-pool routing: rounding can flip a near-tie;
        # each routed element is held to its float64 window's maximum below
        pools = {k: m.last_route.cpu() for k, m in card.named_modules() if isinstance(m, MaxPool2d)}
        for net in (model, ref64):
            for k, m in net.named_modules():
                if k in pools:
                    m.route = pools[k]
        _, g64 = zoo_step(spec, ref64, x, y, w, 7, torch.float64)
        loss_cpu, g32 = zoo_step(spec, model, x, y, w, 7)
        route_gap = max([m.route_gap for m in ref64.modules() if isinstance(m, MaxPool2d)],
                        default=0.0)
        # gradients: the card's float32 miss of float64 against the CPU's float32 miss
        floor = ZOO_GRAD_FLOOR * max(g.abs().max().item() for g in g64.values())
        grads = {}  # tensor -> (card's miss, CPU's miss, card's miss / its bound)
        for key, ref in g64.items():
            scale = max(ref.abs().max().item(), floor)
            card_miss = (g_card[key].double() - ref).abs().max().item() / scale
            cpu_miss = (g32[key].double() - ref).abs().max().item() / scale
            grads[key] = (card_miss, cpu_miss, card_miss / max(ZOO_TOL, ZOO_GRAD_K * cpu_miss))
        grad_worst, grad_excess = worst_of({k: v[2] for k, v in grads.items()})
        # parameters: the card's step against the CPU's optimizer on the card's gradients,
        # from the same weights; buffers: against the CPU's step
        opt = harness.make_optimizer(spec, before, ZOO_LR)
        for key, p in before.named_parameters():
            p.grad = g_card[key]
        opt.step()
        cpu_state = {**model.state_dict(), **dict(before.named_parameters())}
        worst, step_err = worst_of({key: scaled_err_of(t.cpu(), cpu_state[key].detach())
                                    for key, t in card.state_dict().items()})
        loss_err = abs(loss_card - loss_cpu) / max(1.0, abs(loss_cpu))
        row = {"phase": "zoo card vs cpu", "model": name, "dataset": ZOO_DATASET, "bands": bands,
               "patch": ps, "params": sum(p.numel() for p in model.parameters()),
               "eval_batch": ZOO_EVAL_BATCH, "eval_max_scaled_err": eval_err,
               "step_batch": n, "optimizer": spec.optimizer, "loss_cpu": loss_cpu,
               "loss_card": loss_card, "loss_err": loss_err,
               "grad_card_miss_max": worst_of({k: v[0] for k, v in grads.items()}),
               "grad_cpu_miss_max": worst_of({k: v[1] for k, v in grads.items()}),
               "grad_worst_tensor": grad_worst, "grad_worst_card_cpu_miss": grads[grad_worst][:2],
               "grad_excess": grad_excess, "step_max_scaled_err": step_err,
               "step_worst_tensor": worst, "max_pool_route_gap": route_gap, "tol": ZOO_TOL,
               "seconds": time.perf_counter() - t0, "card": smi_line}
        print(json.dumps(row), flush=True)
        if not (eval_err <= ZOO_TOL and loss_err <= ZOO_TOL and grad_excess <= 1.0
                and step_err <= ZOO_TOL and route_gap <= ZOO_TOL):
            fail(f"16a/b: {name} on the card disagrees with the CPU: {row}")
        del card, before, ref64
        torch.cuda.empty_cache()

    # ---- 16c. cli.benchmark over all ten nets, then one timed run of each ----
    reset_counts(fb)
    t0 = time.perf_counter()
    report = bench_cli.main(ZOO_ARGV + ["--models", *registry.ALL_BASELINES])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    for name in registry.ALL_BASELINES:
        if list(report.get(name, {})) != ZOO_REPORT_KEYS:
            fail(f"16c: cli.benchmark's report for {name} lacks keys: {report.get(name)}")
    # the train-step ms and the full-scene pixels/s: one train_baseline and one
    # evaluate_baseline of each net on the CLI's scene, its convs already warm
    args = bench_cli.build_parser().parse_args(ZOO_ARGV)
    scene, gt = make_synthetic_scene(args.synthetic_size, args.synthetic_size,
                                     bands=args.synthetic_bands,
                                     n_classes=args.synthetic_classes, seed=args.scene_seed)
    n_classes = int(gt.max()) + 1
    for name in registry.ALL_BASELINES:
        spec = dataclasses.replace(registry.get_baseline_spec(name, args.dataset),
                                   epochs=ZOO_TIMED_EPOCHS)
        run, test_gt, scene_p = harness.train_baseline(
            scene, gt, spec, lr=args.lr_grid[0], samples_per_class=args.samples_per_class,
            seed=args.seed, device=dev)
        h = run.history  # epoch 0 warms up
        step_ms = 1e3 * sum(h["train_seconds"][1:]) / sum(h["train_steps"][1:])
        torch.cuda.synchronize()
        t = time.perf_counter()
        harness.evaluate_baseline(run, scene_p, test_gt, spec, n_classes, device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        model = harness.build_model(spec, scene_p.shape[-1], n_classes, run.state, device=dev)
        source = ScenePatchSource(scene_p, spec.patch_size, device=dev)
        finite = torch.stack([torch.isfinite(harness.eval_logits(
            model, source.gather_pixels(chunk))).all() for chunk, _ in batch_indices(
                test_gt.size, 2048, shuffle=False)]).all()
        if not bool(finite):
            fail(f"16c: {name} gave a non-finite logit on the scene")
        print(json.dumps({"phase": "zoo cli.benchmark", "model": name, "train_step_ms": step_ms,
                          "train_steps_timed": sum(h["train_steps"][1:]),
                          "scene_pixels_per_s": test_gt.size / eval_s, "scene_eval_s": eval_s,
                          "oa": report[name]["oa"], "per_seed_oa": report[name]["per_seed_oa"],
                          "card": smi_line}), flush=True)
        del model
        torch.cuda.empty_cache()
    launches = launch_counts(fb)
    if any(launches.values()):
        fail(f"16c: the zoo path launched a fused-block kernel: {launches}")
    print(json.dumps({"phase": "zoo launches", "fused_block_launches": launches}), flush=True)
    print(json.dumps({"phase": "baseline_zoo", "seconds": time.perf_counter() - t_phase,
                      "cli_benchmark_seconds": cli_s, "card": smi_line}), flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1

    from hsimae_tpu_torch.models import hsimae as hsimae_model
    from hsimae_tpu_torch.ops import _build
    from hsimae_tpu_torch.ops import fused_block as fb

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}", flush=True)

    # ---- 2. build ----
    built = _build.build_all()
    for name, sec in built.items():
        print(f"build: {name} {sec:.2f} s (0.00: already built)", flush=True)
        for line in _build.build_log(name).splitlines():
            if "Used " in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for name, widths in (("fused_block_wgmma", (64, 128, 256)), ("fused_block_tf32x3", (64, 128)),
                         ("fused_block_tf32x3_d256", (256,))):
        smem = getattr(_build.load_library(name), f"hsimae_{name}_smem_bytes")
        print(f"  {name} dynamic shared memory per CTA: "
              + ", ".join(f"D {d}: {smem(d)} B" for d in widths), flush=True)

    # ---- 3. kernels against plain version ----
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    dnames = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    max_err = dict.fromkeys(KERNELS, 0.0)

    checks = [(dtype, dname, shape) for dtype, dname in dnames.items() for shape in CHECK_SHAPES]
    checks += [(torch.float32, "float32", shape) for shape in F32_CHECK_SHAPES]
    for dtype, dname, (m, s, d, hid) in checks:
        p = random_block(d, hid, gen, dev)
        x = torch.randn(m, s, d, generator=gen).to(dev, dtype)
        kernel = kernel_of(dname, d)
        w = fb.kernel_weights(p, dtype)
        before = launch_counts(fb)
        got = fb.fused_encoder_block(x, w, d // 16)
        after = launch_counts(fb)
        if {k: after[k] - before[k] for k in KERNELS} != {k: int(k == kernel) for k in KERNELS}:
            fail(f"{dname} at D {d} did not launch {kernel} once: {before} -> {after}")
        err = compare(got, fb.block_reference(x, p, d // 16), dname,
                      {"kernel": kernel, "shape": [m, s, d], "dtype": dname})
        max_err[kernel] = max(max_err[kernel], err)

    # per batch of each main path's model: (kernel, model) -> summed times of its 21 launches
    keys = ("ms", "plain_ms", "modules_ms", "bound_ms")
    per_batch = {(k, model): dict.fromkeys(keys, 0.0)
                 for model, own in MAIN_KERNELS.items() for k in own.values()}
    bound_kinds = {k: set() for k in KERNELS}
    for model, shapes in MAIN_SHAPES.items():
        for dtype, dname in dnames.items():
            for name, (shape, count) in shapes.items():
                row, err = time_case(fb, dtype, dname, name, shape, gen, dev, model=model,
                                     launches_per_batch=count)
                max_err[row["kernel"]] = max(max_err[row["kernel"]], err)
                bound_kinds[row["kernel"]].add(row["bound_by"])
                for k in keys:
                    per_batch[row["kernel"], model][k] += count * row[k]
            torch.cuda.empty_cache()

    # ---- 4, 5, 6. main path, HSIMAE-B, float32 then bfloat16, through the CLI ----
    launches = {}
    launches["cli.evaluate"], scene_maps = scene_main_path(smi_line, fb, hsimae_model, "HSIMAE-B")

    # ---- 11. main path at HSIMAE-L's width, through the CLI ----
    launches["cli.evaluate HSIMAE-L"] = scene_main_path(smi_line, fb, hsimae_model,
                                                        "HSIMAE-L")[0]

    # ---- 8. pretrain steps, card against CPU (float32) ----
    pretrain_step_card_vs_cpu(smi_line)
    torch.cuda.empty_cache()

    # ---- 9. pretraining through the CLI: bf16 (resumed too), then f32 ----
    root = Path(__file__).resolve().parent
    runs = root / "_smoke_runs"
    pretrain_row = cli_pretrain(smi_line, fb, runs)
    launches["cli.pretrain"] = dict.fromkeys(KERNELS, 0)  # checked there: none
    torch.cuda.empty_cache()

    # ---- 10. the kernel on the masked encoder (eval-mode forward_pretrain) ----
    launches["forward_pretrain eval"] = masked_encoder_kernel(smi_line, fb, hsimae_model, gen,
                                                              max_err)

    # ---- 12. fine-tuning: the validation shapes, dual steps, the chain ----
    for dtype, dname in dnames.items():
        for name, (shape, count) in FT_VAL_SHAPES.items():
            row, err = time_case(fb, dtype, dname, name, shape, gen, dev, model="HSIMAE-B",
                                 path="cli.finetune val", launches_per_val_batch=count)
            max_err[row["kernel"]] = max(max_err[row["kernel"]], err)
        torch.cuda.empty_cache()
    dual_step_card_vs_cpu(smi_line, fb)
    torch.cuda.empty_cache()
    ft_launches = [cli_finetune(smi_line, fb, hsimae_model, dname, runs / "bf16" /
                                "params_final.pt", root / "chiprun_out")
                   for dname in ("bfloat16", "float32")]
    for path in ft_launches[0]:
        launches[path] = {k: sum(run[path][k] for run in ft_launches) for k in KERNELS}

    # ---- 13. the protocol, its resume, the evaluate CLI's test split and colormaps ----
    launches.update(cli_protocol(smi_line, fb, hsimae_model, runs / "bf16" / "params_final.pt",
                                 runs, root / "chiprun_out"))

    # ---- 14. serving: export, a fresh process without the model source, --artifact ----
    launches.update(serving(smi_line, fb, runs / "protocol_last.pt", runs, gen, max_err))

    # ---- 15. data parallelism: 2 ranks on the card over gloo, NCCL at one rank ----
    launches.update(data_parallel(smi_line, fb, hsimae_model, runs, root / "chiprun_out",
                                  pretrain_row["steps_per_epoch"],
                                  pretrain_row["epoch_loss"][0], scene_maps))
    shutil.rmtree(runs, ignore_errors=True)

    # ---- 16. the baseline zoo: card against CPU, then cli.benchmark ----
    launches["cli.benchmark"] = baseline_zoo(smi_line, fb)

    # ---- 7. result ----
    # times: per batch of 21 launches of the model whose evaluate path runs
    # the kernel (HSIMAE-B for the D 128 3xTF32 kernel and the bf16 kernel,
    # HSIMAE-L for the D 256 kernel; the bf16 kernel's HSIMAE-L batch
    # beside); launches: the evaluate paths' sum, and per path with the
    # counts set to 0 just before it
    lines = []
    for name, (dname, source, _) in KERNELS.items():
        by_model = {model: per_batch[name, model]
                    for model in MAIN_SHAPES if (name, model) in per_batch}
        times = dict(next(iter(by_model.values())))
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": "hsimae_tpu/ops/fused_block.py:158", "dtype": dname,
                 "launches": launches["cli.evaluate"][name]
                 + launches["cli.evaluate HSIMAE-L"][name],
                 "max_abs_err": max_err[name],
                 "launches_by_path": {path: n[name] for path, n in launches.items()},
                 **times, "per": f"batch of 21 launches of {next(iter(by_model))}",
                 "widths": {"fused_block_tf32x3": [64, 128], "fused_block_tf32x3_d256": [256],
                            "fused_block_wgmma": [64, 128, 256]}[name]}
        entry["share_of_bound"] = times["bound_ms"] / times["ms"]
        if len(by_model) > 1:
            entry["per_batch_by_model"] = by_model
        entry["bound_by"] = "operations" if bound_kinds[name] == {"operations"} else "bytes"
        entry["library_ms"] = None
        lines.append(entry)
    print(json.dumps({"kernels": lines}))
    print(f"nvidia-smi: {smi_line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:  # one rank of a phase-15 job
        sys.exit(rank_job(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())

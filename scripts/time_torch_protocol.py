#!/usr/bin/env python3
"""Wall time of the paper's whole multi-seed protocol on one card.

    python3 scripts/time_torch_protocol.py [--epochs 200] [--workdir _smoke_runs/full_protocol]

Pretrains HSIMAE-B in bf16 as ``chip_smoke.py`` phase 9 does (two epochs
on 24 synthetic scenes, batch 2048), then runs ``hsimae_tpu_torch.cli.finetune
--protocol`` with ``ProtocolConfig``'s defaults (4 lrs x 3 selection seeds,
then 5 test seeds at the best lr: 17 fine-tunes) and the reference recipe
(``--epochs`` a run, 200 by default) on ``chip_smoke.py``'s 145x145
16-class scene. Prints one JSON line per fine-tune (stage, lr, seed, wall
seconds), then one JSON object with the protocol's result, the pretrain's
and the protocol's wall time and the card's name and power limit, as its
last line. The synthetic scene's numbers are not the paper's. The workdir
keeps ``protocol_runs.jsonl``: a second call resumes. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the smoke run's argument lists)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_torch_protocol: needs a CUDA card", file=sys.stderr)
        return 1
    from hsimae_tpu_torch.cli import finetune as cli_finetune
    from hsimae_tpu_torch.cli import pretrain as cli_pretrain
    from hsimae_tpu_torch.train import protocol

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--workdir", default=str(ROOT / "_smoke_runs" / "full_protocol"))
    args = ap.parse_args()
    workdir = Path(args.workdir)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]

    pretrained = workdir / "pretrain" / "params_final.pt"
    t0 = time.perf_counter()
    if not pretrained.exists():
        with contextlib.redirect_stdout(sys.stderr):
            cli_pretrain.main(chip_smoke.PRETRAIN_ARGV + ["--workdir", str(pretrained.parent)])
    pretrain_s = time.perf_counter() - t0

    run_one = protocol._run_one

    def timed(scene_raw, gt, model_cfg, ft_cfg, seed, *a, evaluate, **kw):
        t = time.perf_counter()
        out = run_one(scene_raw, gt, model_cfg, ft_cfg, seed, *a, evaluate=evaluate, **kw)
        torch.cuda.synchronize()
        print(json.dumps({"stage": "test" if evaluate else "select", "lr": ft_cfg.lr,
                          "seed": seed, "wall_s": time.perf_counter() - t}),
              file=sys.__stdout__, flush=True)
        return out

    argv = [a for a in chip_smoke.FINETUNE_ARGV if a != "--eval"] + [
        "--protocol", "--epochs", str(args.epochs), "--pretrained", str(pretrained),
        "--workdir", str(workdir / "protocol")]
    protocol._run_one = timed
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            res = cli_finetune.main(argv)
    finally:
        protocol._run_one = run_one
    protocol_s = time.perf_counter() - t0
    print(json.dumps({
        "protocol": "4 lrs x 3 selection seeds + 5 test seeds", "epochs": args.epochs,
        "best_lr": res.best_lr, "oa_mean": res.oa_mean, "oa_std": res.oa_std,
        "aa_mean": res.aa_mean, "aa_std": res.aa_std, "kappa_mean": res.kappa_mean,
        "kappa_std": res.kappa_std, "pretrain_s": pretrain_s, "protocol_s": protocol_s,
        "note": "synthetic scene, not the paper's numbers", "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

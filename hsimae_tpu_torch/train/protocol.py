"""The multi-seed experiment protocol of the paper's tables.

Counterpart of ``hsimae_tpu/train/protocol.py``: for each learning rate in
the grid, fine-tune with the first ``selection_seeds`` seeds and score the lr
by the mean over seeds of (val OA + val AA + val kappa) / 3; the best lr
(the first in grid order on a tie) is then run with the first ``test_seeds``
seeds, each evaluated on the whole scene's held-out pixels, and the result
is mean ± std (ddof 0) of OA / AA / kappa plus the mean per-class accuracy.

Each seed draws its own few-shot split and its own init. With a
``resume_dir`` every completed run is appended to ``protocol_runs.jsonl``
there (flushed and fsynced) and a restarted protocol skips the runs on
disk; the file's records are the JAX package's, so either package resumes
the other's protocol. Unlike the JAX package, a record appended after a
kill mid-append starts a new line, so it is not lost to the torn one.

One ``pretrained`` dict feeds every run: each run copies it into a model of
its own (``partial_restore``) and never writes to it. Each run's model,
optimizer and kernel weights are dropped when the run returns, so the card
holds one run at a time.

Under a process group (``torch.distributed.run``), every fine-tune and scene
evaluation runs data-parallel by itself (their default mesh), so each rank
runs the same protocol on its share of every batch; rank 0 alone appends
the records.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from hsimae_tpu_torch.config import EvalConfig, FinetuneConfig, ModelConfig, ProtocolConfig
from hsimae_tpu_torch.data.sampling import dual_scene_split
from hsimae_tpu_torch.parallel.mesh import is_main_process
from hsimae_tpu_torch.train.evaluate import evaluate_scene
from hsimae_tpu_torch.train.finetune import dual_branch_finetune
from hsimae_tpu_torch.utils.metrics import Metrics


@dataclasses.dataclass
class ProtocolResult:
    best_lr: float
    selection_scores: Dict[float, float]
    test_metrics: List[Metrics]
    oa_mean: float
    oa_std: float
    aa_mean: float
    aa_std: float
    kappa_mean: float
    kappa_std: float
    per_class_mean: np.ndarray


def _run_one(
    scene_raw: np.ndarray,
    gt: np.ndarray,
    model_cfg: ModelConfig,
    ft_cfg: FinetuneConfig,
    seed: int,
    samples_per_class: int,
    pretrained: Optional[Dict[str, torch.Tensor]],
    gwpca: bool,
    evaluate: bool,
    eval_cfg: EvalConfig,
    device: str | torch.device = "cuda",
):
    """One fine-tune at ``seed`` (split and init), then, with ``evaluate``,
    its full-scene test metrics -> ``(val Metrics, test Metrics or None)``."""
    rng = np.random.default_rng(seed)
    split = dual_scene_split(scene_raw, gt, patch_size=model_cfg.img_size,
                             num=samples_per_class, gwpca=gwpca, nc=model_cfg.bands, rng=rng)
    res = dual_branch_finetune(split, model_cfg, ft_cfg, pretrained=pretrained, seed=seed,
                               device=device)
    test_m = None
    if evaluate:
        test_m = evaluate_scene(split.scene, split.test_gt, res.params, res.model_cfg,
                                res.num_classes, eval_cfg, device=device).metrics
    return res.val_metrics, test_m


def _runs_path(resume_dir: str) -> str:
    return os.path.join(resume_dir, "protocol_runs.jsonl")


def _load_completed(resume_dir: Optional[str]) -> Dict[tuple, dict]:
    """Completed-run records keyed by (stage, lr, seed, spc). Corrupt or
    truncated lines (a kill mid-append) are skipped: that run runs again."""
    done: Dict[tuple, dict] = {}
    if not resume_dir:
        return done
    try:
        with open(_runs_path(resume_dir)) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done[(r["stage"], r["lr"], r["seed"], r["spc"])] = r
                except (json.JSONDecodeError, KeyError):
                    continue
    except OSError:
        pass
    return done


def _append_run(resume_dir: Optional[str], rec: dict) -> None:
    """Append ``rec`` as one line, on a line of its own even after a kill
    mid-append left the last line unterminated. Under data parallelism rank
    0 alone writes."""
    if not resume_dir or not is_main_process():
        return
    os.makedirs(resume_dir, exist_ok=True)
    path = _runs_path(resume_dir)
    lead = ""
    if os.path.exists(path) and os.path.getsize(path):
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            lead = "" if f.read(1) == b"\n" else "\n"
    with open(path, "a") as f:
        f.write(lead + json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def run_protocol(
    scene_raw: np.ndarray,
    gt: np.ndarray,
    model_cfg: ModelConfig,
    ft_cfg: FinetuneConfig = FinetuneConfig(),
    proto: ProtocolConfig = ProtocolConfig(),
    eval_cfg: EvalConfig = EvalConfig(),
    samples_per_class: int = 10,
    pretrained: Optional[Dict[str, torch.Tensor]] = None,
    gwpca: bool = True,
    verbose: bool = True,
    resume_dir: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> ProtocolResult:
    """Stage 1 selects the lr on val; stage 2 tests it over the seeds.
    ``resume_dir`` makes the protocol restartable (module docstring)."""
    done = _load_completed(resume_dir)
    spc = samples_per_class

    def run(lr: float, seed: int, evaluate: bool):
        return _run_one(scene_raw, gt, model_cfg, dataclasses.replace(ft_cfg, lr=lr), seed,
                        samples_per_class, pretrained, gwpca, evaluate=evaluate,
                        eval_cfg=eval_cfg, device=device)

    # stage 1: lr selection on val
    scores: Dict[float, float] = {}
    for lr in proto.lr_grid:
        vals = []
        for seed in proto.seeds[:proto.selection_seeds]:
            key = ("select", lr, seed, spc)
            if key in done:
                vals.append(done[key]["val_mean3"])
                continue
            vm, _ = run(lr, seed, evaluate=False)
            vals.append(vm.mean3)
            _append_run(resume_dir, {"stage": "select", "lr": lr, "seed": seed, "spc": spc,
                                     "val_mean3": vm.mean3})
        scores[lr] = float(np.mean(vals))
        if verbose:
            print(f"[protocol] lr={lr:g}: selection score {scores[lr]:.4f}")
    best_lr = max(scores, key=scores.get)

    # stage 2: the test seeds at the best lr, each scored on the whole scene
    test_ms: List[Metrics] = []
    for seed in proto.seeds[:proto.test_seeds]:
        key = ("test", best_lr, seed, spc)
        if key in done:
            r = done[key]
            tm = Metrics(oa=r["oa"], aa=r["aa"], kappa=r["kappa"],
                         per_class=np.asarray(r["per_class"]))
        else:
            _, tm = run(best_lr, seed, evaluate=True)
            _append_run(resume_dir, {
                "stage": "test", "lr": best_lr, "seed": seed, "spc": spc,
                "oa": tm.oa, "aa": tm.aa, "kappa": tm.kappa,
                "per_class": [float(x) for x in tm.per_class]})
        test_ms.append(tm)
        if verbose:
            print(f"[protocol] seed {seed}: test {tm}")

    oas = np.array([m.oa for m in test_ms])
    aas = np.array([m.aa for m in test_ms])
    kps = np.array([m.kappa for m in test_ms])
    width = max(len(m.per_class) for m in test_ms)
    pcs = np.stack([np.pad(m.per_class, (0, width - len(m.per_class))) for m in test_ms])
    return ProtocolResult(
        best_lr=best_lr, selection_scores=scores, test_metrics=test_ms,
        oa_mean=float(oas.mean()), oa_std=float(oas.std()),
        aa_mean=float(aas.mean()), aa_std=float(aas.std()),
        kappa_mean=float(kps.mean()), kappa_std=float(kps.std()),
        per_class_mean=pcs.mean(axis=0))

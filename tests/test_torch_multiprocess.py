"""Multi-process parallelism of the port on the CPU (gloo), slow tier.

* A ``(2, 2)`` mesh of 4 ranks (data-parallel and tensor-parallel at once)
  runs one dual step of a seeded DualViT on the global batch, each data
  rank on its half of it; its loss and logits equal one process's
  (loss rtol 1e-5, logits rtol 1e-4 / atol 1e-5, as
  ``tests/test_multiprocess.py`` holds the JAX package's mesh).
* ``hsimae_tpu_torch.cli.pretrain`` under ``torch.distributed.run
  --nproc-per-node 2``: two epochs, then a run stopped after epoch 1 and
  resumed by the CLI, whose epoch-2 loss equals the uninterrupted run's
  (rtol 1e-5); the workdir holds one set of files, rank 0's.
"""

import os
import queue
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hsimae_tpu_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.slow  # multi-process tier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_tp_rank(rank, world, port, results):
    import test_torch_parallel as tpar

    torch.set_num_threads(1)
    pmesh.init_distributed(rank, world, f"tcp://localhost:{port}", rank, world, "cpu")
    try:
        mesh = pmesh.make_mesh(data=2, model=2)
        results.put((rank, mesh.get_local_rank("data"), mesh.get_local_rank("model"),
                     tpar.tp_dual_step(mesh)))
    finally:
        pmesh.shutdown_distributed()


def test_dp_tp_mesh_of_four_ranks_matches_one_process():
    import torch.multiprocessing as mp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_parallel as tpar

    want_loss, want_logits, _ = tpar.tp_dual_step()
    results = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_dp_tp_rank, args=(4, _port(), results), nprocs=4, join=False,
                               start_method="spawn")
    got = []
    while len(got) < 4:
        try:
            got.append(results.get(timeout=1.0))
        except queue.Empty:
            procs.join(timeout=0)
    while not procs.join():
        pass
    by_coord = {(d, m): out for _, d, m, out in got}
    for (d, m), (loss, _, sharded) in by_coord.items():
        assert np.isclose(loss, want_loss, rtol=1e-5), (d, m)
        assert sharded[0] == sharded[1] > 0
    for m in (0, 1):  # each data rank's logits are its half of the batch's
        logits = np.concatenate([by_coord[d, m][1] for d in (0, 1)])
        np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=1e-5)


STOPPED = r"""
import sys
from hsimae_tpu_torch.cli import pretrain as cli
from hsimae_tpu_torch.cli.common import join_launched_ranks
from hsimae_tpu_torch.parallel.mesh import shutdown_distributed
from hsimae_tpu_torch.train.pretrain import run_pretraining

args = cli.build_parser().parse_args(sys.argv[1:])
join_launched_ranks(args)
source, index, mcfg, cfg = cli.prepare(args)
run_pretraining(source, index.locs, mcfg, cfg, workdir=args.workdir, resume=False,
                stop_after_epochs=1, device=args.device)
shutdown_distributed()
"""


def test_cli_pretrain_two_ranks_stop_and_resume(tmp_path):
    argv = ["--synthetic", "--synthetic-scenes", "2", "--synthetic-size", "40",
            "--synthetic-bands", "48", "--model", "HSIMAE-S", "--no-bf16", "--batch-size", "64",
            "--epochs", "2", "--coarse-from", "1", "--checkpoint-every", "1", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    script = tmp_path / "stopped.py"
    script.write_text(STOPPED)

    def launch(target, workdir):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
               "--master-port", str(_port()), *target, *argv, "--workdir", str(workdir)]
        out = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                             timeout=900)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        # rank 0 alone prints and writes the run's epoch losses
        assert len(re.findall(r"\[pretrain\] epoch \d+:", out.stdout)) == len(
            np.load(workdir / "train_log.npy", allow_pickle=True)[0])
        return list(np.load(workdir / "train_log.npy", allow_pickle=True)[0])

    full = launch(["-m", "hsimae_tpu_torch.cli.pretrain"], tmp_path / "full")
    assert len(full) == 2
    assert launch([str(script)], tmp_path / "resumed") == full[:1]
    resumed = launch(["-m", "hsimae_tpu_torch.cli.pretrain"], tmp_path / "resumed")
    assert len(resumed) == 1
    np.testing.assert_allclose(resumed[0], full[1], rtol=1e-5)
    files = sorted(os.listdir(tmp_path / "resumed"))
    ckpts = [f for f in files if re.fullmatch(r"ckpt_\d+\.pt", f)]
    assert len(ckpts) == 2 and "params_final.pt" in files and not any(".tmp" in f for f in files)

"""End-to-end quickstart of the PyTorch port: pretrain -> fine-tune ->
evaluate -> export -> serve.

The workflow of ``examples/quickstart.py`` run through the CLIs of
``hsimae_tpu_torch`` on synthetic scenes (no datasets needed) at a tiny
budget: seconds on a CUDA card, a few minutes on the CPU (``--device
cpu``). Swap ``--synthetic`` for ``--scene your_cube.npy --gt your_gt.npy``
(and raise the epochs) for real work.

    python examples/quickstart_torch.py [workdir] [--device cuda|cpu]
"""

import argparse
import os
import pathlib
import sys
import tempfile

# `python examples/quickstart_torch.py` puts examples/ (the script dir) on
# sys.path, not the repo root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main(workdir: str = os.path.join(tempfile.gettempdir(), "hsimae_torch_quickstart"), *,
         device: str = "cuda", scenes: int = 3, scene_size: int = 48,
         pt_epochs: int = 2, ft_epochs: int = 10):
    """The keyword budgets let a test run this exact workflow at a smaller
    size; the defaults are the documented budget. Returns the labels
    served from the exported artifact."""
    wd = pathlib.Path(workdir)
    dev = ["--device", device]

    from hsimae_tpu_torch.cli import evaluate, export, finetune, pretrain

    # 1. MAE pretraining on a synthetic corpus (GWPCA to 32 bands, dense
    #    step-3 cuts, spatial-spectral masking at ratio 0.5)
    pretrain.main([
        "--synthetic", "--synthetic-scenes", str(scenes),
        "--synthetic-size", str(scene_size),
        "--model", "HSIMAE-S", "--epochs", str(pt_epochs),
        "--batch-size", "256",
        "--workdir", str(wd / "pt"), *dev,
    ])

    # 2. Dual-branch fine-tuning: 10 labeled samples a class + the scene's
    #    unlabeled pool (CE on labels + 10x masked reconstruction); writes
    #    finetuned.pt, train_log.npy and finetune_curves.png
    finetune.main([
        "--synthetic", "--samples-per-class", "10",
        "--epochs", str(ft_epochs),
        "--model", "HSIMAE-S",
        "--pretrained", str(wd / "pt" / "params_final.pt"),
        "--workdir", str(wd / "ft"), *dev,
    ])

    # 3. Full-scene per-pixel evaluation (test pixels only) + colormaps.
    #    --seed must match finetune's (default 3407) so the same synthetic
    #    scene is made again and the same train split is zeroed from the gt
    evaluate.main([
        "--synthetic", "--model", "HSIMAE-S",
        "--params", str(wd / "ft" / "finetuned.pt"),
        "--num-classes", "7", "--samples-per-class", "10", "--seed", "3407",
        "--out", str(wd / "maps"), *dev,
    ])

    # 4. Export a deployable artifact (torch.export programs + weights);
    #    int8 weight-only quantization shrinks it ~4x
    export.main([
        "--model", "HSIMAE-S",
        "--params", str(wd / "ft" / "finetuned.pt"),
        "--num-classes", "7", "--batch-sizes", "1", "256",
        "--quantize", "int8",
        "--platforms", "cpu", *(["cuda"] if device.startswith("cuda") else []),
        "--output", str(wd / "model.pt2"), *dev,
    ])

    # 5. Serve from the artifact: no model source needed
    from hsimae_tpu_torch.serving import load_classifier

    clf = load_classifier(str(wd / "model.pt2"), device=device)
    patches = np.random.default_rng(0).standard_normal((5, 9, 9, 32)).astype(np.float32)
    labels = clf.predict(patches)
    print("served labels:", labels)

    # 6. Or run the whole-scene evaluation straight from the artifact
    evaluate.main([
        "--synthetic", "--artifact", str(wd / "model.pt2"),
        "--samples-per-class", "10", "--seed", "3407",
        "--out", str(wd / "maps_artifact"), *dev,
    ])
    return labels


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("workdir", nargs="?", default=os.path.join(tempfile.gettempdir(),
                                                               "hsimae_torch_quickstart"))
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    a = ap.parse_args()
    main(a.workdir, device=a.device)

"""Export a fine-tuned classifier as a self-contained serving artifact.

    python -m hsimae_tpu_torch.cli.export --params runs/ft/finetuned.pt \\
        --num-classes 7 --output runs/model.pt2 --batch-sizes 1 64 1024 \\
        [--platforms cpu cuda] [--params-dtype bfloat16] [--quantize int8]

The flags of ``hsimae_tpu.cli.export``; ``--platforms`` names ``cuda`` where
the JAX CLI names ``tpu``, and the ``cuda`` programs are exported on
``--device``. The artifact (``torch.export`` programs at fixed batch
buckets, the weights and the model metadata in one file) is loaded with
``hsimae_tpu_torch.serving.load_classifier`` and runs on the CPU or the card
without the model source. Prints one JSON line: ``artifact``, ``bytes``,
``batch_sizes``, ``platforms``, ``quantize``.
"""

from __future__ import annotations

import argparse
import json

from hsimae_tpu_torch.checkpoints.convert import load_any_checkpoint
from hsimae_tpu_torch.cli.common import add_model_args, model_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--params", required=True, help=".msgpack, or a torch .pt/.pkl state dict")
    p.add_argument("--num-classes", type=int, required=True,
                   help="including background class 0")
    p.add_argument("--output", required=True, help="artifact path")
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 64, 1024])
    p.add_argument("--platforms", nargs="+", default=["cpu", "cuda"], choices=["cpu", "cuda"])
    p.add_argument("--params-dtype", default=None,
                   help="cast float params before export (e.g. bfloat16 — half the "
                        "artifact/device memory size)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight-only int8 matrices (~4x smaller artifact; dequantized once "
                        "when the artifact is loaded)")
    p.add_argument("--device", default="cuda", help="torch device of the cuda programs")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from hsimae_tpu_torch.serving.export import export_classifier, save_classifier

    mcfg = model_config(args)
    blob = export_classifier(load_any_checkpoint(args.params, mcfg), mcfg, args.num_classes,
                             batch_sizes=args.batch_sizes, platforms=args.platforms,
                             params_dtype=args.params_dtype, quantize=args.quantize,
                             device=args.device)
    path = save_classifier(args.output, blob)
    print(json.dumps({"artifact": path, "bytes": len(blob),
                      "batch_sizes": sorted(set(args.batch_sizes)),
                      "platforms": args.platforms, "quantize": args.quantize}))
    return path


if __name__ == "__main__":
    main()

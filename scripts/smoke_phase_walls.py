#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of a checkout and time each of its stretches of output.

    python3 scripts/smoke_phase_walls.py [--root DIR] [--log FILE]

Runs ``python3 -u chip_smoke.py`` from ``--root`` (default: this repo) and
writes each line of its output, prefixed with the seconds since the start,
to ``--log`` (default ``chiprun_out/smoke_walls.log`` under the root). Works
on any checkout's smoke script, older ones too, since it reads only their
output: each JSON row is labelled by its first key and value (``check:
fused_block``, ``main_path: cli.evaluate``, ``phase: data_parallel``, ...),
runs of rows with the same label form a stretch, and a stretch's seconds run
from the end of the one before it to its own last row (the plain lines in
between count to the stretch they precede). Run two checkouts in one session
on one card and compare their stretches side by side. Prints the smoke
script's last three lines, then one JSON object: its exit code, its wall
seconds and the stretches in order. Exits with the smoke script's code.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def label_of(line: str):
    """The label of a JSON row of the smoke output (None for other lines)."""
    if not line.startswith("{"):
        return None
    try:
        row = json.loads(line)
    except json.JSONDecodeError:
        return None
    if not isinstance(row, dict) or not row:
        return None
    key, value = next(iter(row.items()))
    return f"{key}: {value}" if isinstance(value, str) else key


def stretches(stamped) -> list:
    """[(label, seconds)] from [(seconds since start, line)] in order."""
    out, last_end = [], 0.0
    for t, line in stamped:
        label = label_of(line)
        if label is None:
            continue
        if out and out[-1][0] == label:
            out[-1][1] = t - last_end
        else:
            if out:
                last_end += out[-1][1]
            out.append([label, t - last_end])
    return [(label, round(sec, 2)) for label, sec in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--log", type=Path, default=None)
    args = ap.parse_args()
    log = args.log or args.root / "chiprun_out" / "smoke_walls.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    stamped = []
    with open(log, "w") as f, subprocess.Popen(
            [sys.executable, "-u", "chip_smoke.py"], cwd=args.root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            f.write(f"{t:10.2f} {line}")
            f.flush()
    wall = time.perf_counter() - t0
    for _, line in stamped[-3:]:
        print(line)
    print(json.dumps({"root": str(args.root), "rc": proc.returncode, "wall_s": round(wall, 2),
                      "stretches": stretches(stamped)}))
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())

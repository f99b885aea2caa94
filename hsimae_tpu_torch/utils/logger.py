"""Structured metric logging: a JSONL metric stream plus the reference's
loss-history ``.npy``.

Port-owned copy of ``MetricLogger`` from ``hsimae_tpu/utils/logger.py``,
without ``save_curves_png`` (no matplotlib on the card's machine).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train", echo: bool = True):
        self.log_dir = log_dir
        self.echo = echo
        self._fh = None
        self.history: List[Dict] = []
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.monotonic()

    def log(self, step: Optional[int] = None, **metrics) -> None:
        rec = {"t": round(time.monotonic() - self._t0, 3)}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("t",)
            )
            print(f"[{rec['t']:9.2f}s] {body}", flush=True)

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self.history if key in r]

    def save_history_npy(self, path: str, keys=("train_loss", "val_loss")) -> None:
        """Reference-compatible loss history dump."""
        import numpy as np

        hist = [self.series(k) for k in keys]
        np.save(path, np.array(hist, dtype=object), allow_pickle=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

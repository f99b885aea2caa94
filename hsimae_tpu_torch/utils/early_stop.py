"""Patience-based early stopping with best-state retention.

Counterpart of ``hsimae_tpu/utils/early_stop.py``, with the same first-call
rule: the first metric reported is always the best so far (the reference
leaves its best unset until the first improvement, and fails when the
metric drops at once). The best state is handed back as ``best_value``,
whatever the caller passes as ``value``.
"""

from __future__ import annotations

from typing import Callable, Optional


class EarlyStopping:
    def __init__(self, patience: int = 7, delta: float = 0.0, verbose: bool = False):
        self.patience = patience
        self.delta = delta
        self.verbose = verbose
        self.counter = 0
        self.best_metric: Optional[float] = None
        self.best_value = None
        self.early_stop = False

    def __call__(self, metric: float, value=None, on_improve: Optional[Callable] = None) -> bool:
        """Report a new validation metric. Returns True if training should stop."""
        if self.best_metric is None or metric >= self.best_metric + self.delta:
            if self.verbose and self.best_metric is not None:
                print(f"metric improved ({self.best_metric:.6f} -> {metric:.6f})")
            self.best_metric = metric
            self.best_value = value
            self.counter = 0
            if on_improve is not None:
                on_improve()
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop

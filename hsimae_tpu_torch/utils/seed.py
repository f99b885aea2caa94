"""Seeding of the process-wide generators.

Counterpart of ``seed_everything`` in ``hsimae_tpu/utils/seed.py``. The
port's own draws come from explicit generators and ``np.random.default_rng``
(each injectable); this seeds what a caller might still reach globally:
``PYTHONHASHSEED``, ``random``, numpy's global generator and torch's.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python, numpy and torch; returns a fresh CPU generator seeded
    with ``seed`` (the counterpart of the JAX root key)."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)

"""Learning-rate schedules (counterpart of
`hosnerf_tpu/train/schedules.py`)."""

from __future__ import annotations

import numpy as np


def exp_decay(step, base_lr: float, lrate_decay: int = 500,
              decay_rate: float = 0.1) -> float:
    """Stage-2/3 schedule: lr = base * decay_rate^(step / (lrate_decay *
    1000)), evaluated in float32 as the JAX package does."""
    step = np.float32(step)
    return float(np.float32(base_lr) * np.float32(decay_rate) ** (
        step / np.float32(lrate_decay * 1000.0)))

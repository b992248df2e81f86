"""Learning-rate schedules (counterpart of
`hosnerf_tpu/train/schedules.py`), evaluated in float32 as the JAX package
evaluates them."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def warmup_log_lerp(step, max_steps: int, lr_init: float, lr_final: float,
                    lr_delay_steps: int = 512,
                    lr_delay_mult: float = 0.01) -> float:
    """Stage-1 schedule: a sine warm-up from lr_delay_mult over
    `lr_delay_steps` (none at 0), times a log-linear interpolation from
    lr_init to lr_final over max_steps, held at lr_final beyond it."""
    step = F32(step)
    if lr_delay_steps > 0:
        delay = F32(lr_delay_mult) + F32(1.0 - lr_delay_mult) * np.sin(
            F32(0.5 * np.pi) * np.clip(step / F32(lr_delay_steps), F32(0),
                                       F32(1)))
    else:
        delay = F32(1)
    t = np.clip(step / F32(max_steps), F32(0), F32(1))
    scaled = np.exp(np.log(F32(lr_init)) * (F32(1) - t)
                    + np.log(F32(lr_final)) * t)
    return float(F32(delay) * scaled)


def exp_decay(step, base_lr: float, lrate_decay: int = 500,
              decay_rate: float = 0.1) -> float:
    """Stage-2/3 schedule: lr = base * decay_rate^(step / (lrate_decay *
    1000)), evaluated in float32 as the JAX package does."""
    step = np.float32(step)
    return float(np.float32(base_lr) * np.float32(decay_rate) ** (
        step / np.float32(lrate_decay * 1000.0)))

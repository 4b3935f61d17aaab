"""Learning-rate schedule: linear warmup, then cosine decay.

Port of ``repro/train/schedule.py``, computed in float32 as the reference's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_schedule"]


def make_schedule(train_cfg):
    """``lr(step)`` → a Python float: warmup from peak/warmup (step 0 trains)
    to the peak at ``warmup_steps``, then a cosine to 0 at ``total_steps``."""
    peak = np.float32(train_cfg.learning_rate)
    warmup = max(1, train_cfg.warmup_steps)
    total = max(train_cfg.total_steps, warmup + 1)

    def lr(step) -> float:
        step = np.float32(step)
        if step < warmup:
            return float(peak * (step + np.float32(1.0)) / np.float32(warmup))
        progress = np.clip((step - np.float32(warmup)) / np.float32(total - warmup), 0.0, 1.0)
        return float(np.float32(0.5) * peak * (np.float32(1.0) + np.cos(np.float32(np.pi) * progress)))

    return lr

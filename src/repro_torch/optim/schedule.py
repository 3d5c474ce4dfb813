"""Learning-rate schedules.  Counterpart of ``repro.optim.schedule``."""

from __future__ import annotations

import math


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """step -> learning rate: linear warmup to ``peak_lr`` over
    ``warmup_steps``, then a cosine down to ``floor * peak_lr`` at
    ``total_steps``, flat after it."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return peak_lr * step / max(1, warmup_steps)
        progress = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * progress)))

    return schedule

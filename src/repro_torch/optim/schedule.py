"""Learning-rate schedules (a copy of ``repro.optim.schedule``)."""
from __future__ import annotations

import math


def step_decay(base_lr: float, decay: float, milestones):
    """Paper §V-A: step decay at given epochs."""
    def lr(epoch: int) -> float:
        out = base_lr
        for m in milestones:
            if epoch >= m:
                out *= decay
        return out
    return lr


def cosine(base_lr: float, total_steps: int, warmup: int = 0,
           min_frac: float = 0.1):
    def lr(step: int) -> float:
        if warmup and step < warmup:
            return base_lr * (step + 1) / warmup
        t = (step - warmup) / max(total_steps - warmup, 1)
        t = min(max(t, 0.0), 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))
    return lr

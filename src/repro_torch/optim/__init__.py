"""Optimizers: SGD (+momentum), Adam, LR schedules."""
from repro_torch.optim import optimizers, schedule

__all__ = ["optimizers", "schedule"]

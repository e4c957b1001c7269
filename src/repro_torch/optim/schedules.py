"""LR schedules: linear warmup + cosine decay (port of
``repro.optim.schedules``; paper App. E.1). A schedule maps the optimizer's
step count (an int) to a Python float."""
from __future__ import annotations

import math


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + math.cos(math.pi * prog)))
    return lr

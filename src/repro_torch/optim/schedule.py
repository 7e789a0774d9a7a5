"""LR schedule (``repro/optim/schedule.py``): linear warmup over the first
warmup_frac of steps, then cosine decay to final_frac of the base rate
(paper App. D). Computed on the host: the step is a Python int."""
from __future__ import annotations

import math


def warmup_cosine(step: int, total_steps: int, base_lr: float,
                  warmup_frac: float = 0.1, final_frac: float = 0.1) -> float:
    step = float(step)
    warmup = max(1.0, total_steps * warmup_frac)
    if step < warmup:
        return base_lr * step / warmup
    prog = min(1.0, max(0.0, (step - warmup) / max(1.0, total_steps - warmup)))
    return base_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog)))

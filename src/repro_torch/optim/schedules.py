"""LR schedules, incl. the paper's linear-scaling rule (§5.2: lr 0.1 →
1.0 at 256 workers, i.e. lr ∝ number of workers) —
``repro/optim/schedules.py``.  A schedule maps the integer step to a
float."""
from __future__ import annotations

import math


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step: int) -> float:
        if step < warmup:
            return peak * (step + 1) / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * prog))
    return fn


def linear_scaling_rule(base_lr: float, base_workers: int, workers: int):
    """Paper §5.2: scale the initial LR linearly with worker count."""
    return base_lr * workers / base_workers

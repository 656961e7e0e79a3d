"""Optimizers and LR schedules (``repro/optim``)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    sgd,
)
from repro_torch.optim.schedules import cosine_warmup, linear_scaling_rule
from repro_torch.optim.zero import (
    scheduled_update,
    shard_size,
    zero1,
    zero1_pending,
    zero1_state,
)

__all__ = [
    "Optimizer",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "cosine_warmup",
    "linear_scaling_rule",
    "scheduled_update",
    "sgd",
    "shard_size",
    "zero1",
    "zero1_pending",
    "zero1_state",
]

"""Optimizers as (init, update) pairs over flat name → tensor dicts
(``repro/optim/optimizers.py``).

SGD + momentum is the paper's optimizer (§2.1); AdamW for the LM archs.
State is f32 whatever the param dtype, as in the reference.  ``update``
returns the updates as new tensors; SGD's momentum is new tensors too,
AdamW writes m and v into its state tensors in place and computes the
update in two buffers (with the same elementwise ops in the same order
as the plain expressions, so each product and sum rounds as before) and
returns the same state dicts.  ``apply_updates`` writes the
params in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
import torch.distributed

from repro_torch.core import dependency as dep

Tensors = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], dict]
    update: Callable[[Tensors, dict, Tensors, int], tuple[Tensors, dict]]
    # update(grads, state, params, step) -> (updates, new_state)
    # (inner optimizer, dp size, dp axes) of a ``zero1`` wrapper, else None
    zero1_meta: tuple | None = None
    # a ``zero1`` wrapper's setup(mesh, device): its dp communicator on the
    # mesh, created at once (collective); without it the first update
    # creates one as if the mesh were the world
    zero1_setup: Callable[[Any, Any], None] | None = None


def sgd(lr: Callable[[int], float] | float, momentum: float = 0.9,
        nesterov: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tensors) -> dict:
        return {"mom": {k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()}}

    def update(grads, state, params, step):
        mom = {k: momentum * state["mom"][k] + g.to(torch.float32)
               for k, g in grads.items()}
        if nesterov:
            eff = {k: momentum * mom[k] + g.to(torch.float32)
                   for k, g in grads.items()}
        else:
            eff = mom
        lr_t = lr_fn(step)
        return {k: -lr_t * e for k, e in eff.items()}, {"mom": mom}

    return Optimizer(init, update)


def adamw(lr: Callable[[int], float] | float, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tensors) -> dict:
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": {k: z(p) for k, p in params.items()},
                "v": {k: z(p) for k, p in params.items()}}

    def update(grads, state, params, step):
        t = step + 1.0
        lr_t = lr_fn(step)
        updates = {}
        for k, g in grads.items():
            g32 = g.to(torch.float32)
            m, v = state["m"][k], state["v"][k]
            # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g, in place
            tmp = torch.mul(g32, 1 - b1)
            torch.add(torch.mul(m, b1, out=m), tmp, out=m)
            torch.mul(torch.mul(g32, 1 - b2, out=tmp), g32, out=tmp)
            torch.add(torch.mul(v, b2, out=v), tmp, out=v)
            del tmp
            # -lr (m̂ / (sqrt(v̂) + eps) + wd p), in two buffers: the same
            # ops in the same order as the expression
            u = torch.div(m, 1 - b1 ** t)
            w = torch.div(v, 1 - b2 ** t)
            w.sqrt_().add_(eps)
            u.div_(w)
            torch.mul(params[k].to(torch.float32), weight_decay, out=w)
            updates[k] = u.add_(w).mul_(-lr_t)
        return updates, state

    return Optimizer(init, update)


def _staged_squares(grads: Tensors, staged, stage_group) -> dict[str, torch.Tensor]:
    """Each staged leaf's sum of squares over the whole stack: its layer
    rows' sums (one reduction a row), gathered over the stage axis into
    the stack's layer order, then summed.  Every layout of the stages
    then sums the same vector of rows, bit for bit."""
    names = [k for k in grads if k in staged]
    if not names:
        return {}
    rows = torch.stack([torch.stack([torch.sum(torch.square(r))
                                     for r in grads[k].to(torch.float32)])
                        for k in names])                 # (leaves, layers here)
    if stage_group is not None:
        n = torch.distributed.get_world_size(stage_group)
        full = rows.new_empty((n * rows.shape[0], rows.shape[1]))
        dep.collective(torch.distributed.all_gather_into_tensor, stage_group, full,
                       rows).wait()
        rows = full.view(n, *rows.shape).transpose(0, 1)     # (leaves, stages, here)
    else:
        rows = rows[:, None]
    return {k: torch.sum(rows[j].contiguous().view(-1)) for j, k in enumerate(names)}


def clip_by_global_norm(grads: Tensors, max_norm: float, *,
                        shard_sets: Mapping[str, tuple[str, ...]] | None = None,
                        comms=None, staged: frozenset[str] = frozenset(),
                        stage_group=None) -> tuple[Tensors, torch.Tensor]:
    """Clip by the global grad norm (summed in the dict's order).

    On a mesh ``shard_sets`` maps each leaf sharded over a mesh axis of
    size > 1 to those axes (its spec's ``reduce_key``: "model" under
    tensor parallelism, the dp axes and "model" under FSDP); ``comms``
    (a ``core.dependency.ChainComms``) gives each set's communicator.
    The squares of the leaves of one set are summed over that set's
    ranks, one all-reduce a set, and the replicated leaves' (equal on
    every rank after the sync) counted once, so every rank clips by the
    same, global norm.  (The reference clips by the squares of each
    rank's own shards: ROADMAP queue 3.)

    Under pipeline stages ``staged`` names the leaves whose layer stack is
    sharded over "stage" and ``stage_group`` is the stage communicator
    (None at one stage): their squares are summed a layer row at a time,
    the rows gathered over the stages and summed in layer order
    (``_staged_squares``), so a staged run clips by the norm of its
    stage = 1 twin bit for bit; their ``shard_sets`` key leaves "stage"
    out."""
    shard_sets = shard_sets or {}
    rows = _staged_squares(grads, staged, stage_group)
    parts = [rows[k] if k in rows else torch.sum(torch.square(g.to(torch.float32)))
             for k, g in grads.items()]
    device = parts[0].device
    sharded = torch.zeros((), device=device)
    for key in sorted({shard_sets[k] for k in grads if k in shard_sets}):
        s = sum((p for k, p in zip(grads, parts) if shard_sets.get(k) == key),
                torch.zeros(1, device=device))
        group = comms.get(key)
        if group is not None:
            dep.collective(torch.distributed.all_reduce, group, s).wait()
        sharded = sharded + s[0]
    norm = torch.sqrt(sharded + sum(p for k, p in zip(grads, parts) if k not in shard_sets))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """p ← (p in f32 + u) cast back to p's dtype, in place."""
    for k, p in params.items():
        p.copy_(p.to(torch.float32) + updates[k])

"""Measured per-op replay: a CommSchedule executed one op at a time on a
serial clock, emitting the SAME ``Timeline`` structure the simulator
produces — the port of ``repro/obs/measure.py``.

``execute`` issues the ops on their chains' streams, so ops overlap and
per-op time is invisible from the host.  The replay drives the identical
``_OpEmitter`` one op at a time: each op gets an emitter of its own
whose carried state — the gradient leaves, the RS/UPDATE/SEND shards,
the NORM clip scales and ``pending`` — is handed to it explicitly, and
runs on the current stream between two clock reads (with
``torch.cuda.synchronize`` around it on the card; the host clock alone
on the CPU).  The first run of an op is the one whose outputs are kept,
so at ``reps=1`` the replayed outputs are bit-equal to ``execute``'s
(the reference's profile-on ≡ profile-off guarantee).  ``reps > 1`` runs
each op again on copies of its inputs and keeps the minimum time;
UPDATE ops run once whatever ``reps`` (the port's optimizers update
their state in place, so a second run would not be the same op).

The resulting ``Timeline`` lays ops end-to-end on a serial clock: it
measures per-op cost, not overlap (overlap is what the simulator
models; diffing the two is the point — ``python -m repro_torch.obs
--diff``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import dependency as dep
from repro_torch.core.schedule import (
    ALL_GATHER,
    ALLREDUCE,
    REDUCE_SCATTER,
    UPDATE,
    CommSchedule,
    _OpEmitter,
    itemsize_of,
    op_scope_name,
)
from repro_torch.sim.engine import OpEvent, Timeline
from repro_torch.utils.trees import tree_leaves, tree_unflatten


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def measured_timeline(
    schedule: CommSchedule,
    grads: Any,
    plan: Any,
    *,
    reducer: Callable,
    groups: Mapping[int, Any],
    mesh_shape: Mapping[str, int] | None = None,
    mean_axes: tuple[str, ...] = (),
    use_fused_staging: bool = True,
    loss_scale: float = 1.0,
    two_phase_impl: str = "psum",
    update_fn: Callable | None = None,
    clip_norm: float = 0.0,
    pending: Mapping[int, torch.Tensor] | None = None,
    model_sharded: frozenset[str] = frozenset(),
    device: torch.device = torch.device("cpu"),
    reps: int = 1,
) -> tuple[Any, Timeline, dict[str, Any]]:
    """Replay ``schedule`` over ``grads`` one op at a time.

    Takes ``execute``'s arguments (no streams: every op runs on the
    current stream).  Returns ``(out_tree, timeline, info)`` where
    ``out_tree`` is what ``execute`` would return (the fused path writes
    into ``grads`` in place, as ``execute``), ``timeline`` is a
    ``repro_torch.sim.engine.Timeline`` with one measured ``OpEvent`` per
    IR op (serial clock), and ``info`` carries ``grad_norm``,
    ``update_shards``, the per-op seconds ``per_op_s`` and ``aux`` (what
    ``execute`` would have written into its ``aux``).
    """
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    flat = tree_leaves(grads)
    if len(flat) != plan.num_leaves:
        raise ValueError(
            f"plan built for {plan.num_leaves} leaves, got {len(flat)}")
    itemsize = plan.comm_dtype.itemsize if plan.comm_dtype is not None else 4
    em_kwargs = dict(
        reducer=reducer, groups=groups, mesh_shape=mesh_shape,
        mean_axes=mean_axes, use_fused_staging=use_fused_staging,
        loss_scale=loss_scale, two_phase_impl=two_phase_impl,
        update_fn=update_fn, clip_norm=clip_norm, pending=pending,
        model_sharded=model_sharded, device=device)
    # the last op reading each carried shard or scale: dropped after it
    last_use: dict[int, int] = {}
    for i, op in enumerate(schedule.ops):
        for d in op.depends_on:
            last_use[d] = i

    shards: dict[int, tuple[torch.Tensor, int]] = {}   # op_id -> (shard, n)
    clip_vals: dict[int, torch.Tensor] = {}
    aux: dict[str, Any] = {}
    per_op_s: dict[int, float] = {}
    events: list[OpEvent] = []
    cursor = 0.0

    def emitter(op, run_aux: dict) -> _OpEmitter:
        em = _OpEmitter(schedule, plan, aux=run_aux, **em_kwargs)
        # every dep has run to its end on the serial clock
        em.handles = {d: dep.Handle(dep.DONE, shards[d][0] if d in shards else None)
                      for d in op.depends_on}
        em.shards = {d: (em.handles[d], shards[d][1])
                     for d in op.depends_on if d in shards}
        em.clip_scales = {d: clip_vals[d] for d in op.depends_on if d in clip_vals}
        return em

    for i, op in enumerate(schedule.ops):
        again = reps if op.kind != UPDATE else 1
        saved = ({l.index: flat[l.index].clone() for l in op.bucket.leaves
                  if flat[l.index] is not None} if again > 1 else {})
        run_aux: dict[str, Any] = {}
        em = emitter(op, run_aux)
        with torch.profiler.record_function(op_scope_name(op)):
            t0 = _clock(device)
            em.emit(op, flat)
            dt = _clock(device) - t0
        for _ in range(again - 1):       # on copies: the outputs above stand
            work = list(flat)
            for idx, t in saved.items():
                work[idx] = t.clone()
            em_again = emitter(op, {})
            t0 = _clock(device)
            em_again.emit(op, work)
            dt = min(dt, _clock(device) - t0)
            del work, em_again

        if op.op_id in em.shards:        # RS, UPDATE, SEND: the shard made
            h, n = em.shards[op.op_id]
            shards[op.op_id] = (h.wait(), n)
        if op.op_id in em.clip_scales:
            clip_vals[op.op_id] = em.clip_scales[op.op_id]
        for k, v in run_aux.items():
            if isinstance(v, dict):
                aux.setdefault(k, {}).update(v)
            elif isinstance(v, list):
                aux.setdefault(k, []).extend(v)
            else:
                aux[k] = v
        for d in op.depends_on:
            if last_use[d] == i:
                shards.pop(d, None)
                clip_vals.pop(d, None)
        del em, saved

        nb = op.bucket.size * itemsize_of(op.bucket.comm_dtype, itemsize)
        per_op_s[op.op_id] = dt
        events.append(OpEvent(
            op_id=op.op_id, bucket_id=op.bucket.bucket_id, chain=op.chain,
            kind=op.kind, nbytes=nb, release=cursor, start=cursor,
            end=cursor + dt))
        cursor += dt

    info = {"grad_norm": aux.get("grad_norm"),
            "update_shards": aux.get("update_shards", {}),
            "per_op_s": per_op_s, "aux": aux}
    out = tree_unflatten(plan.treedef, flat)
    return out, Timeline(events=tuple(events), t_fwd=0.0, t_bwd=0.0), info


def measured_gradsync(
    gs, grads: Any, *, update_fn: Callable | None = None,
    clip_norm: float = 0.0, schedule: CommSchedule | None = None,
    pending: Mapping[int, torch.Tensor] | None = None, reps: int = 1,
) -> tuple[Any, Timeline, dict[str, Any]]:
    """``measured_timeline`` wired from a configured ``GradSync`` — the
    measured twin of ``gs(grads)``."""
    return measured_timeline(
        schedule if schedule is not None else gs.schedule,
        grads, gs.plan, reducer=gs.reducer, groups=gs.groups,
        mesh_shape=gs.mesh_shape, mean_axes=gs.cfg.mean_axes,
        use_fused_staging=gs.cfg.use_fused_staging,
        loss_scale=gs.cfg.loss_scale,
        two_phase_impl=gs._two_phase_impl(),
        update_fn=update_fn, clip_norm=clip_norm, pending=pending,
        model_sharded=gs.model_sharded, device=gs.device, reps=reps)


def measurement_rows(
    schedule: CommSchedule, timeline: Timeline,
    mesh_shape: Mapping[str, int],
) -> list[dict[str, Any]]:
    """Flatten a measured Timeline into calibration rows (one dict per
    wire op) for ``repro_torch.obs.calibrate.fit_network``."""
    by_id = {op.op_id: op for op in schedule.ops}
    rows = []
    for ev in timeline.events:
        op = by_id[ev.op_id]
        if op.kind not in (ALLREDUCE, REDUCE_SCATTER, ALL_GATHER):
            continue
        rows.append({
            "kind": op.kind,
            "nbytes": ev.nbytes,
            "axes": tuple(op.bucket.reduce_axes),
            "mesh_shape": dict(mesh_shape),
            "num_leaves": len(op.bucket.leaves),
            "t": ev.duration,
        })
    return rows

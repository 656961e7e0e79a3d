"""StepProgram: the whole training step as one scheduled program — the
port of ``repro/core/stepprogram.py`` (DESIGN.md §9–10).

The ZeRO-1 optimizer step stops being a monolithic post-script and
becomes per-bucket

    reduce_scatter(grad bucket k)  →  UPDATE(shard k)  →  all_gather(k)

op triples whose REDUCE_SCATTER dependency structure is planned by the
same registered strategies that plan the gradient sync, so bucket k's
shard update overlaps bucket k+1's reduce-scatter and earlier buckets'
all-gathers.

  ``zero1_bucket_plan``   — dp-axes bucket plan over ALL gradient leaves
      (f32 wire, ids offset past the sync plan's buckets).
  ``zero1_schedule``      — a strategy's base schedule on that plan
      (allreduce chains, or rsag's RS/AG pairs) rewritten into
      RS→UPDATE→AG triples, with an optional NORM op (the summed squared
      shard norms) gating every UPDATE for global-norm clipping.
  ``build_step_program``  — the sync schedule and the zero1 ops spliced
      into ONE CommSchedule: each zero1 RS also depends on the sync op
      that last produced its leaves.

Executed by ``repro_torch.core.schedule.execute`` (UPDATE ops call the
supplied ``update_fn``).  The plans equal the reference's op for op.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.buckets import Bucket, BucketPlan, make_bucket_plan
from repro_torch.core.schedule import (
    ALL_GATHER,
    NORM,
    POST,
    PRE,
    REDUCE_SCATTER,
    UPDATE,
    CollectiveOp,
    CommSchedule,
)


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """One schedule for the full step: sync + per-bucket ZeRO-1 ops.

    ``plan`` is the leaf-indexed sync BucketPlan (treedef, num_leaves,
    base comm dtype: what ``execute`` needs); ``dp_plan`` holds the zero1
    dp-axes buckets whose RS/UPDATE/AG triples follow the sync ops in
    ``schedule``.
    """

    schedule: CommSchedule
    plan: BucketPlan
    dp_plan: BucketPlan
    dp_axes: tuple[str, ...]
    dp_size: int
    clip: bool
    num_sync_ops: int
    defer_ag: bool = False

    def stats(self) -> dict[str, Any]:
        return self.schedule.stats()

    def post_schedule(self) -> CommSchedule:
        """The ops that run in the step that produced the gradients
        (sync + RS + NORM + UPDATE; plus the AGs unless deferred)."""
        return self.schedule.split_phases()[0]

    def pre_schedule(self) -> CommSchedule:
        """The deferred all-gathers, re-rooted for the NEXT step's top:
        their update shards arrive as carried state
        (``execute(pending=...)``), so every op free-flies."""
        return self.schedule.split_phases()[1]


def zero1_bucket_plan(
    grads_like: Any,
    param_specs: Any,
    mesh,
    *,
    dp_axes: tuple[str, ...],
    bucket_bytes: int = 4 * 1024 * 1024,
    num_channels: int = 1,
    id_offset: int = 0,
) -> BucketPlan:
    """Bucket ALL gradient leaves by their data-parallel reduce axes.

    The wire dtype and every leaf's dtype are pinned to f32, so the
    shard-update math matches the monolithic zero1 optimizer bit for bit
    whatever the sync's comm dtype; bucket ids are offset past the sync
    plan's so the two coexist in one schedule.  Refuses params that are
    already sharded over the dp axes (FSDP keeps its own storage).
    """
    axis_names = tuple(mesh.axis_names)
    exclude = tuple(a for a in axis_names if a not in dp_axes)
    raw = make_bucket_plan(
        grads_like, param_specs, mesh,
        bucket_bytes=bucket_bytes, num_channels=num_channels,
        comm_dtype=torch.float32, exclude_axes=exclude)
    covered = {l.index for b in raw.buckets for l in b.leaves}
    if len(covered) != raw.num_leaves:
        raise ValueError(
            f"ZeRO-1 StepProgram requires every parameter replicated "
            f"over the dp axes {dp_axes} (got {len(covered)} of "
            f"{raw.num_leaves} leaves dp-reducible — params already "
            f"sharded over {dp_axes}, e.g. FSDP, keep their own storage)")
    buckets = tuple(
        dataclasses.replace(
            b,
            bucket_id=b.bucket_id + id_offset,
            comm_dtype=torch.float32,
            leaves=tuple(dataclasses.replace(l, dtype=torch.float32)
                         for l in b.leaves))
        for b in raw.buckets)
    return BucketPlan(buckets=buckets, treedef=raw.treedef,
                      num_leaves=raw.num_leaves, comm_dtype=torch.float32)


def _zero1_ops(
    base: CommSchedule,
    *,
    dp_axes: tuple[str, ...],
    clip: bool,
    start_op_id: int,
    chain_offset: int,
    leaf_deps,
    defer_ag: bool = False,
) -> list[CollectiveOp]:
    """Rewrite a base strategy schedule into RS→UPDATE→AG triples.

    Chain-ordering edges land on the REDUCE_SCATTER ops only: updates and
    all-gathers free-fly behind their own data deps.  With ``defer_ag``
    the all-gathers are tagged PRE: they run at the top of the NEXT step,
    the update shards crossing the boundary as carried state; the
    in-step edges are kept, so the un-split schedule still validates.
    """
    heads = [op for op in base.ops if op.kind != ALL_GATHER]
    rs_of: dict[int, int] = {}          # base op_id -> new RS op_id
    ops: list[CollectiveOp] = []
    oid = start_op_id

    for bop in heads:                   # RS block (chains preserved)
        deps = tuple(rs_of[d] for d in bop.depends_on if d in rs_of)
        extra = leaf_deps(bop.bucket)
        deps = tuple(dict.fromkeys(extra + deps))
        ops.append(CollectiveOp(
            op_id=oid, bucket=bop.bucket, chain=bop.chain + chain_offset,
            depends_on=deps, kind=REDUCE_SCATTER))
        rs_of[bop.op_id] = oid
        oid += 1

    norm_id: int | None = None
    if clip and ops:
        # the global grad norm needs every reduced shard: one scalar
        # all-reduce gating all updates
        norm_bucket = Bucket(
            leaves=(), reduce_axes=tuple(dp_axes),
            channel=max((op.chain for op in ops), default=chain_offset) + 1,
            bucket_id=max(op.bucket.bucket_id for op in ops) + 1,
            comm_dtype=torch.float32)
        norm_id = oid
        ops.append(CollectiveOp(
            op_id=oid, bucket=norm_bucket, chain=norm_bucket.channel,
            depends_on=tuple(rs_of.values()), kind=NORM))
        oid += 1

    for bop in heads:                   # UPDATE + AG per bucket
        rs_id = rs_of[bop.op_id]
        upd_deps = (rs_id,) + ((norm_id,) if norm_id is not None else ())
        ops.append(CollectiveOp(
            op_id=oid, bucket=bop.bucket, chain=bop.chain + chain_offset,
            depends_on=upd_deps, kind=UPDATE))
        ops.append(CollectiveOp(
            op_id=oid + 1, bucket=bop.bucket,
            chain=bop.chain + chain_offset,
            depends_on=(oid,), kind=ALL_GATHER,
            phase=PRE if defer_ag else POST))
        oid += 2
    return ops


def zero1_schedule(
    base: CommSchedule,
    *,
    dp_axes: tuple[str, ...],
    clip: bool = False,
    defer_ag: bool = False,
) -> CommSchedule:
    """The zero1 RS→UPDATE→AG program alone (no sync ops).  ``defer_ag``
    tags the all-gathers PRE (split with ``CommSchedule.split_phases``)."""
    ops = _zero1_ops(base, dp_axes=dp_axes, clip=clip, start_op_id=0,
                     chain_offset=0, leaf_deps=lambda bucket: (),
                     defer_ag=defer_ag)
    return CommSchedule(tuple(ops)).validate()


def build_step_program(
    sync_schedule: CommSchedule,
    sync_plan: BucketPlan,
    base: CommSchedule,
    dp_plan: BucketPlan,
    *,
    dp_axes: tuple[str, ...],
    dp_size: int,
    clip: bool = False,
    defer_ag: bool = False,
) -> StepProgram:
    """Splice sync ops and zero1 RS→UPDATE→AG ops into one schedule.

    Each zero1 reduce-scatter depends on the LAST sync op touching any of
    its leaves (the model-axis sum is what the dp RS consumes); leaves
    with no sync op start as soon as their chain allows.  ``defer_ag``
    builds the pipelined program (``post_schedule``/``pre_schedule``).
    """
    sync_ops = sync_schedule.ops
    n_sync = len(sync_ops)
    chain_offset = (max(op.chain for op in sync_ops) + 1) if sync_ops else 0

    last_touch: dict[str, int] = {}
    for op in sync_ops:
        for leaf in op.bucket.leaves:
            last_touch[leaf.name] = op.op_id

    def leaf_deps(bucket: Bucket) -> tuple[int, ...]:
        return tuple(sorted({last_touch[l.name] for l in bucket.leaves
                             if l.name in last_touch}))

    zops = _zero1_ops(base, dp_axes=dp_axes, clip=clip,
                      start_op_id=n_sync, chain_offset=chain_offset,
                      leaf_deps=leaf_deps, defer_ag=defer_ag)
    schedule = CommSchedule(tuple(sync_ops) + tuple(zops)).validate()
    return StepProgram(
        schedule=schedule, plan=sync_plan, dp_plan=dp_plan,
        dp_axes=tuple(dp_axes), dp_size=dp_size, clip=clip,
        num_sync_ops=n_sync, defer_ag=defer_ag)

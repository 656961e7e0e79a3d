"""Ground-truth-BAD schedules: the analyzer's own test corpus — the port
of ``repro/analysis/mutations.py``.

Each entry injects one known-bad schedule (dropped chain edge,
rank-swapped order, duplicate op id, …) and names the pass + error class
that OWNS it; ``valid_cases`` are the unmutated baselines the analyzer
must pass clean.  Every mutation starts from a schedule a real planner
produced (or the hand-rolled equivalent) and applies one
``dataclasses.replace``-style edit.

This module holds every mutation and valid case that the port's
planners can build: 15 of the reference's 24 mutations and 6 of its 13
valid cases.  The rest build their schedules through planners not
ported yet:

  ROADMAP queue 1 item 8 (``core/stepprogram.py::zero1_schedule``):
    mutations mis-tagged-phase, orphaned-pre-gather, half-written-carry,
    mixed-defer, post-reads-pre, update-bucket-not-f32, donated-pre-read;
    valid cases zero1-concom-defer0, zero1-concom-defer1,
    zero1-rsag-defer0, zero1-rsag-defer1.
  ROADMAP queue 1 item 13 (``core/pipeline_program.py::plan_pipeline``,
  ``compose_step``):
    mutations pp-unmatched-send, pp-boundary-bytes; valid cases
    pp-gpipe, pp-1f1b, pp-1f1b-zero1-joint (which needs item 8 too).

The tests hold the port's passes to the reference's findings on all 24,
building those 9 with the reference and converting them into the port's
IR.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.buckets import Bucket, BucketPlan, LeafInfo
from repro_torch.core.registry import get_strategy
from repro_torch.core.schedule import (
    ALL_GATHER,
    PRE,
    RECV,
    REDUCE_SCATTER,
    REGROUP,
    RESHARD,
    SEND,
    CollectiveOp,
    CommSchedule,
)

MESH = {"data": 8}
PP_MESH = {"data": 8, "stage": 2}
OLD_MESH_RS = {"data": 2, "model": 4}
NEW_MESH_RS = {"data": 2, "model": 2}


def synthetic_plan(n_buckets: int = 4, num_channels: int = 2,
                   leaves_per_bucket: int = 2,
                   pin=None) -> BucketPlan:
    """Round-robin-channel BucketPlan like ``make_bucket_plan`` builds."""
    buckets, idx = [], 0
    for bid in range(n_buckets):
        leaves = tuple(
            LeafInfo(name=f"g{idx + j}", index=idx + j, shape=(4,),
                     dtype=torch.float32, size=4)
            for j in range(leaves_per_bucket))
        idx += leaves_per_bucket
        buckets.append(Bucket(
            leaves=leaves, reduce_axes=("data",),
            channel=bid % num_channels, bucket_id=bid, comm_dtype=pin))
    return BucketPlan(buckets=tuple(buckets), treedef=None,
                      num_leaves=idx, comm_dtype=torch.float32)


def _replace_op(s: CommSchedule, op_id: int, **changes) -> CommSchedule:
    ops = tuple(dataclasses.replace(op, **changes)
                if op.op_id == op_id else op for op in s.ops)
    return CommSchedule(ops)


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One known-bad schedule and the pass/class that must catch it."""

    name: str
    owner: str               # the pass that owns this error class
    code: str                # the Finding.code it must raise
    description: str
    build: Callable[[], tuple[CommSchedule, dict[str, Any]]]
    # build() -> (schedule, run_passes context kwargs)


def _dropped_chain_edge():
    # funnel = ONE serialized chain; dropping an edge leaves two
    # allreduces racing on the same communicator
    s = get_strategy("funnel").plan(synthetic_plan(num_channels=1))
    victim = s.ops[2].op_id
    return _replace_op(s, victim, depends_on=()), {"mesh_shape": MESH}


def _rank_swapped_rs_order():
    # the schedule itself is valid — the divergence is per-rank issue
    # order (one rank runs the MPI_Group funnel backwards)
    s = get_strategy("concom").plan(synthetic_plan(num_channels=1))
    order = tuple(op.op_id for op in s.ops)
    programs = {(r,): order for r in range(MESH["data"])}
    programs[(MESH["data"] - 1,)] = tuple(reversed(order))
    return s, {"mesh_shape": MESH, "rank_programs": programs}


def _unknown_axis():
    s = get_strategy("concom").plan(synthetic_plan())
    op = s.ops[0]
    bad = dataclasses.replace(op.bucket, reduce_axes=("nodata",))
    return _replace_op(s, op.op_id, bucket=bad), {"mesh_shape": MESH}


def _duplicate_op_id():
    s = get_strategy("concom").plan(synthetic_plan())
    dup = dataclasses.replace(s.ops[-1], op_id=s.ops[0].op_id)
    return CommSchedule(s.ops[:-1] + (dup,)), {}


def _dependency_cycle():
    s = get_strategy("funnel").plan(synthetic_plan(num_channels=1))
    first, second = s.ops[0].op_id, s.ops[1].op_id
    return _replace_op(s, first, depends_on=(second,)), {}


def _missing_data_edge():
    # two ops on different channels stage the same leaf with no path —
    # the later one may read the flat-output slot before it is written
    plan = synthetic_plan(n_buckets=2, num_channels=2)
    b0, b1 = plan.buckets
    b1 = dataclasses.replace(b1, leaves=b0.leaves)
    ops = (CollectiveOp(op_id=0, bucket=b0, chain=0),
           CollectiveOp(op_id=1, bucket=b1, chain=1))
    return CommSchedule(ops), {"mesh_shape": MESH}


def _rs_without_consumer():
    s = get_strategy("rsag").plan(synthetic_plan())
    ag = next(op for op in s.ops if op.kind == ALL_GATHER)
    return _replace_op(s, ag.op_id, depends_on=()), {"mesh_shape": MESH}


def _ag_dtype_mismatch():
    s = get_strategy("rsag").plan(synthetic_plan(pin=torch.float32))
    ag = next(op for op in s.ops if op.kind == ALL_GATHER)
    bad = dataclasses.replace(ag.bucket, comm_dtype=torch.bfloat16)
    return _replace_op(s, ag.op_id, bucket=bad), {"mesh_shape": MESH}


def _reducer_tag_on_two_phase():
    s = get_strategy("rsag").plan(synthetic_plan())
    rs = next(op for op in s.ops if op.kind == REDUCE_SCATTER)
    return (_replace_op(s, rs.op_id, reducer="hierarchical"),
            {"mesh_shape": MESH})


def _compressed_int_wire():
    s = get_strategy("concom").plan(synthetic_plan(pin=torch.int8))
    ops = tuple(dataclasses.replace(op, reducer="compressed")
                for op in s.ops)
    return CommSchedule(ops), {"mesh_shape": MESH}


def _unknown_reducer():
    s = get_strategy("concom").plan(synthetic_plan())
    return (_replace_op(s, s.ops[0].op_id, reducer="bogus"),
            {"mesh_shape": MESH})


def synthetic_reshard_schedule(
        streams: tuple[str, ...] = ("param", "inner/m"),
) -> CommSchedule:
    """A hand-rolled elastic transition like ``plan_reshard`` emits:
    per-stream gather RESHARDs (old mesh), ONE REGROUP barrier joining
    them all, then per-stream scatter RESHARDs (new mesh)."""
    def bucket(bid: int, stream: str) -> Bucket:
        leaves = tuple(
            LeafInfo(name=f"{stream}:w{j}", index=j, shape=(16,),
                     dtype=torch.float32, size=16)
            for j in range(2))
        return Bucket(leaves=leaves, reduce_axes=("data",),
                      channel=0, bucket_id=bid, comm_dtype=torch.float32)

    ops: list[CollectiveOp] = []
    for si, stream in enumerate(streams):
        ops.append(CollectiveOp(
            op_id=si, bucket=bucket(si, stream), chain=si,
            kind=RESHARD))
    rg_id = len(streams)
    regroup_bucket = Bucket(
        leaves=(LeafInfo(name="__regroup", index=0, shape=(),
                         dtype=torch.float32, size=1),),
        reduce_axes=("data", "model"), channel=0, bucket_id=rg_id,
        comm_dtype=torch.float32)
    ops.append(CollectiveOp(
        op_id=rg_id, bucket=regroup_bucket, chain=0,
        depends_on=tuple(range(len(streams))), kind=REGROUP))
    for si, stream in enumerate(streams):
        oid = rg_id + 1 + si
        ops.append(CollectiveOp(
            op_id=oid, bucket=bucket(oid, stream), chain=si,
            depends_on=(rg_id,), kind=RESHARD))
    return CommSchedule(tuple(ops))


_RS_CTX = {"old_mesh_shape": OLD_MESH_RS, "new_mesh_shape": NEW_MESH_RS}


def _pre_crosses_regroup():
    # the acceptance-criteria mutation: a deferred op inside a
    # transition schedule reads a carry of the mesh being dissolved
    s = synthetic_reshard_schedule()
    victim = s.ops[-1].op_id
    return _replace_op(s, victim, phase=PRE), dict(_RS_CTX)


def _reshard_leaf_lost():
    # one stream gathered off the old mesh but never scattered onto
    # the new one — state silently dropped across the transition
    s = synthetic_reshard_schedule()
    ops = s.ops[:-1]
    return CommSchedule(ops), dict(_RS_CTX)


def _reshard_op_escapes_regroup():
    # the barrier forgets one gather: the old mesh may dissolve while
    # that RESHARD is still in flight
    s = synthetic_reshard_schedule()
    rg = next(op for op in s.ops if op.kind == REGROUP)
    return (_replace_op(s, rg.op_id,
                        depends_on=tuple(rg.depends_on[1:])),
            dict(_RS_CTX))


def _pp_bucket(bid: int, name: str) -> Bucket:
    return Bucket(
        leaves=(LeafInfo(name=name, index=0, shape=(16,),
                         dtype=torch.float32, size=16),),
        reduce_axes=("stage",), channel=0, bucket_id=bid,
        comm_dtype=torch.float32)


def _pp_crossed_pairs():
    # two boundary crossings interleaved recv-first on both chains:
    # each pair's send transitively waits on the OTHER pair's recv, so
    # neither payload is ever packed (pair B's data edge is necessarily
    # missing — with it the crossing would be an outright cycle)
    ba, bb = _pp_bucket(0, "pp/act/a"), _pp_bucket(1, "pp/act/b")
    ops = (
        CollectiveOp(op_id=0, bucket=bb, chain=1, kind=RECV, shift=1),
        CollectiveOp(op_id=1, bucket=ba, chain=0, depends_on=(0,),
                     kind=SEND, shift=1),
        CollectiveOp(op_id=2, bucket=ba, chain=1, depends_on=(1,),
                     kind=RECV, shift=1),
        CollectiveOp(op_id=3, bucket=bb, chain=0, depends_on=(2,),
                     kind=SEND, shift=1),
    )
    return CommSchedule(ops), {"mesh_shape": PP_MESH}


MUTATIONS: tuple[Mutation, ...] = (
    Mutation("dropped-chain-edge", "spmd", "concurrent-collectives",
             "funnel chain edge removed → two allreduces race on one "
             "communicator", _dropped_chain_edge),
    Mutation("rank-swapped-rs-order", "spmd", "rank-divergence",
             "one rank issues the (valid) schedule in reverse order",
             _rank_swapped_rs_order),
    Mutation("unknown-axis", "spmd", "unknown-axis",
             "op reduces over an axis the mesh does not have",
             _unknown_axis),
    Mutation("duplicate-op-id", "deadlock", "duplicate-op-id",
             "two ops share an op_id", _duplicate_op_id),
    Mutation("dependency-cycle", "deadlock", "cycle",
             "first funnel op made to depend on the second",
             _dependency_cycle),
    Mutation("missing-data-edge", "deadlock", "missing-data-edge",
             "two ops stage the same leaf with no dependency path",
             _missing_data_edge),
    Mutation("rs-without-consumer", "accounting", "rs-unconsumed",
             "reduce-scatter whose shard nothing gathers or updates",
             _rs_without_consumer),
    Mutation("ag-dtype-mismatch", "accounting", "rs-ag-dtype",
             "all-gather disagrees with its producer on the wire dtype",
             _ag_dtype_mismatch),
    Mutation("reducer-tag-on-two-phase", "accounting",
             "ignored-reducer-tag",
             "reducer tag on a REDUCE_SCATTER op (silently ignored by "
             "the emitter)", _reducer_tag_on_two_phase),
    Mutation("compressed-int-wire", "accounting", "comm-dtype-illegal",
             "compressed reducer on an int8 wire (quantizer needs "
             "floats)", _compressed_int_wire),
    Mutation("unknown-reducer", "accounting", "unknown-reducer",
             "op tagged with an unregistered reducer",
             _unknown_reducer),
    Mutation("pp-crossed-pairs", "deadlock", "crossed-send-recv",
             "two SEND/RECV pairs crossed recv-first on both chains "
             "(mutual rendezvous wait)", _pp_crossed_pairs),
    Mutation("pre-crosses-regroup", "reshard", "pre-crosses-regroup",
             "an op tagged PRE inside an elastic transition schedule "
             "(deferred carry crossing the regroup barrier)",
             _pre_crosses_regroup),
    Mutation("reshard-leaf-lost", "reshard", "leaf-lost",
             "a gathered stream never scattered onto the new mesh",
             _reshard_leaf_lost),
    Mutation("reshard-op-escapes-regroup", "reshard",
             "op-escapes-regroup",
             "the REGROUP barrier does not join one old-side gather",
             _reshard_op_escapes_regroup),
)


def valid_cases() -> list[tuple[str, CommSchedule, dict[str, Any]]]:
    """Unmutated baselines the analyzer must pass CLEAN — the zero-
    false-positive half of the corpus contract (the reference's cases
    that the port's planners can build)."""
    out: list[tuple[str, CommSchedule, dict[str, Any]]] = []
    plan = synthetic_plan(n_buckets=6, num_channels=3)
    for name in ("funnel", "concom", "depcha", "priority", "rsag"):
        out.append((name, get_strategy(name).plan(plan),
                    {"mesh_shape": MESH, "expect_defer": False,
                     "plan_comm_dtype": torch.float32}))
    out.append(("reshard-transition", synthetic_reshard_schedule(),
                dict(_RS_CTX)))
    return out

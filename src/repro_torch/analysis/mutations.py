"""Ground-truth-BAD schedules: the analyzer's own test corpus — the port
of ``repro/analysis/mutations.py``.

Each entry injects one known-bad schedule (dropped chain edge,
rank-swapped order, duplicate op id, …) and names the pass + error class
that OWNS it; ``valid_cases`` are the unmutated baselines the analyzer
must pass clean.  Every mutation starts from a schedule a real planner
produced (or the hand-rolled equivalent) and applies one
``dataclasses.replace``-style edit.

This module holds all 24 of the reference's mutations and all 13 of its
valid cases, each built by the port's own planners: the ZeRO-1 ones by
``core/stepprogram.py::zero1_schedule``, the pipeline ones by
``core/pipeline_program.py::plan_pipeline`` and ``compose_step``.  The
tests hold each schedule equal to the reference's, converted into the
port's IR, and the port's passes to the reference's findings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.buckets import Bucket, BucketPlan, LeafInfo
from repro_torch.core.pipeline_program import compose_step, plan_pipeline
from repro_torch.core.registry import get_strategy
from repro_torch.core.schedule import (
    ALL_GATHER,
    ALLREDUCE,
    POST,
    PRE,
    RECV,
    REDUCE_SCATTER,
    REGROUP,
    RESHARD,
    SEND,
    CollectiveOp,
    CommSchedule,
)
from repro_torch.core.stepprogram import zero1_schedule

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


def _zero1(strategy: str = "concom", *, defer: bool,
           clip: bool = False) -> CommSchedule:
    plan = synthetic_plan(pin=torch.float32)
    base = get_strategy(strategy).plan(plan)
    return zero1_schedule(base, dp_axes=("data",), clip=clip,
                          defer_ag=defer)


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


def _mis_tagged_phase():
    # an UPDATE tagged PRE has no carried input to read next step
    s = _zero1(defer=True)
    upd = next(op for op in s.ops if op.kind == "update")
    return _replace_op(s, upd.op_id, phase=PRE), {"expect_defer": True}


def _orphaned_pre_gather():
    # a deferred gather for a bucket no UPDATE produces: the carry slot
    # it reads was never written
    s = _zero1(defer=True)
    ghost = Bucket(
        leaves=(LeafInfo(name="ghost", index=99, shape=(4,),
                         dtype=torch.float32, size=4),),
        reduce_axes=("data",), channel=0, bucket_id=77,
        comm_dtype=torch.float32)
    extra = CollectiveOp(
        op_id=max(op.op_id for op in s.ops) + 1, bucket=ghost,
        chain=0, kind=ALL_GATHER, phase=PRE)
    return CommSchedule(s.ops + (extra,)), {"expect_defer": True}


def _half_written_carry():
    # one bucket's gather dropped while the rest defer: its UPDATE lands
    # in the carry but nothing ever gathers it
    s = _zero1(defer=True)
    victim = next(op.op_id for op in s.ops
                  if op.kind == ALL_GATHER and op.phase == PRE)
    ops = tuple(op for op in s.ops if op.op_id != victim)
    return CommSchedule(ops), {"expect_defer": True}


def _mixed_defer():
    # one gather flipped back to POST while its siblings defer: that
    # bucket is applied in-step AND re-applied from the carry
    s = _zero1(defer=True)
    victim = next(op.op_id for op in s.ops
                  if op.kind == ALL_GATHER and op.phase == PRE)
    return _replace_op(s, victim, phase=POST), {"expect_defer": True}


def _duplicate_op_id():
    s = get_strategy("concom").plan(synthetic_plan())
    dup = dataclasses.replace(s.ops[-1], op_id=s.ops[0].op_id)
    return CommSchedule(s.ops[:-1] + (dup,)), {}


def _dependency_cycle():
    s = get_strategy("funnel").plan(synthetic_plan(num_channels=1))
    first, second = s.ops[0].op_id, s.ops[1].op_id
    return _replace_op(s, first, depends_on=(second,)), {}


def _post_reads_pre():
    # unrolled across steps this is a cycle: the POST op waits on a
    # result that only exists after the step it belongs to finishes
    s = _zero1(defer=True)
    pre_ag = next(op for op in s.ops
                  if op.kind == ALL_GATHER and op.phase == PRE)
    extra = CollectiveOp(
        op_id=max(op.op_id for op in s.ops) + 1, bucket=pre_ag.bucket,
        chain=pre_ag.chain, depends_on=(pre_ag.op_id,),
        kind=ALLREDUCE, phase=POST)
    return CommSchedule(s.ops + (extra,)), {"expect_defer": True}


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


def _update_bucket_not_f32():
    s = _zero1(defer=False)
    upd = next(op for op in s.ops if op.kind == "update")
    bad = dataclasses.replace(upd.bucket, comm_dtype=torch.bfloat16)
    return _replace_op(s, upd.op_id, bucket=bad), {}


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


def _pp_unmatched_send():
    # the final RECV of a 2-stage GPipe round dropped: the cotangent the
    # last stage packed is never delivered — stage 0 waits forever
    s = plan_pipeline(2, 1, kind="gpipe", activation_bytes=64).schedule
    assert s.ops[-1].kind == RECV
    return CommSchedule(s.ops[:-1]), {"mesh_shape": PP_MESH}


def _pp_boundary_bytes():
    # the RECV's bucket half the SEND's size: the two stages disagree on
    # the boundary tensor — the delivered activation would be truncated
    s = plan_pipeline(2, 1, kind="gpipe", activation_bytes=64).schedule
    rcv = next(op for op in s.ops if op.kind == RECV)
    leaf = rcv.bucket.leaves[0]
    half = dataclasses.replace(leaf, shape=(leaf.size // 2,), size=leaf.size // 2)
    bad = dataclasses.replace(rcv.bucket, leaves=(half,))
    return _replace_op(s, rcv.op_id, bucket=bad), {"mesh_shape": PP_MESH}


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


def _donated_pre_read():
    s = _zero1(defer=True)
    pre = next(op for op in s.ops if op.phase == PRE)
    return s, {"expect_defer": True,
               "donated_buckets": frozenset({pre.bucket.bucket_id})}


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
    Mutation("mis-tagged-phase", "carry", "mis-tagged-phase",
             "an UPDATE op tagged PRE (only gathers may defer)",
             _mis_tagged_phase),
    Mutation("orphaned-pre-gather", "carry", "orphaned-pre-gather",
             "deferred gather whose bucket no UPDATE produces",
             _orphaned_pre_gather),
    Mutation("half-written-carry", "carry", "half-written-carry",
             "one bucket's gather dropped while the rest defer",
             _half_written_carry),
    Mutation("mixed-defer", "carry", "mixed-defer",
             "one gather flipped POST while its siblings defer "
             "(double-apply)", _mixed_defer),
    Mutation("duplicate-op-id", "deadlock", "duplicate-op-id",
             "two ops share an op_id", _duplicate_op_id),
    Mutation("dependency-cycle", "deadlock", "cycle",
             "first funnel op made to depend on the second",
             _dependency_cycle),
    Mutation("post-reads-pre", "deadlock", "cross-step-cycle",
             "a POST op depends on a deferred (PRE) result",
             _post_reads_pre),
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
    Mutation("update-bucket-not-f32", "accounting", "update-dtype",
             "UPDATE bucket not pinned to f32 shard math",
             _update_bucket_not_f32),
    Mutation("unknown-reducer", "accounting", "unknown-reducer",
             "op tagged with an unregistered reducer",
             _unknown_reducer),
    Mutation("pp-unmatched-send", "deadlock", "send-unmatched",
             "a pipeline SEND whose RECV was dropped — the payload is "
             "packed but never delivered", _pp_unmatched_send),
    Mutation("pp-crossed-pairs", "deadlock", "crossed-send-recv",
             "two SEND/RECV pairs crossed recv-first on both chains "
             "(mutual rendezvous wait)", _pp_crossed_pairs),
    Mutation("pp-boundary-bytes", "accounting", "send-recv-bytes",
             "stage-boundary RECV sized differently from its SEND",
             _pp_boundary_bytes),
    Mutation("donated-pre-read", "donation", "donated-pre-read",
             "deferred gather reads a bucket whose buffer is donated",
             _donated_pre_read),
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
    false-positive half of the corpus contract."""
    out: list[tuple[str, CommSchedule, dict[str, Any]]] = []
    plan = synthetic_plan(n_buckets=6, num_channels=3)
    for name in ("funnel", "concom", "depcha", "priority", "rsag"):
        out.append((name, get_strategy(name).plan(plan),
                    {"mesh_shape": MESH, "expect_defer": False,
                     "plan_comm_dtype": torch.float32}))
    for strat in ("concom", "rsag"):
        for defer in (False, True):
            out.append((
                f"zero1-{strat}-defer{int(defer)}",
                _zero1(strat, defer=defer, clip=True),
                {"mesh_shape": MESH, "expect_defer": defer,
                 "plan_comm_dtype": torch.float32}))
    out.append(("reshard-transition", synthetic_reshard_schedule(),
                dict(_RS_CTX)))
    for kind in ("gpipe", "1f1b"):
        pp = plan_pipeline(2, 4, kind=kind, activation_bytes=64)
        out.append((f"pp-{kind}", pp.schedule,
                    {"mesh_shape": PP_MESH, "expect_defer": False,
                     "plan_comm_dtype": torch.float32}))
    pp = plan_pipeline(2, 4, kind="1f1b", activation_bytes=64)
    joint, _ = compose_step(pp, _zero1("concom", defer=False))
    out.append(("pp-1f1b-zero1-joint", joint,
                {"mesh_shape": PP_MESH, "expect_defer": False,
                 "plan_comm_dtype": torch.float32}))
    return out

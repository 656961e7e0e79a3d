"""Discrete-event executor for CommSchedule IR — the port of
``repro/sim/engine.py``.

Walks the schedule's chains exactly as the emitter would: an op may
start once (a) every ``depends_on`` op finished (chain serialization:
funnel = 1 chain, concom/priority = ``num_channels`` concurrent chains,
rsag = RS chain + free-flying AGs), (b) its bucket's gradients exist
(``ComputeModel`` release times), and (c) an in-flight slot is free (the
bounded OUTSTANDING window of paper Fig 8).  Op durations come from the
alpha-beta ``NetworkModel``.

For in-scan strategies (depcha) the chain edges are dropped and releases
snap to scan-step boundaries: each layer's sum is issued inside the
backward, gated only by the backward itself — ``drop_chain_deps`` +
``per_stage_release`` in ``SimConfig`` (cross-bucket edges vanish;
same-bucket data edges — RS→UPDATE→AG, and every NORM edge — survive).

Every kind of the IR is priced: an UPDATE the sharded optimizer math
(``ComputeModel.update`` over the 1/group shard), a NORM or REGROUP a
latency-bound scalar allreduce, a RESHARD its all-gather (gather side)
or its local pack and slice (scatter side), a SEND its pack and the
paired RECV the hop plus the unpack, a DECODE an HBM pass over the
node's local parameters.

The run is deterministic: ties break on op_id, no wall-clock, no
randomness — the same schedule always yields the same timeline, bit for
bit the reference's on the same model values (both are float64 over the
same arithmetic in the same order).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Mapping

from repro_torch.core.schedule import (
    ALL_GATHER,
    ALLREDUCE,
    DECODE,
    NORM,
    RECV,
    REDUCE_SCATTER,
    REGROUP,
    RESHARD,
    SEND,
    UPDATE,
    CommSchedule,
)
from repro_torch.sim.compute import ComputeModel
from repro_torch.sim.netmodel import NetworkModel, default_network


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Knobs of one simulation run (strategy semantics + wire format)."""

    window: int = 8              # max collectives in flight (Fig 8 window)
    itemsize: int = 4            # comm dtype bytes (f32=4, bf16=2)
    reducer: str = "flat"        # default reducer for untagged ops
    drop_chain_deps: bool = False    # in-scan: no cross-bucket chains
    per_stage_release: bool = False  # in-scan: release at scan-step ends
    fused_staging: bool = True       # CopyFromTo: fused kernels vs leafwise


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One simulated (or measured) op: the timeline row of a CollectiveOp."""

    op_id: int
    bucket_id: int
    chain: int
    kind: str
    nbytes: int
    release: float      # bucket gradients ready
    start: float        # deps + release + window slot satisfied
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class Timeline:
    """The simulated step: per-op events + step-level metrics."""

    events: tuple[OpEvent, ...]
    t_fwd: float
    t_bwd: float

    @property
    def compute_end(self) -> float:
        return self.t_fwd + self.t_bwd

    @property
    def comm_end(self) -> float:
        return max((e.end for e in self.events), default=0.0)

    @property
    def step_time(self) -> float:
        return max(self.compute_end, self.comm_end)

    @property
    def total_comm(self) -> float:
        return sum(e.duration for e in self.events)

    @property
    def exposed_comm(self) -> float:
        """Communication the step waits on after compute finishes."""
        return max(0.0, self.comm_end - self.compute_end)

    @property
    def overlap_fraction(self) -> float:
        """Share of communication hidden behind compute."""
        if self.total_comm <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.exposed_comm / self.total_comm)

    def stats(self) -> dict:
        return {
            "num_ops": len(self.events),
            "step_time": self.step_time,
            "compute_time": self.compute_end,
            "comm_time": self.total_comm,
            "exposed_comm": self.exposed_comm,
            "overlap_fraction": self.overlap_fraction,
        }


def simulate(
    schedule: CommSchedule,
    mesh_shape: Mapping[str, int],
    *,
    compute: ComputeModel | None = None,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    release_times: Mapping[int, float] | None = None,
) -> Timeline:
    """Execute ``schedule`` as a discrete-event timeline.

    Emits exactly one ``OpEvent`` per CollectiveOp; events are returned
    in start-time order (ties by op_id).

    ``release_times`` (op_id → earliest start) overrides the bucket
    release for the listed ops — pipeline plans use it to gate each
    SEND/RECV on its producing slot's compute end
    (``sim.compute.pipeline_timeline().op_release``), which also keeps a
    pp bucket_id from aliasing a same-numbered sync bucket's release.

    SEND/RECV run with rendezvous semantics: the SEND is the sender's
    local pack (staging only — the payload parks, as the emitter does),
    and the paired RECV — which carries the SEND in its ``depends_on`` —
    is where the hop runs: it starts at max(sender packed, receiver
    ready, release) and pays the p2p wire plus the unpack.
    """
    net = net or default_network()
    sim = sim or SimConfig()
    compute = compute or ComputeModel(t_fwd=0.0, t_bwd=0.0)

    # gradient-ready times come from the wire ops' buckets only: UPDATE/
    # AG ops share their RS bucket (same release), while synthetic
    # buckets (NORM scalar, the flat baseline's full-buffer update) are
    # gated by their deps, not a release of their own.  Each leaf counts
    # ONCE: in a spliced StepProgram the dp buckets re-carry the sync
    # buckets' leaves, and double-counting them would skew both releases.
    seen_leaves: set[str] = set()
    eff_sizes: list[tuple[int, int]] = []
    for bid, bucket in sorted({op.bucket.bucket_id: op.bucket
                               for op in schedule.ops
                               if op.kind in (ALLREDUCE, REDUCE_SCATTER)
                               }.items()):
        fresh = sum(l.size for l in bucket.leaves
                    if l.name not in seen_leaves)
        seen_leaves.update(l.name for l in bucket.leaves)
        eff_sizes.append((bid, fresh))
    releases = compute.bucket_release_times(
        eff_sizes, per_stage=sim.per_stage_release)

    by_id = {op.op_id: op for op in schedule.ops}

    def deps_of(op) -> tuple[int, ...]:
        if not sim.drop_chain_deps:
            return op.depends_on
        # in-scan semantics: only data deps survive — the same bucket's
        # RS→UPDATE→AG spine, every NORM edge, and cross-chain edges (a
        # StepProgram dp RS waiting on the sync op that produces its
        # leaves).  Chain-ordering edges are same-chain by construction.
        return tuple(
            d for d in op.depends_on
            if (op.kind in (ALL_GATHER, UPDATE)
                and by_id[d].bucket.bucket_id == op.bucket.bucket_id)
            or op.kind == NORM or by_id[d].kind == NORM
            or by_id[d].chain != op.chain)

    def itemsize_of(op) -> int:
        # zero1 buckets pin their own wire dtype (f32) independent of
        # the sync schedule's comm dtype
        if op.bucket.comm_dtype is not None:
            return op.bucket.comm_dtype.itemsize
        return sim.itemsize

    def group_of(op) -> int:
        g = 1
        for a in op.bucket.reduce_axes:
            g *= int(mesh_shape.get(a, 1))
        return max(g, 1)

    # elastic transitions: a RESHARD after the first REGROUP is the
    # scatter side — local pack + slice on the NEW mesh, no wire time
    # (the gather side already paid the all-gather)
    first_rg = next((i for i, op in enumerate(schedule.ops)
                     if op.kind == REGROUP), None)
    scatter_ids = frozenset(
        op.op_id for op in (schedule.ops[first_rg + 1:]
                            if first_rg is not None else ())
        if op.kind == RESHARD)

    def duration(op) -> float:
        nbytes = op.bucket.size * itemsize_of(op)
        if op.kind == UPDATE:
            # sharded optimizer math: an HBM pass over the 1/group shard
            return compute.update.update_time(nbytes / group_of(op))
        if op.kind == DECODE:
            # decode-step compute for one node: memory-bandwidth-bound at
            # batch≈1 — an HBM pass over the node's LOCAL param bytes
            # (op.bucket.size carries the local element count)
            return (nbytes / compute.update.hbm_bw
                    + compute.update.overhead)
        if op.kind == SEND:
            # local pack only: the wire move happens at the paired RECV
            return net.staging_time(
                SEND, nbytes, len(op.bucket.leaves),
                fused=sim.fused_staging)
        if op.kind == RECV:
            # rendezvous point: one hop + the unpack
            return net.collective_time(
                RECV, nbytes, op.bucket.reduce_axes,
                mesh_shape) + net.staging_time(
                RECV, nbytes, len(op.bucket.leaves),
                fused=sim.fused_staging)
        if op.kind in (NORM, REGROUP):
            # scalar sum (squared norms / the regroup barrier):
            # latency-bound allreduce
            return net.allreduce_time(
                max(nbytes, sim.itemsize), op.bucket.reduce_axes,
                mesh_shape)
        if op.kind == RESHARD:
            if op.op_id in scatter_ids:
                return net.staging_time(
                    REDUCE_SCATTER, nbytes, len(op.bucket.leaves),
                    fused=sim.fused_staging)
            # gather side: an all-gather of the dp shard + staging out
            return net.collective_time(
                ALL_GATHER, nbytes, op.bucket.reduce_axes, mesh_shape,
                reducer=op.reducer or sim.reducer) + net.staging_time(
                ALL_GATHER, nbytes, len(op.bucket.leaves),
                fused=sim.fused_staging)
        # wire time + the op's share of CopyFromTo staging (pack/unpack;
        # fused vs leafwise is a GradSyncConfig knob the tuner must see)
        return net.collective_time(
            op.kind, nbytes, op.bucket.reduce_axes, mesh_shape,
            reducer=op.reducer or sim.reducer) + net.staging_time(
            op.kind, nbytes, len(op.bucket.leaves),
            fused=sim.fused_staging)

    def release_of(op) -> float:
        if release_times is not None and op.op_id in release_times:
            return release_times[op.op_id]
        return releases.get(op.bucket.bucket_id, compute.t_fwd)

    pending = {op.op_id: len(deps_of(op)) for op in schedule.ops}
    children: dict[int, list[int]] = {}
    dep_ready = {op.op_id: release_of(op) for op in schedule.ops}
    for op in schedule.ops:
        for d in deps_of(op):
            children.setdefault(d, []).append(op.op_id)

    avail: list[tuple[float, int]] = []       # (ready_time, op_id)
    running: list[tuple[float, int]] = []     # (end_time, op_id)
    events: list[OpEvent] = []
    now = 0.0

    for op in schedule.ops:
        if pending[op.op_id] == 0:
            heapq.heappush(avail, (dep_ready[op.op_id], op.op_id))

    def finish_one() -> float:
        nonlocal now
        end, oid = heapq.heappop(running)
        now = max(now, end)
        for child in children.get(oid, ()):
            dep_ready[child] = max(dep_ready[child], end)
            pending[child] -= 1
            if pending[child] == 0:
                heapq.heappush(avail, (dep_ready[child], child))
        return end

    while avail or running:
        if avail and len(running) < sim.window:
            ready_time, oid = avail[0]
            start = max(ready_time, now)
            # a completion before `start` may unlock an earlier-ready op
            if running and running[0][0] <= start:
                finish_one()
                continue
            heapq.heappop(avail)
            now = start
            op = by_id[oid]
            end = start + duration(op)
            heapq.heappush(running, (end, oid))
            events.append(OpEvent(
                op_id=oid, bucket_id=op.bucket.bucket_id, chain=op.chain,
                kind=op.kind, nbytes=op.bucket.size * itemsize_of(op),
                release=release_of(op),
                start=start, end=end))
        else:
            finish_one()

    events.sort(key=lambda e: (e.start, e.op_id))
    return Timeline(events=tuple(events),
                    t_fwd=compute.t_fwd, t_bwd=compute.t_bwd)


@dataclasses.dataclass(frozen=True)
class PipelinedTimeline(Timeline):
    """A deferred-AG (phase-split) step in steady state.

    ``t_fwd``/``t_bwd`` describe the possibly-PUSHED compute (the
    forward start slips when the PRE gathers outrun their overlap
    window), while ``pure_compute`` is what compute alone would take —
    so ``exposed_comm`` counts BOTH ends of the pipeline: time the
    forward waited on last step's gathers at the head, and time the
    step waited on its own sync/RS/update tail.
    """

    pure_compute: float = 0.0

    @property
    def exposed_comm(self) -> float:
        return max(0.0, self.step_time - self.pure_compute)


def simulate_pipelined(
    post: CommSchedule,
    pre: CommSchedule,
    mesh_shape: Mapping[str, int],
    *,
    compute: ComputeModel,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    pre_window: float | None = None,
) -> PipelinedTimeline:
    """Steady-state timeline of one pipelined step.

    ``pre`` holds last step's deferred all-gathers: their update-shard
    inputs were carried across the boundary, so every op is released at
    t=0 and they overlap the forward (and each other).  ``pre_window``
    is the compute time available to hide them — the forward of the
    first microbatch that reads the params (defaults to
    ``compute.t_fwd``); gathers that outrun it push the whole step.
    ``post`` (sync + RS + NORM + UPDATE) then executes against the
    pushed compute's release times exactly like a plain step.
    """
    idle = ComputeModel(t_fwd=0.0, t_bwd=0.0)
    pre_tl = simulate(pre, mesh_shape, compute=idle, net=net, sim=sim)
    window = compute.t_fwd if pre_window is None else pre_window
    push = max(0.0, pre_tl.comm_end - window)
    shifted = dataclasses.replace(compute, t_fwd=compute.t_fwd + push)
    post_tl = simulate(post, mesh_shape, compute=shifted, net=net, sim=sim)
    events = tuple(sorted(pre_tl.events + post_tl.events,
                          key=lambda e: (e.start, e.op_id)))
    return PipelinedTimeline(
        events=events, t_fwd=shifted.t_fwd, t_bwd=compute.t_bwd,
        pure_compute=compute.end)

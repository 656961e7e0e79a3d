"""Pipeline-parallel schedules as CommSchedule programs (DESIGN.md §15)
— the port of ``repro/core/pipeline_program.py``, plan for plan.

The "stage" mesh axis becomes IR territory: one stage-boundary crossing
is a matched SEND/RECV pair (``schedule.SEND``/``schedule.RECV``), and a
whole pipeline schedule — which microbatch each stage forwards or
backwards, in what order — is a CommSchedule whose per-device dependency
chains encode the slot order and whose cross-chain SEND→RECV edges carry
the activations (shift +1) and cotangents (shift -1).

Three schedule kinds:

  gpipe        all forwards, flush, all backwards.  Matches the executed
               wave pipeline in ``parallel/pipeline.py`` — every wave
               is a lockstep ppermute barrier across all stages, which
               the simulator costs as wave-synchronized.
  1f1b         warmup of ``S-1-stage`` forwards, then one-forward/
               one-backward steady state: in-flight microbatches per
               stage never exceed the stage count, and each stage's
               gradients release as soon as ITS last backward retires —
               bucket reduce-scatters overlap the drain bubble.
  interleaved  1F1B over ``n_stages × virtual`` stages: device ``d``
               hosts global (virtual) stages ``{d, d+S, d+2S, ...}``, so
               consecutive global stages sit on consecutive devices and
               every boundary is still a single +1/-1 ppermute hop.
               The bubble shrinks by ~1/virtual.

The 1F1B and interleaved slot orders come from one deterministic list
scheduler over unit-cost slots (prefer-drain: a runnable backward beats
a runnable forward; forwards fill lowest-virtual-chunk first under the
per-stage in-flight cap).  The simulator replays the SAME committed
order with real per-stage times (``repro_torch.sim.compute.
pipeline_timeline``), so the plan and its costing cannot drift.

Composition with the ZeRO-1 StepProgram (§9/§10): ``compose_step``
splices a sync/step schedule after the pipeline ops, wiring each
bucket's first sync op to the final backward of its owning stage
(buckets are reverse key order == output-first == latest global stage
first, so early buckets release earliest under 1F1B).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core.buckets import Bucket, LeafInfo
from repro_torch.core.schedule import (
    ALL_GATHER,
    ALLREDUCE,
    RECV,
    REDUCE_SCATTER,
    SEND,
    CollectiveOp,
    CommSchedule,
)

SCHEDULES = ("gpipe", "1f1b", "interleaved")
STAGE_AXIS = "stage"


@dataclasses.dataclass(frozen=True)
class Slot:
    """One unit of per-microbatch stage compute (schedulable work)."""

    phase: str    # "F" | "B"
    stage: int    # GLOBAL (virtual) stage in [0, n_stages * virtual)
    mb: int


def _schedule_slots(kind: str, n_stages: int, n_microbatches: int,
                    virtual: int) -> list[tuple[int, Slot]]:
    """Global commit order of (device, slot) pairs.

    GPipe: round-robin wave order (the lockstep executed schedule).
    1F1B / interleaved: deterministic unit-cost list scheduling with the
    prefer-drain rule and per-global-stage in-flight cap ``S_tot - g``
    (stage g may hold at most that many live microbatches — the classic
    1F1B warmup bound; max over stages is the stage count).
    """
    S, M, v = n_stages, n_microbatches, virtual
    S_tot = S * v
    if kind == "gpipe":
        if v != 1:
            raise ValueError("gpipe has no interleaved variant (use "
                             "kind='interleaved')")
        commits: list[tuple[int, Slot]] = []
        for w in range(M + S - 1):              # forward waves
            for g in range(S):
                m = w - g
                if 0 <= m < M:
                    commits.append((g, Slot("F", g, m)))
        for w in range(M + S - 1):              # backward waves (reversed)
            for g in range(S - 1, -1, -1):
                m = w - (S - 1 - g)
                if 0 <= m < M:
                    commits.append((g, Slot("B", g, m)))
        return commits

    if kind not in ("1f1b", "interleaved"):
        raise ValueError(f"unknown pipeline schedule {kind!r}")
    if kind == "1f1b" and v != 1:
        raise ValueError("plain 1f1b has virtual=1 (use 'interleaved')")

    dev_of = lambda g: g % S
    # unit-cost event state
    dev_clock = [0.0] * S
    f_arrive: dict[tuple[int, int], float] = {}   # (g, m) -> input ready
    b_arrive: dict[tuple[int, int], float] = {}   # (g, m) -> cotangent ready
    f_done: dict[tuple[int, int], float] = {}
    next_f = [0] * S_tot                          # per global stage
    next_b = [0] * S_tot
    in_flight = [0] * S_tot
    commits = []
    total = 2 * M * S_tot
    while len(commits) < total:
        best = None   # (start, prefer_fwd, g, phase)
        for g in range(S_tot):
            d = dev_of(g)
            if next_b[g] < M and next_b[g] < next_f[g]:
                m = next_b[g]
                if g == S_tot - 1:
                    ready = f_done.get((g, m))
                else:
                    ready = b_arrive.get((g, m))
                if ready is not None:
                    start = max(dev_clock[d], ready)
                    cand = (start, 0, g, "B")
                    if best is None or cand < best:
                        best = cand
            if next_f[g] < M and in_flight[g] < S_tot - g:
                m = next_f[g]
                ready = 0.0 if g == 0 else f_arrive.get((g, m))
                if ready is not None:
                    start = max(dev_clock[d], ready)
                    cand = (start, 1, g, "F")
                    if best is None or cand < best:
                        best = cand
        if best is None:   # pragma: no cover — generator invariant
            raise RuntimeError("pipeline slot scheduler stalled")
        start, _, g, phase = best
        d = dev_of(g)
        end = start + 1.0
        dev_clock[d] = end
        if phase == "F":
            m = next_f[g]
            next_f[g] += 1
            in_flight[g] += 1
            f_done[(g, m)] = end
            if g + 1 < S_tot:
                f_arrive[(g + 1, m)] = end
            commits.append((d, Slot("F", g, m)))
        else:
            m = next_b[g]
            next_b[g] += 1
            in_flight[g] -= 1
            if g > 0:
                b_arrive[(g - 1, m)] = end
            commits.append((d, Slot("B", g, m)))
    return commits


def max_in_flight(plan: "PipelinePlan") -> int:
    """Peak live microbatches on any global stage (issued forwards minus
    retired backwards) — 1F1B's memory bound: ≤ total stage count."""
    live = {}
    peak = 0
    for _, slot in plan.commits:
        live[slot.stage] = live.get(slot.stage, 0) + (
            1 if slot.phase == "F" else -1)
        peak = max(peak, live[slot.stage])
    return peak


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A pipeline schedule lowered to the CommSchedule IR."""

    schedule: CommSchedule
    kind: str
    n_stages: int            # physical stages (mesh axis extent)
    n_microbatches: int
    virtual: int             # virtual stages per device (interleaved)
    stage_axis: str
    activation_bytes: int    # payload per boundary crossing, per rank
    commits: tuple[tuple[int, Slot], ...]      # global commit order
    # op_id -> (role "send"|"recv", slot that produced/consumes it)
    op_slot: Mapping[int, tuple[str, Slot]]

    @property
    def total_stages(self) -> int:
        return self.n_stages * self.virtual

    def final_backward_op(self, stage: int) -> int | None:
        """The last IR op of global ``stage``'s final backward slot (the
        stage's gradient-release point; None for a 1-stage plan)."""
        last = None
        for op_id, (_, slot) in self.op_slot.items():
            if (slot.stage == stage and slot.phase == "B"
                    and slot.mb == self.n_microbatches - 1):
                last = op_id if last is None else max(last, op_id)
        return last


def plan_pipeline(
    n_stages: int,
    n_microbatches: int,
    *,
    kind: str = "1f1b",
    virtual: int = 1,
    activation_bytes: int,
    stage_axis: str = STAGE_AXIS,
    itemsize: int = 4,
    id_offset: int = 0,
    chain_offset: int = 0,
    channel: int = 0,
) -> PipelinePlan:
    """Plan one pipeline schedule as a CommSchedule.

    Per boundary crossing: a SEND on the producing device's chain and a
    RECV on the consuming device's chain (chain = device index — the
    per-stage serialization), the RECV depending on its SEND (the data
    edge the payload rides) and both serialized after the device's
    previous op.  ``activation_bytes`` is the per-rank payload of one
    microbatch's boundary tensor.
    """
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_microbatches < 1:
        raise ValueError(
            f"n_microbatches must be >= 1, got {n_microbatches}")
    commits = _schedule_slots(kind, n_stages, n_microbatches, virtual)
    S_tot = n_stages * virtual
    elems = max(1, int(activation_bytes) // max(1, itemsize))

    ops: list[CollectiveOp] = []
    op_slot: dict[int, tuple[str, Slot]] = {}
    last_on_dev: dict[int, int] = {}
    # (phase, boundary-src stage, mb) -> SEND op_id, for RECV pairing
    sends: dict[tuple[str, int, int], int] = {}
    next_id = id_offset
    next_bucket = 0

    def mk_bucket(name: str) -> Bucket:
        nonlocal next_bucket
        b = Bucket(
            leaves=(LeafInfo(name=name, index=0, shape=(elems,),
                             dtype=torch.float32, size=elems),),
            reduce_axes=(stage_axis,), channel=channel,
            bucket_id=next_bucket)
        next_bucket += 1
        return b

    def emit(dev: int, role: str, slot: Slot, *, shift: int,
             bucket: Bucket, extra_deps: tuple[int, ...] = ()) -> int:
        nonlocal next_id
        deps = tuple(extra_deps)
        if dev in last_on_dev:
            deps = (last_on_dev[dev],) + deps
        op = CollectiveOp(
            op_id=next_id, bucket=bucket, chain=chain_offset + dev,
            depends_on=deps, kind=SEND if role == "send" else RECV,
            shift=shift)
        ops.append(op)
        op_slot[next_id] = (role, slot)
        last_on_dev[dev] = next_id
        next_id += 1
        return op.op_id

    for dev, slot in commits:
        g, m = slot.stage, slot.mb
        if slot.phase == "F":
            if g > 0:
                # receive this microbatch's activation before computing
                send_id = sends[("F", g - 1, m)]
                bucket = ops[send_id - id_offset].bucket
                emit(dev, "recv", slot, shift=1, bucket=bucket,
                     extra_deps=(send_id,))
            if g + 1 < S_tot:
                bucket = mk_bucket(f"pp/act/g{g}/m{m}")
                sends[("F", g, m)] = emit(dev, "send", slot, shift=1,
                                          bucket=bucket)
        else:
            if g + 1 < S_tot:
                send_id = sends[("B", g + 1, m)]
                bucket = ops[send_id - id_offset].bucket
                emit(dev, "recv", slot, shift=-1, bucket=bucket,
                     extra_deps=(send_id,))
            if g > 0:
                bucket = mk_bucket(f"pp/grad/g{g}/m{m}")
                sends[("B", g, m)] = emit(dev, "send", slot, shift=-1,
                                          bucket=bucket)

    schedule = CommSchedule(tuple(ops))
    if ops:
        schedule = schedule.validate()
    return PipelinePlan(
        schedule=schedule, kind=kind, n_stages=n_stages,
        n_microbatches=n_microbatches, virtual=virtual,
        stage_axis=stage_axis, activation_bytes=int(activation_bytes),
        commits=tuple(commits), op_slot=op_slot)


def bucket_stage_map(pp: PipelinePlan, sync: CommSchedule) -> dict[int, int]:
    """sync bucket_id -> owning global stage, reverse-linear: buckets are
    reverse key order (output layers first), so bucket 0 belongs to the
    LAST global stage — the first to retire its backwards under 1F1B."""
    bids = sorted({op.bucket.bucket_id for op in sync.ops
                   if op.kind in (ALLREDUCE, REDUCE_SCATTER, ALL_GATHER)})
    S_tot = pp.total_stages
    n = max(1, len(bids))
    return {bid: S_tot - 1 - min(S_tot - 1, (i * S_tot) // n)
            for i, bid in enumerate(bids)}


def compose_step(
    pp: PipelinePlan, sync: CommSchedule
) -> tuple[CommSchedule, dict[int, int]]:
    """Splice a sync/step schedule after the pipeline program.

    Sync op ids shift past the pipeline ops (internal deps preserved);
    each bucket's FIRST wire op additionally depends on the final
    backward op of the stage owning that bucket, so reduce-scatters
    begin the moment their stage's gradients exist — inside the drain
    bubble under 1F1B.  Returns (joint schedule, old→new sync id map).
    """
    off = len(pp.schedule.ops)
    stage_of = bucket_stage_map(pp, sync)
    id_map = {op.op_id: op.op_id + off for op in sync.ops}
    seen_bucket: set[int] = set()
    out = list(pp.schedule.ops)
    for op in sync.ops:
        deps = tuple(id_map[d] for d in op.depends_on)
        if (op.kind in (ALLREDUCE, REDUCE_SCATTER)
                and op.bucket.bucket_id not in seen_bucket):
            seen_bucket.add(op.bucket.bucket_id)
            rel = pp.final_backward_op(
                stage_of.get(op.bucket.bucket_id, pp.total_stages - 1))
            if rel is not None:
                deps = deps + (rel,)
        out.append(dataclasses.replace(
            op, op_id=id_map[op.op_id], depends_on=deps))
    return CommSchedule(tuple(out)).validate(), id_map

"""The six schedule analysis passes — the port of
``repro/analysis/passes.py``.

Every pass is a pure function ``CommSchedule (+ context) -> [Finding]``:
no devices, no process group — so the passes run on EVERY plan
(``GradSyncConfig.verify``, on by default) before a communicator sees
it.  Reachability is computed once as per-op ancestor bitmasks (python
ints), so the pairwise ordering checks are O(1) lookups.

Wire dtypes in the port's IR are ``torch.dtype``s: the carry and
accounting passes compare them as such (``_dtype_name`` gives numpy's
spelling, so findings read as the reference's).

Error classes are machine-readable ``Finding.code`` strings; the
mutation corpus (``repro_torch.analysis.mutations``) asserts each class
is caught by the pass that owns it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import torch

from repro_torch.core.schedule import (
    ALL_GATHER,
    ALLREDUCE,
    DECODE,
    KINDS,
    NORM,
    PHASES,
    POST,
    PRE,
    RECV,
    REDUCE_SCATTER,
    REGROUP,
    RESHARD,
    SEND,
    UPDATE,
    CommSchedule,
    itemsize_of,
)

PASS_NAMES = ("deadlock", "spmd", "carry", "accounting", "donation",
              "reshard")

# kinds whose issue order on a shared communicator must be rank-uniform
# (an ALL_GATHER is the second half of a matched pair — it attaches to
# its producing RS/UPDATE and free-flies, the paper's OUTSTANDING window;
# a REGROUP barrier is itself a collective every member must reach in
# the same program position)
_SERIAL_KINDS = (ALLREDUCE, REDUCE_SCATTER, NORM, REGROUP)


@dataclasses.dataclass(frozen=True)
class Witness:
    """Printable evidence for one finding (the 'topological witness')."""

    title: str
    lines: tuple[str, ...] = ()

    def render(self) -> str:
        return "\n".join((self.title,) + tuple(f"  {l}" for l in self.lines))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One failed check: which pass, which error class, which ops."""

    pass_name: str
    code: str            # machine-readable error class
    message: str
    ops: tuple[int, ...] = ()
    witness: Witness | None = None

    def render(self) -> str:
        out = f"[{self.pass_name}:{self.code}] {self.message}"
        if self.witness is not None:
            out += "\n" + self.witness.render()
        return out


class ScheduleError(ValueError):
    """A schedule failed static verification (raised by ``verify_schedule``
    and the ``verify=`` planning hooks)."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = tuple(findings)
        super().__init__("\n".join(f.render() for f in self.findings))

    @property
    def pass_name(self) -> str:
        return self.findings[0].pass_name

    @property
    def code(self) -> str:
        return self.findings[0].code


def _dtype_name(d: torch.dtype) -> str:
    """numpy's name for a torch dtype ("float32", "bfloat16", "int8")."""
    return str(d).removeprefix("torch.")


def _f32_default(bucket) -> torch.dtype:
    """A carried shard's dtype: the bucket's pin, else f32."""
    return torch.float32 if bucket.comm_dtype is None else bucket.comm_dtype


def _op_str(op) -> str:
    deps = ",".join(str(d) for d in op.depends_on)
    return (f"op {op.op_id} {op.kind} bucket={op.bucket.bucket_id} "
            f"chain={op.chain} phase={op.phase} deps=[{deps}]")


# ------------------------------------------------------------- structure

def structural_findings(schedule: CommSchedule) -> list[Finding]:
    """Program-order soundness: what ``CommSchedule.validate`` enforces.

    ``validate`` routes through this function (one implementation, two
    entry points) so the shallow check and the analyzer cannot drift.
    """
    out: list[Finding] = []
    seen: set[int] = set()
    all_ids = {op.op_id for op in schedule.ops}
    for op in schedule.ops:
        if op.op_id in seen:
            out.append(Finding(
                "deadlock", "duplicate-op-id",
                f"duplicate op_id {op.op_id}", (op.op_id,)))
        if op.kind not in KINDS:
            out.append(Finding(
                "deadlock", "unknown-kind",
                f"op {op.op_id}: unknown kind {op.kind!r}", (op.op_id,)))
        if op.phase not in PHASES:
            out.append(Finding(
                "deadlock", "unknown-phase",
                f"op {op.op_id}: unknown phase {op.phase!r}", (op.op_id,)))
        if op.bucket.bucket_id < 0:
            out.append(Finding(
                "deadlock", "unknown-bucket",
                f"op {op.op_id}: negative bucket_id "
                f"{op.bucket.bucket_id}", (op.op_id,)))
        for d in op.depends_on:
            if d == op.op_id:
                out.append(Finding(
                    "deadlock", "self-dependency",
                    f"op {op.op_id} depends on itself", (op.op_id,)))
            elif d not in all_ids:
                out.append(Finding(
                    "deadlock", "dangling-dep",
                    f"op {op.op_id} depends on {d}, which is not in the "
                    f"schedule (dangling chain-dep reference)",
                    (op.op_id,)))
            elif d not in seen:
                out.append(Finding(
                    "deadlock", "non-topological",
                    f"op {op.op_id} depends on {d}, which does not "
                    f"precede it (schedule must be topologically "
                    f"ordered)", (op.op_id, d)))
        seen.add(op.op_id)
    return out


def _ancestor_masks(schedule: CommSchedule) -> dict[int, int]:
    """op_id -> bitmask (over tuple positions) of transitive ancestors.

    Only meaningful on structurally sound schedules (deps precede);
    callers gate on ``structural_findings`` first.
    """
    pos = {op.op_id: i for i, op in enumerate(schedule.ops)}
    anc: dict[int, int] = {}
    for op in schedule.ops:
        m = 0
        for d in op.depends_on:
            m |= anc.get(d, 0) | (1 << pos[d])
        anc[op.op_id] = m
    return anc


def _reaches(anc: Mapping[int, int], pos: Mapping[int, int],
             src: int, dst: int) -> bool:
    """True if ``dst`` transitively depends on ``src`` (src →* dst)."""
    return bool(anc.get(dst, 0) >> pos[src] & 1)


def _find_cycle(schedule: CommSchedule) -> list[int] | None:
    """A dependency cycle as an op_id path, or None."""
    deps = {op.op_id: [d for d in op.depends_on
                       if d != op.op_id and any(
                           o.op_id == d for o in schedule.ops)]
            for op in schedule.ops}
    state: dict[int, int] = {}          # 0 unseen / 1 on stack / 2 done
    parent: dict[int, int] = {}

    for root in deps:
        if state.get(root):
            continue
        stack = [(root, iter(deps[root]))]
        state[root] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for d in it:
                if state.get(d, 0) == 1:     # back edge → cycle
                    cyc = [d, node]
                    cur = node
                    while cur != d:
                        cur = parent[cur]
                        cyc.append(cur)
                    return list(reversed(cyc))
                if state.get(d, 0) == 0:
                    state[d] = 1
                    parent[d] = node
                    stack.append((d, iter(deps[d])))
                    advanced = True
                    break
            if not advanced:
                state[node] = 2
                stack.pop()
    return None


# ------------------------------------------------- pass 1: deadlock/cycle

def check_deadlock(schedule: CommSchedule) -> list[Finding]:
    """Cycle / stuck-schedule detection over the union dependency graph:
    chain deps (``depends_on``), data deps (two ops touching the same
    leaf read/write the same slot of the CURRENT flat outputs), and the
    cross-step PRE→POST carry edges (a PRE op's result only exists in
    the NEXT step, so a POST op depending on one can never be released).
    """
    out = structural_findings(schedule)
    by_id = {op.op_id: op for op in schedule.ops}

    # true cycles (possible once op_ids stop being tuple-ordered) — the
    # witness is the cycle path the topological sort gets stuck on
    cyc = _find_cycle(schedule)
    if cyc is not None:
        lines = tuple(_op_str(by_id[i]) for i in cyc)
        out.append(Finding(
            "deadlock", "cycle",
            f"dependency cycle through ops {cyc} — no topological order "
            f"exists; every rank deadlocks waiting on the cycle",
            tuple(cyc),
            Witness("cycle (each op waits on the next):", lines)))
        return out           # reachability is meaningless below a cycle

    # cross-step carry edges: POST(step N) → PRE(executes step N+1) →
    # unrolled, a POST op depending on a PRE op closes a two-step cycle
    pre_ids = {op.op_id for op in schedule.ops if op.phase == PRE}
    for op in schedule.ops:
        bad = pre_ids.intersection(op.depends_on)
        if op.phase != PRE and bad:
            lines = tuple(_op_str(by_id[i]) for i in sorted(bad))
            out.append(Finding(
                "deadlock", "cross-step-cycle",
                f"post op {op.op_id} depends on deferred (PRE) op(s) "
                f"{sorted(bad)} — a deferred result does not exist until "
                f"the next step, so this step can never release it",
                (op.op_id,) + tuple(sorted(bad)),
                Witness("cross-step carry cycle:",
                        (_op_str(op),) + lines)))

    if any(f.code in ("non-topological", "dangling-dep", "duplicate-op-id")
           for f in out):
        return out           # ancestor masks need a sound tuple order

    # data deps: ops sharing a leaf read/write the same flat-output slot
    # — the emitter consumes the CURRENT value, so every later toucher
    # must be ordered after every earlier one (checked pairwise on
    # consecutive touchers; reachability is transitive).  PRE ops read
    # carried state, not the in-step outputs of their leaf-mates.
    anc = _ancestor_masks(schedule)
    pos = {op.op_id: i for i, op in enumerate(schedule.ops)}
    touch: dict[str, list] = {}
    for op in schedule.ops:
        if op.phase == PRE:
            continue
        for leaf in op.bucket.leaves:
            touch.setdefault(leaf.name, []).append(op)
    for name, ops in touch.items():
        for a, b in zip(ops, ops[1:]):
            if not _reaches(anc, pos, a.op_id, b.op_id):
                out.append(Finding(
                    "deadlock", "missing-data-edge",
                    f"ops {a.op_id} and {b.op_id} both stage leaf "
                    f"{name!r} but carry no dependency path — op "
                    f"{b.op_id} may read the slot before op {a.op_id} "
                    f"wrote it",
                    (a.op_id, b.op_id),
                    Witness(f"unordered writers of leaf {name!r}:",
                            (_op_str(a), _op_str(b)))))

    out.extend(_check_rendezvous(schedule, anc, pos))
    return out


def _check_rendezvous(schedule: CommSchedule, anc, pos) -> list[Finding]:
    """SEND/RECV pairing and rendezvous deadlock (DESIGN.md §15).

    A boundary crossing is ONE ppermute executed at the RECV: every SEND
    needs exactly one RECV on the same bucket (and vice versa), and the
    RECV must carry the SEND in ``depends_on`` — the payload's data
    edge, which also makes a crossed rendezvous unconstructible (the
    recv can never precede its send).  When the data edges are missing,
    two pairs can still CROSS: each pair's send transitively waits on
    the OTHER pair's recv, so neither payload is ever packed — each hop
    blocks on a payload only the other hop's completion would produce.
    The op-level graph is acyclic (adding the data edges back closes
    the cycle), so this is checked pairwise on ancestor reachability.
    """
    sends = [op for op in schedule.ops if op.kind == SEND]
    recvs = [op for op in schedule.ops if op.kind == RECV]
    if not sends and not recvs:
        return []
    out: list[Finding] = []
    s_by_bucket: dict[int, list] = {}
    r_by_bucket: dict[int, list] = {}
    for op in sends:
        s_by_bucket.setdefault(op.bucket.bucket_id, []).append(op)
    for op in recvs:
        r_by_bucket.setdefault(op.bucket.bucket_id, []).append(op)

    for bid, ops in sorted(s_by_bucket.items()):
        n_recv = len(r_by_bucket.get(bid, ()))
        if len(ops) > 1 or n_recv > 1:
            out.append(Finding(
                "deadlock", "send-unmatched",
                f"bucket {bid} carries {len(ops)} SEND / {n_recv} RECV "
                f"op(s) — a boundary crossing is exactly one matched "
                f"pair per bucket",
                tuple(o.op_id for o in ops)))
        elif n_recv == 0:
            out.append(Finding(
                "deadlock", "send-unmatched",
                f"SEND {ops[0].op_id} (bucket {bid}) has no matching "
                f"RECV — the packed payload is never moved and the "
                f"receiving stage waits forever",
                (ops[0].op_id,),
                Witness("send without a receiver:", (_op_str(ops[0]),))))
    for bid, ops in sorted(r_by_bucket.items()):
        if bid not in s_by_bucket:
            out.append(Finding(
                "deadlock", "recv-unmatched",
                f"RECV {ops[0].op_id} (bucket {bid}) has no matching "
                f"SEND — there is no payload to move; the ppermute "
                f"blocks every rank of the stage axis",
                tuple(o.op_id for o in ops),
                Witness("recv without a sender:", (_op_str(ops[0]),))))

    pairs: list[tuple] = []            # (send, recv) matched 1:1
    for bid, ops in sorted(s_by_bucket.items()):
        rs = r_by_bucket.get(bid, ())
        if len(ops) == 1 and len(rs) == 1:
            snd, rcv = ops[0], rs[0]
            if snd.op_id not in rcv.depends_on:
                out.append(Finding(
                    "deadlock", "recv-missing-send-edge",
                    f"RECV {rcv.op_id} does not depend on its SEND "
                    f"{snd.op_id} (bucket {bid}) — the hop may execute "
                    f"before the payload is packed",
                    (rcv.op_id, snd.op_id),
                    Witness("pair without the payload data edge:",
                            (_op_str(snd), _op_str(rcv)))))
            if snd.shift != rcv.shift or \
                    snd.bucket.reduce_axes != rcv.bucket.reduce_axes:
                out.append(Finding(
                    "deadlock", "send-recv-shift-mismatch",
                    f"SEND {snd.op_id} (shift={snd.shift}, "
                    f"axes={snd.bucket.reduce_axes}) and RECV "
                    f"{rcv.op_id} (shift={rcv.shift}, "
                    f"axes={rcv.bucket.reduce_axes}) disagree on the "
                    f"hop — the two halves describe different "
                    f"ppermutes", (snd.op_id, rcv.op_id)))
            pairs.append((snd, rcv))

    # crossed rendezvous: pair A's send waits on pair B's recv AND pair
    # B's send waits on pair A's recv — with the data edges this would
    # be a cycle (caught above); without them only this pairwise
    # reachability check sees it.  Valid plans always carry the data
    # edges, which make t(recv) ≥ t(send) and the pattern impossible.
    for i, (sa, ra) in enumerate(pairs):
        for sb, rb in pairs[i + 1:]:
            if _reaches(anc, pos, rb.op_id, sa.op_id) and \
                    _reaches(anc, pos, ra.op_id, sb.op_id):
                out.append(Finding(
                    "deadlock", "crossed-send-recv",
                    f"SEND/RECV pairs (buckets "
                    f"{sa.bucket.bucket_id}, {sb.bucket.bucket_id}) "
                    f"are crossed: each pair's send transitively waits "
                    f"on the other pair's recv, so neither payload is "
                    f"ever packed — both hops block forever",
                    (sa.op_id, ra.op_id, sb.op_id, rb.op_id),
                    Witness("crossed rendezvous pairs:",
                            (_op_str(sa), _op_str(ra),
                             _op_str(sb), _op_str(rb)))))
    return out


# --------------------------------------------- pass 2: SPMD consistency

def _family(reducer: str) -> str:
    """Reducer family prefix: 'hierarchical_ring' → 'hierarchical'."""
    if not reducer:
        return "flat"
    for fam in ("hierarchical", "compressed", "ring", "flat"):
        if reducer == fam or reducer.startswith(fam + "_"):
            return fam
    return reducer


def reducer_stages(op, default_reducer: str = "flat",
                   ) -> tuple[tuple[str, tuple[str, ...]], ...]:
    """The wire collectives one op expands into, per reducer family —
    what each rank actually issues on the network (DESIGN.md §3, §8)."""
    axes = op.bucket.reduce_axes
    if op.kind in (UPDATE, DECODE):
        return ()                       # local math, no wire payload
    if op.kind == SEND:
        return ()                       # local pack; the RECV hops
    if op.kind == RECV:
        # the pair's single wire event: the ppermute every rank of the
        # stage axis joins at the RECV
        return (("ppermute", axes),)
    if op.kind != ALLREDUCE:
        return ((op.kind, axes),)
    fam = _family(op.reducer or default_reducer)
    if fam == "hierarchical" and "pod" in axes and "data" in axes:
        rest = tuple(a for a in axes if a not in ("pod", "data"))
        stages = ((REDUCE_SCATTER, ("data",)), (ALLREDUCE, ("pod",)),
                  (ALL_GATHER, ("data",)))
        return stages + (((ALLREDUCE, rest),) if rest else ())
    if fam == "compressed":
        # quantize → all-to-all int8 shards → local reduce → all-gather
        return (("all_to_all", axes), (ALL_GATHER, axes))
    return ((ALLREDUCE, axes),)


def _groups_of(rank: tuple[int, ...], axes: tuple[str, ...],
               axis_names: tuple[str, ...]) -> tuple:
    """The communicator instance ``rank`` belongs to for a collective
    over ``axes``: its coordinates on the complement axes."""
    return tuple((a, c) for a, c in zip(axis_names, rank) if a not in axes)


def check_spmd(
    schedule: CommSchedule,
    mesh_shape: Mapping[str, int] | None = None,
    *,
    default_reducer: str = "flat",
    rank_programs: Mapping[tuple[int, ...], Sequence[int]] | None = None,
) -> list[Finding]:
    """SPMD-consistency: every rank of a communicator group must issue
    the same collective sequence per channel.

    Two checks:
      (1) serialization — ALLREDUCE / REDUCE_SCATTER / NORM ops on one
          communicator (reduce_axes, channel) must be totally ordered by
          dependency paths.  An unordered pair means two engine chains
          can issue on the same communicator in either order — ranks may
          disagree, the paper's funnel-vs-concurrent deadlock.  Matched
          second-phase ALL_GATHERs are exempt: they attach to their
          producing RS/UPDATE and free-fly (the OUTSTANDING window).
      (2) per-rank issue simulation — each rank's issue order
          (``rank_programs`` override, else the shared schedule order)
          is expanded through the reducer families' stage collectives
          and grouped by communicator *instance*; every member of an
          instance must see the identical sequence.  This is where
          hierarchical/compressed stage structure and KVStore barrier
          joins are checked on real group boundaries.
    """
    out: list[Finding] = []
    if structural_findings(schedule):
        return out           # ordering checks need a sound tuple order

    by_id = {op.op_id: op for op in schedule.ops}
    anc = _ancestor_masks(schedule)
    pos = {op.op_id: i for i, op in enumerate(schedule.ops)}

    if mesh_shape is not None:
        for op in schedule.ops:
            missing = [a for a in op.bucket.reduce_axes
                       if a not in mesh_shape]
            if missing:
                out.append(Finding(
                    "spmd", "unknown-axis",
                    f"op {op.op_id} reduces over axes {missing} absent "
                    f"from the mesh {dict(mesh_shape)}", (op.op_id,)))

    # (1) total serialization per communicator (reduce_axes, channel)
    comms: dict[tuple, list] = {}
    for op in schedule.ops:
        if op.kind in _SERIAL_KINDS:
            key = (op.bucket.reduce_axes, op.bucket.channel)
            comms.setdefault(key, []).append(op)
    for (axes, channel), ops in comms.items():
        for a, b in zip(ops, ops[1:]):
            if not _reaches(anc, pos, a.op_id, b.op_id):
                seq_a = [o.op_id for o in ops if o.chain == a.chain]
                seq_b = [o.op_id for o in ops if o.chain == b.chain]
                out.append(Finding(
                    "spmd", "concurrent-collectives",
                    f"ops {a.op_id} and {b.op_id} issue on the same "
                    f"communicator (axes={axes}, channel={channel}) "
                    f"with no dependency path — ranks may issue them "
                    f"in different orders and deadlock (the "
                    f"funnel-vs-concurrent hazard)",
                    (a.op_id, b.op_id),
                    Witness(
                        f"unordered collectives on (axes={axes}, "
                        f"channel={channel}):",
                        (_op_str(a), _op_str(b),
                         f"chain {a.chain} issues: {seq_a}",
                         f"chain {b.chain} issues: {seq_b}"))))

    # (2) per-rank issue sequences per communicator INSTANCE
    if mesh_shape is not None and not out:
        axis_names = tuple(mesh_shape)
        sizes = [int(mesh_shape[a]) for a in axis_names]
        ranks: list[tuple[int, ...]] = [()]
        for s in sizes:
            ranks = [r + (c,) for r in ranks for c in range(s)]
        if rank_programs is None:
            order = tuple(op.op_id for op in schedule.ops)
            rank_programs = {r: order for r in ranks}
        seqs: dict[tuple, dict[tuple[int, ...], list[tuple]]] = {}
        for rank in ranks:
            for oid in rank_programs.get(rank, ()):
                op = by_id.get(oid)
                if op is None:
                    continue
                for si, (kind, axes) in enumerate(
                        reducer_stages(op, default_reducer)):
                    if any(a not in mesh_shape for a in axes):
                        continue       # reported above as unknown-axis
                    inst = (axes, op.bucket.channel,
                            _groups_of(rank, axes, axis_names))
                    sig = (op.bucket.bucket_id, kind, si, op.bucket.size)
                    seqs.setdefault(inst, {}).setdefault(
                        rank, []).append(sig)
        for inst, per_rank in seqs.items():
            ref_rank = min(per_rank)
            ref = per_rank[ref_rank]
            for rank, seq in per_rank.items():
                if seq != ref:
                    axes, channel, group = inst
                    out.append(Finding(
                        "spmd", "rank-divergence",
                        f"ranks {ref_rank} and {rank} issue different "
                        f"collective sequences on communicator "
                        f"(axes={axes}, channel={channel}, "
                        f"group={group}) — mismatched collectives "
                        f"deadlock the group",
                        (),
                        Witness(
                            f"per-rank issue sequences on axes={axes} "
                            f"channel={channel}:",
                            (f"rank {ref_rank}: {ref}",
                             f"rank {rank}: {seq}"))))
                    break
    return out


# ------------------------------------------------ pass 3: carry soundness

def check_carry(schedule: CommSchedule, *,
                expect_defer: bool | None = None) -> list[Finding]:
    """Soundness of the cross-step carry (``zero1_plan="deferred"``).

    In steady state the SAME program runs every step, so the predecessor
    schedule is the schedule itself: every PRE ALL_GATHER must be
    covered by a POST UPDATE producing the same bucket / dtype / shard
    size, and the two bucket sets must match EXACTLY — a PRE gather
    without an UPDATE reads ``opt_state["pending"]`` uninitialized; an
    UPDATE whose gather neither ran in-step nor deferred leaves the
    carry half-written (or double-applies under a mixed split).
    """
    out: list[Finding] = []
    pre_ops = [op for op in schedule.ops if op.phase == PRE]
    if expect_defer is False and pre_ops:
        out.append(Finding(
            "carry", "unexpected-defer",
            f"schedule carries {len(pre_ops)} PRE op(s) but was planned "
            f"without defer_ag — nothing will execute them next step",
            tuple(op.op_id for op in pre_ops)))

    for op in pre_ops:
        if op.kind != ALL_GATHER:
            out.append(Finding(
                "carry", "mis-tagged-phase",
                f"op {op.op_id} ({op.kind}) is tagged PRE — only "
                f"ALL_GATHER ops may defer across the step boundary "
                f"(their shard inputs ride opt_state['pending']); a "
                f"deferred {op.kind} has no carried input to read",
                (op.op_id,)))

    pre_ags = [op for op in pre_ops if op.kind == ALL_GATHER]
    seen: dict[int, int] = {}
    for op in pre_ags:
        if op.bucket.bucket_id in seen:
            out.append(Finding(
                "carry", "duplicate-pre-gather",
                f"ops {seen[op.bucket.bucket_id]} and {op.op_id} both "
                f"defer a gather of bucket {op.bucket.bucket_id} — the "
                f"carry holds ONE shard per bucket",
                (seen[op.bucket.bucket_id], op.op_id)))
        seen.setdefault(op.bucket.bucket_id, op.op_id)

    updates = {op.bucket.bucket_id: op for op in schedule.ops
               if op.kind == UPDATE and op.phase == POST}
    by_id = {op.op_id: op for op in schedule.ops}

    for op in pre_ags:
        upd = updates.get(op.bucket.bucket_id)
        if upd is None:
            out.append(Finding(
                "carry", "orphaned-pre-gather",
                f"PRE all-gather {op.op_id} reads bucket "
                f"{op.bucket.bucket_id} from the carry, but no POST "
                f"UPDATE produces that bucket's shard — "
                f"opt_state['pending'] would be read uninitialized",
                (op.op_id,),
                Witness("deferred gather without a producer:",
                        (_op_str(op),
                         f"POST UPDATE buckets: {sorted(updates)}"))))
            continue
        if upd.bucket.size != op.bucket.size:
            out.append(Finding(
                "carry", "carry-shard-mismatch",
                f"PRE gather {op.op_id} expects {op.bucket.size} "
                f"elements of bucket {op.bucket.bucket_id} but UPDATE "
                f"{upd.op_id} produces {upd.bucket.size}",
                (op.op_id, upd.op_id)))
        d_pre, d_upd = _f32_default(op.bucket), _f32_default(upd.bucket)
        if d_pre != d_upd:
            out.append(Finding(
                "carry", "carry-dtype-mismatch",
                f"PRE gather {op.op_id} reads bucket "
                f"{op.bucket.bucket_id} as {_dtype_name(d_pre)} "
                f"but UPDATE {upd.op_id} writes {_dtype_name(d_upd)}",
                (op.op_id, upd.op_id)))
        if upd.bucket.reduce_axes != op.bucket.reduce_axes:
            out.append(Finding(
                "carry", "carry-axes-mismatch",
                f"PRE gather {op.op_id} gathers over "
                f"{op.bucket.reduce_axes} but UPDATE {upd.op_id}'s "
                f"shard was scattered over {upd.bucket.reduce_axes}",
                (op.op_id, upd.op_id)))

    # exact bucket-set equality: once ANY gather defers, every update
    # shard must cross the boundary — an update consumed by a POST
    # gather in the same schedule would ALSO be re-applied from the
    # carry next step (double-apply), and an update with no gather at
    # all leaves the carry half-written
    if pre_ags:
        deferred = {op.bucket.bucket_id for op in pre_ags}
        for bid, upd in sorted(updates.items()):
            if bid in deferred:
                continue
            post_consumers = [
                op for op in schedule.ops
                if op.kind == ALL_GATHER and op.phase == POST
                and op.bucket.bucket_id == bid
                and any(by_id[d].kind == UPDATE for d in op.depends_on
                        if d in by_id)]
            code = ("mixed-defer" if post_consumers
                    else "half-written-carry")
            why = ("is also gathered in-step — the carry would "
                   "double-apply it next step"
                   if post_consumers else
                   "is never gathered (neither in-step nor deferred) — "
                   "the carry is half-written")
            out.append(Finding(
                "carry", code,
                f"UPDATE {upd.op_id} produces bucket {bid} while other "
                f"buckets defer, but bucket {bid} {why}",
                (upd.op_id,),
                Witness("deferred bucket set mismatch:",
                        (f"PRE-gathered buckets:  {sorted(deferred)}",
                         f"UPDATE-produced buckets: "
                         f"{sorted(updates)}"))))
    return out


# --------------------------------------- pass 4: byte/dtype accounting

def check_accounting(schedule: CommSchedule, *,
                     plan_comm_dtype=None,
                     default_reducer: str = "flat") -> list[Finding]:
    """RS/AG pair symmetry, reducer/dtype legality, byte bookkeeping."""
    out: list[Finding] = []
    by_id = {op.op_id: op for op in schedule.ops}

    def eff_dtype(bucket):
        return plan_comm_dtype if bucket.comm_dtype is None else bucket.comm_dtype

    from repro_torch.core.registry import reducer_names
    known = set(reducer_names())

    consumers: dict[int, list] = {}
    for op in schedule.ops:
        for d in op.depends_on:
            dep = by_id.get(d)
            if dep is not None and \
                    dep.bucket.bucket_id == op.bucket.bucket_id:
                consumers.setdefault(d, []).append(op)

    for op in schedule.ops:
        if op.reducer:
            if op.reducer not in known:
                out.append(Finding(
                    "accounting", "unknown-reducer",
                    f"op {op.op_id} tagged with unregistered reducer "
                    f"{op.reducer!r}", (op.op_id,)))
            if op.kind != ALLREDUCE:
                out.append(Finding(
                    "accounting", "ignored-reducer-tag",
                    f"op {op.op_id} ({op.kind}) carries reducer tag "
                    f"{op.reducer!r}, but the emitter only honors "
                    f"reducer tags on ALLREDUCE ops — the tag would be "
                    f"silently ignored", (op.op_id,)))
        if op.kind == ALLREDUCE and \
                _family(op.reducer or default_reducer) == "compressed":
            d = eff_dtype(op.bucket)
            if d is not None and not d.is_floating_point:
                out.append(Finding(
                    "accounting", "comm-dtype-illegal",
                    f"op {op.op_id} uses the compressed reducer family "
                    f"on a {_dtype_name(d)} wire — block quantization requires "
                    f"a float comm dtype", (op.op_id,)))
        if op.kind == UPDATE:
            d = eff_dtype(op.bucket)
            if d is None or d != torch.float32:
                out.append(Finding(
                    "accounting", "update-dtype",
                    f"UPDATE op {op.op_id} runs on a "
                    f"{_dtype_name(d) if d is not None else 'unpinned'} bucket "
                    f"— ZeRO-1 shard math must pin comm_dtype=f32 to "
                    f"match the monolithic optimizer bit-for-bit",
                    (op.op_id,)))

        if op.kind == REDUCE_SCATTER:
            cons = [c for c in consumers.get(op.op_id, ())
                    if c.kind in (ALL_GATHER, UPDATE)]
            if not cons:
                out.append(Finding(
                    "accounting", "rs-unconsumed",
                    f"reduce-scatter {op.op_id} produces a shard of "
                    f"bucket {op.bucket.bucket_id} that no same-bucket "
                    f"ALL_GATHER/UPDATE consumes — the reduced bytes "
                    f"are dropped and the leaves keep stale gradients",
                    (op.op_id,)))

        if op.kind == ALL_GATHER:
            srcs = [by_id[d] for d in op.depends_on if d in by_id
                    and by_id[d].bucket.bucket_id == op.bucket.bucket_id
                    and by_id[d].kind in (REDUCE_SCATTER, UPDATE, DECODE)]
            if not srcs and op.phase != PRE:
                out.append(Finding(
                    "accounting", "ag-no-producer",
                    f"all-gather {op.op_id} has no same-bucket "
                    f"REDUCE_SCATTER/UPDATE dep and is not deferred — "
                    f"there is no shard to gather", (op.op_id,)))
            for src in srcs:
                if src.bucket.size != op.bucket.size or \
                        src.bucket.reduce_axes != op.bucket.reduce_axes:
                    out.append(Finding(
                        "accounting", "rs-ag-asymmetry",
                        f"all-gather {op.op_id} "
                        f"(size={op.bucket.size}, "
                        f"axes={op.bucket.reduce_axes}) does not mirror "
                        f"its producer {src.op_id} "
                        f"(size={src.bucket.size}, "
                        f"axes={src.bucket.reduce_axes})",
                        (op.op_id, src.op_id)))
                da, db = eff_dtype(op.bucket), eff_dtype(src.bucket)
                if da is not None and db is not None and da != db:
                    out.append(Finding(
                        "accounting", "rs-ag-dtype",
                        f"all-gather {op.op_id} ({_dtype_name(da)}) and its "
                        f"producer {src.op_id} ({_dtype_name(db)}) disagree on "
                        f"the wire dtype", (op.op_id, src.op_id)))

        if op.kind == RECV:
            srcs = [by_id[d] for d in op.depends_on if d in by_id
                    and by_id[d].kind == SEND
                    and by_id[d].bucket.bucket_id == op.bucket.bucket_id]
            for src in srcs:
                if src.bucket.size != op.bucket.size:
                    out.append(Finding(
                        "accounting", "send-recv-bytes",
                        f"stage boundary bucket {op.bucket.bucket_id}: "
                        f"SEND {src.op_id} packs {src.bucket.size} "
                        f"elements but RECV {op.op_id} delivers "
                        f"{op.bucket.size} — the two halves of the hop "
                        f"disagree on the payload size",
                        (src.op_id, op.op_id),
                        Witness("asymmetric stage boundary:",
                                (_op_str(src), _op_str(op)))))
                da, db = eff_dtype(op.bucket), eff_dtype(src.bucket)
                if da is not None and db is not None and da != db:
                    out.append(Finding(
                        "accounting", "send-recv-dtype",
                        f"RECV {op.op_id} ({_dtype_name(da)}) and its SEND "
                        f"{src.op_id} ({_dtype_name(db)}) disagree on the "
                        f"boundary wire dtype", (op.op_id, src.op_id)))

    # bookkeeping self-consistency: the stats the sim/benchmarks consume
    itemsize = 4 if plan_comm_dtype is None else plan_comm_dtype.itemsize
    if sum(schedule.chain_bytes(itemsize).values()) != \
            schedule.comm_bytes(itemsize):
        out.append(Finding(
            "accounting", "chain-bytes-drift",
            "chain_bytes does not sum to comm_bytes — the per-channel "
            "budget and the sim disagree on total payload"))
    want = sum(op.bucket.size * itemsize_of(op.bucket.comm_dtype, itemsize)
               for op in schedule.ops if op.phase == PRE)
    if schedule.deferred_bytes(itemsize) != want:
        out.append(Finding(
            "accounting", "deferred-bytes-drift",
            f"deferred_bytes() = {schedule.deferred_bytes(itemsize)} "
            f"but the PRE ops carry {want} bytes"))
    return out


# -------------------------------------- pass 5: donation/aliasing hazard

def check_donation(schedule: CommSchedule,
                   donated_buckets: Iterable[int] = ()) -> list[Finding]:
    """A staged buffer that is donated in step N and read by a PRE op at
    the top of step N+1 aliases freed memory — the gather would read a
    buffer the allocator already reused."""
    donated = frozenset(donated_buckets)
    out: list[Finding] = []
    for op in schedule.ops:
        if op.phase == PRE and op.bucket.bucket_id in donated:
            out.append(Finding(
                "donation", "donated-pre-read",
                f"bucket {op.bucket.bucket_id}'s staged buffer is "
                f"donated, but PRE op {op.op_id} reads it at the top "
                f"of the NEXT step — the buffer may be reused before "
                f"the deferred gather consumes it",
                (op.op_id,),
                Witness("donated buffer crossing the step boundary:",
                        (_op_str(op),
                         f"donated buckets: {sorted(donated)}"))))
    return out


# ----------------------------------- pass 6: reshard/regroup soundness

def check_reshard(
    schedule: CommSchedule,
    *,
    old_mesh_shape: Mapping[str, int] | None = None,
    new_mesh_shape: Mapping[str, int] | None = None,
    leaf_divisibility: Mapping[str, tuple[int, int]] | None = None,
) -> list[Finding]:
    """Soundness of an elastic transition (DESIGN.md §13).

    A transition schedule is gather-side RESHARD ops (old mesh), ONE
    REGROUP barrier the old communicator joins, then scatter-side
    RESHARD ops (new mesh) — ``split_regroup`` executes the two sides as
    separate programs.  Checked statically:

      - every schedule with RESHARD ops carries a REGROUP (the
        group-rebuild moment; without it the two meshes race),
      - no PRE (deferred) op crosses a regroup — the carry is flushed
        via ``TrainStep.finalize`` BEFORE the old mesh dissolves, so a
        deferred op in a transition schedule reads state that no longer
        exists,
      - the barrier is real: every old-side op is an ancestor of the
        REGROUP, and every post-regroup RESHARD depends on it,
      - gather axes exist on the OLD mesh, scatter axes on the NEW,
      - byte conservation per leaf: every gathered leaf is scattered
        exactly once with the same total size (state neither lost,
        duplicated, nor conjured across the transition),
      - static divisibility of each param leaf's sharded dim by the new
        mesh (``leaf_divisibility``: leaf → (dim_size, divisor), built
        by the planner from the new mesh's specs).

    On schedules with no RESHARD/REGROUP ops (every plain training
    plan) this returns [] immediately.
    """
    reshard_ops = [op for op in schedule.ops if op.kind == RESHARD]
    regroups = [op for op in schedule.ops if op.kind == REGROUP]
    out: list[Finding] = []
    if leaf_divisibility:
        for name, (dim, div) in sorted(leaf_divisibility.items()):
            if div and dim % div:
                out.append(Finding(
                    "reshard", "leaf-indivisible",
                    f"leaf {name!r}: sharded dim of size {dim} is not "
                    f"divisible by the new mesh's axis product {div} — "
                    f"the scatter side cannot tile it"))
    if not reshard_ops and not regroups:
        return out
    if structural_findings(schedule):
        return out           # side/ordering analysis needs sound order

    if reshard_ops and not regroups:
        out.append(Finding(
            "reshard", "regroup-missing",
            f"schedule moves state with {len(reshard_ops)} RESHARD "
            f"op(s) but has no REGROUP barrier — the old and new "
            f"communicators are never synchronized",
            tuple(op.op_id for op in reshard_ops)))

    for op in schedule.ops:
        if regroups and op.phase == PRE:
            out.append(Finding(
                "reshard", "pre-crosses-regroup",
                f"op {op.op_id} ({op.kind}) is tagged PRE in a "
                f"transition schedule — deferred carries must be "
                f"flushed (TrainStep.finalize) before the regroup; a "
                f"PRE op here reads opt_state['pending'] of a mesh "
                f"that no longer exists",
                (op.op_id,),
                Witness("deferred op crossing the regroup barrier:",
                        (_op_str(op),))))

    pos = {op.op_id: i for i, op in enumerate(schedule.ops)}
    first_rg = regroups[0] if regroups else None
    cut = pos[first_rg.op_id] if first_rg is not None else len(schedule.ops)
    gathers = [op for op in reshard_ops if pos[op.op_id] < cut]
    scatters = [op for op in reshard_ops if pos[op.op_id] > cut]

    if first_rg is not None:
        anc = _ancestor_masks(schedule)
        for op in schedule.ops[:cut]:
            if not _reaches(anc, pos, op.op_id, first_rg.op_id):
                out.append(Finding(
                    "reshard", "op-escapes-regroup",
                    f"op {op.op_id} precedes the REGROUP barrier (op "
                    f"{first_rg.op_id}) but the barrier does not "
                    f"transitively depend on it — the old mesh may "
                    f"dissolve while the op is still in flight",
                    (op.op_id, first_rg.op_id),
                    Witness("old-side op the barrier does not join:",
                            (_op_str(op), _op_str(first_rg)))))
        for op in scatters:
            if not _reaches(anc, pos, first_rg.op_id, op.op_id):
                out.append(Finding(
                    "reshard", "reshard-after-regroup-unanchored",
                    f"scatter-side RESHARD {op.op_id} does not depend "
                    f"on the REGROUP barrier (op {first_rg.op_id}) — "
                    f"it could run before the old mesh quiesced",
                    (op.op_id, first_rg.op_id)))

    for ops, shape, side in ((gathers, old_mesh_shape, "old"),
                             (scatters, new_mesh_shape, "new")):
        if shape is None:
            continue
        for op in ops:
            missing = [a for a in op.bucket.reduce_axes if a not in shape]
            if missing:
                out.append(Finding(
                    "reshard", "reshard-axis-unknown",
                    f"{side}-side RESHARD {op.op_id} moves state over "
                    f"axes {missing} absent from the {side} mesh "
                    f"{dict(shape)}", (op.op_id,)))

    # byte conservation per leaf name, gather side vs scatter side
    if regroups:
        def tally(ops):
            sizes: dict[str, int] = {}
            counts: dict[str, int] = {}
            for op in ops:
                for leaf in op.bucket.leaves:
                    sizes[leaf.name] = sizes.get(leaf.name, 0) + leaf.size
                    counts[leaf.name] = counts.get(leaf.name, 0) + 1
            return sizes, counts

        g_sizes, g_counts = tally(gathers)
        s_sizes, s_counts = tally(scatters)
        for name, cnt in sorted({**g_counts, **s_counts}.items()):
            if max(g_counts.get(name, 0), s_counts.get(name, 0)) > 1:
                out.append(Finding(
                    "reshard", "leaf-duplicated",
                    f"leaf {name!r} is moved more than once on one side "
                    f"of the transition (gathered "
                    f"{g_counts.get(name, 0)}×, scattered "
                    f"{s_counts.get(name, 0)}×)"))
        if gathers and scatters:
            for name in sorted(set(g_sizes) - set(s_sizes)):
                out.append(Finding(
                    "reshard", "leaf-lost",
                    f"leaf {name!r} is gathered off the old mesh but "
                    f"never scattered onto the new one — "
                    f"{g_sizes[name]} elements of state are dropped",
                    tuple(op.op_id for op in gathers
                          if any(l.name == name for l in op.bucket.leaves))))
            for name in sorted(set(s_sizes) - set(g_sizes)):
                out.append(Finding(
                    "reshard", "leaf-unsourced",
                    f"leaf {name!r} is scattered onto the new mesh but "
                    f"never gathered off the old one — the scatter "
                    f"reads uninitialized state",
                    tuple(op.op_id for op in scatters
                          if any(l.name == name for l in op.bucket.leaves))))
            for name in sorted(set(g_sizes) & set(s_sizes)):
                if g_sizes[name] != s_sizes[name]:
                    out.append(Finding(
                        "reshard", "leaf-size-drift",
                        f"leaf {name!r}: gather side moves "
                        f"{g_sizes[name]} elements but scatter side "
                        f"expects {s_sizes[name]} — byte conservation "
                        f"across the transition is violated"))
    return out

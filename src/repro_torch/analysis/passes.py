"""Schedule analysis, the structural part the port needs now.

``structural_findings`` is the port's copy of
``repro/analysis/passes.py::structural_findings`` — the first stage of
the reference's deadlock pass and the check behind
``CommSchedule.validate``.  The other analysis passes (deadlock cycles,
spmd, carry, accounting, donation, reshard) come with ROADMAP queue 1
item 15.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One failed check: which pass, which error class, which ops."""

    pass_name: str
    code: str            # machine-readable error class
    message: str
    ops: tuple[int, ...] = ()

    def render(self) -> str:
        return f"[{self.pass_name}:{self.code}] {self.message}"


def structural_findings(schedule) -> list[Finding]:
    """Program-order soundness: what ``CommSchedule.validate`` enforces."""
    from repro_torch.core.schedule import KINDS, PHASES

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

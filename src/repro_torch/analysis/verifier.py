"""Analyzer entry points: run all six passes, report or raise — the port
of ``repro/analysis/verifier.py``.

``verify_schedule`` is the planning-time hook (GradSync / KVStore,
``verify=True`` by default): any finding raises ``ScheduleError`` with
its witness, before a communicator sees the schedule.  ``run_passes``
is the collecting variant the CLI uses — every finding, as an
``AnalysisReport`` that renders to text or a machine-readable dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

from repro_torch.analysis.passes import (
    PASS_NAMES,
    Finding,
    ScheduleError,
    check_accounting,
    check_carry,
    check_deadlock,
    check_donation,
    check_reshard,
    check_spmd,
)
from repro_torch.core.schedule import CommSchedule


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """Every finding from one analyzer run over one schedule."""

    findings: tuple[Finding, ...]
    num_ops: int

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def error_classes(self) -> tuple[str, ...]:
        """Distinct ``pass:code`` labels, first-seen order."""
        out: list[str] = []
        for f in self.findings:
            label = f"{f.pass_name}:{f.code}"
            if label not in out:
                out.append(label)
        return tuple(out)

    def by_pass(self, pass_name: str) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings
                     if f.pass_name == pass_name)

    def render(self) -> str:
        if self.ok:
            return f"OK ({self.num_ops} ops, all passes clean)"
        return "\n".join(f.render() for f in self.findings)

    def to_dict(self) -> dict[str, Any]:
        """JSON-ready form for the CLI report."""
        return {
            "ok": self.ok,
            "num_ops": self.num_ops,
            "findings": [
                {
                    "pass": f.pass_name,
                    "code": f.code,
                    "message": f.message,
                    "ops": list(f.ops),
                    "witness": (f.witness.render()
                                if f.witness is not None else None),
                }
                for f in self.findings
            ],
        }

    def raise_if_failed(self) -> "AnalysisReport":
        if self.findings:
            raise ScheduleError(self.findings)
        return self


def run_passes(
    schedule: CommSchedule,
    *,
    mesh_shape: Mapping[str, int] | None = None,
    default_reducer: str = "flat",
    plan_comm_dtype: Any = None,
    expect_defer: bool | None = None,
    donated_buckets: Iterable[int] = (),
    rank_programs: Mapping[tuple[int, ...], Sequence[int]] | None = None,
    old_mesh_shape: Mapping[str, int] | None = None,
    new_mesh_shape: Mapping[str, int] | None = None,
    leaf_divisibility: Mapping[str, tuple[int, int]] | None = None,
    passes: Sequence[str] = PASS_NAMES,
) -> AnalysisReport:
    """Run the requested passes over ``schedule`` and collect findings.

    Context mirrors what planning knows statically:
      mesh_shape       — axis name → size (rank enumeration for the SPMD
                         pass; skipped when None, e.g. a KVStore made
                         without a mesh shape).
      default_reducer  — the reducer untagged ALLREDUCE ops resolve to.
      plan_comm_dtype  — BucketPlan-level wire dtype, a ``torch.dtype``
                         (buckets may pin their own override).
      expect_defer     — planner intent: False means PRE ops are a bug
                         even if internally consistent.
      donated_buckets  — bucket_ids whose staged buffers are donated.
      rank_programs    — per-rank issue-order override (mutation corpus;
                         real planning is SPMD so all ranks share the
                         schedule's tuple order).
      old_mesh_shape / new_mesh_shape / leaf_divisibility
                       — elastic-transition context for the reshard
                         pass: the dissolving and
                         forming mesh shapes, and per-leaf
                         (dim_size, divisor) static divisibility facts
                         from the new mesh's specs.
    """
    findings: list[Finding] = []
    for name in passes:
        if name == "deadlock":
            findings += check_deadlock(schedule)
        elif name == "spmd":
            findings += check_spmd(
                schedule, mesh_shape, default_reducer=default_reducer,
                rank_programs=rank_programs)
        elif name == "carry":
            findings += check_carry(schedule, expect_defer=expect_defer)
        elif name == "accounting":
            findings += check_accounting(
                schedule, plan_comm_dtype=plan_comm_dtype,
                default_reducer=default_reducer)
        elif name == "donation":
            findings += check_donation(schedule, donated_buckets)
        elif name == "reshard":
            findings += check_reshard(
                schedule, old_mesh_shape=old_mesh_shape,
                new_mesh_shape=new_mesh_shape,
                leaf_divisibility=leaf_divisibility)
        else:
            raise ValueError(f"unknown analysis pass {name!r}")
    return AnalysisReport(tuple(findings), num_ops=len(schedule.ops))


def verify_schedule(
    schedule: CommSchedule,
    *,
    mesh_shape: Mapping[str, int] | None = None,
    default_reducer: str = "flat",
    plan_comm_dtype: Any = None,
    expect_defer: bool | None = None,
    donated_buckets: Iterable[int] = (),
    rank_programs: Mapping[tuple[int, ...], Sequence[int]] | None = None,
    old_mesh_shape: Mapping[str, int] | None = None,
    new_mesh_shape: Mapping[str, int] | None = None,
    leaf_divisibility: Mapping[str, tuple[int, int]] | None = None,
) -> AnalysisReport:
    """``run_passes`` that raises ``ScheduleError`` (with the witness in
    its message) if any pass found anything — the ``verify=`` hook."""
    return run_passes(
        schedule,
        mesh_shape=mesh_shape,
        default_reducer=default_reducer,
        plan_comm_dtype=plan_comm_dtype,
        expect_defer=expect_defer,
        donated_buckets=donated_buckets,
        rank_programs=rank_programs,
        old_mesh_shape=old_mesh_shape,
        new_mesh_shape=new_mesh_shape,
        leaf_divisibility=leaf_divisibility,
    ).raise_if_failed()

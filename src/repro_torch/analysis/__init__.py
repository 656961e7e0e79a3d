"""Static CommSchedule verifier — the port of ``repro/analysis``.

The paper's central hazard — "incorrect designs can easily lead to
deadlocks or program crashes" when collectives are embedded in a
training DAG — becomes checkable here: six pure-Python analysis passes
run over any ``CommSchedule`` before a communicator sees it, and reject
a malformed schedule with a printable witness instead of a hung process.

Passes (``repro_torch.analysis.passes``):
  deadlock    — cycle / stuck-schedule detection over the union of chain
                deps, data deps and cross-step PRE→POST carry edges, and
                SEND/RECV rendezvous, with a topological witness.
  spmd        — per-rank issue-order simulation per mesh-axis group:
                every rank in a communicator group must issue the same
                collective sequence per channel (the paper's
                funnel-vs-concurrent deadlock), with reducer families
                expanded into their stage collectives.
  carry       — soundness of the deferred ZeRO-1 carry (PRE all-gathers
                covered by POST UPDATEs, exact bucket-set equality).
  accounting  — RS/AG pair symmetry, comm dtype legality per reducer
                family, byte bookkeeping.
  donation    — staged buffers both donated and read by a PRE op of the
                next step.
  reshard     — elastic-transition soundness: RESHARD ops bracketed by a
                REGROUP barrier, byte conservation per leaf.

Entry points:
  ``verify_schedule``  — raise ``ScheduleError`` on any finding (the
                         ``verify=`` hook in GradSync / KVStore).
  ``run_passes``       — collect every finding into an
                         ``AnalysisReport``.
  ``python -m repro_torch.analyze`` — lint the strategy × reducer ×
                         channels cross-product the port can plan.
"""
from repro_torch.analysis.passes import (
    PASS_NAMES,
    Finding,
    ScheduleError,
    Witness,
    check_accounting,
    check_carry,
    check_deadlock,
    check_donation,
    check_reshard,
    check_spmd,
    reducer_stages,
    structural_findings,
)
from repro_torch.analysis.verifier import (
    AnalysisReport,
    run_passes,
    verify_schedule,
)

__all__ = [
    "AnalysisReport",
    "Finding",
    "PASS_NAMES",
    "ScheduleError",
    "Witness",
    "check_accounting",
    "check_carry",
    "check_deadlock",
    "check_donation",
    "check_reshard",
    "check_spmd",
    "reducer_stages",
    "run_passes",
    "structural_findings",
    "verify_schedule",
]

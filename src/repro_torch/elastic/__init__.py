"""repro_torch.elastic — online elastic training (``repro/elastic``).

The MXNET-MPI companion paper extends the source paper's fixed
communicator with MPI *groups* inside a parameter-server task model:
workers regroup when membership changes.  This package makes that
first-class and *scheduled*:

  reshard.py    — ``StateCodec`` (gather/scatter programs that move live
                  ZeRO-1 state through the shared ``_OpEmitter`` as
                  RESHARD ops), ``plan_reshard`` (the transition IR:
                  gathers → REGROUP barrier → scatters, verified by the
                  reshard analysis pass) and ``reshard_state`` (the
                  old-mesh → new-mesh state transfer across processes).
  supervisor.py — ``Supervisor``: wraps ``Trainer`` with a fault plan
                  (rank loss, checkpoint-I/O faults, stragglers) and the
                  policy ladder retry → restore → shrink → grow-back,
                  driving full mesh cycles with bit-exact resume.
"""
from repro_torch.elastic.reshard import (
    ReshardPlan,
    StateCodec,
    plan_reshard,
    reshard_state,
)
from repro_torch.elastic.supervisor import (
    ElasticCheckpointer,
    FaultPlan,
    Supervisor,
    Transition,
)

__all__ = [
    "ElasticCheckpointer",
    "FaultPlan",
    "ReshardPlan",
    "StateCodec",
    "Supervisor",
    "Transition",
    "plan_reshard",
    "reshard_state",
]

"""Decode-time cost model — per-token serving collectives as
CommSchedule IR; the port of ``repro/sim/serve.py``.

The continuous-batching runtime (``repro_torch.runtime.serve_loop``) emits, per
decode token, the same collective structure every step: each layer's
local matmuls (memory-bandwidth-bound at decode batch sizes) followed by
two tensor-parallel psums (attention ``wo`` output, FFN output), then the
lm_head projection and the sampler's candidate all-gather.  That is a
dependency-chained program of the SAME shape the training planners build
— so decode plans are expressed in the same IR (a DECODE compute node per
layer group, explicit ALLREDUCE/ALL_GATHER wire ops) and ranked through
the same discrete-event simulator (``repro_torch.sim.engine``) and static
verifier (``repro_torch.analysis``) as training strategies.

Plan shape (``plan_decode``), one token:

    layer 0: DECODE(params) → AR(attn out, model) → AR(ffn out, model)
    layer 1: DECODE(params) → ...                           (chained)
    head:    DECODE(lm_head params) → DECODE(candidates) → AG(model)

The sampler tail varies by variant — the candidate payload the all-gather
moves is what distinguishes them:

    argmax  — one (value, index) pair per row: ``sharded_argmax``
    topk    — k_cand pairs per row: ``sharded_sample``'s candidate set
    full    — the whole vocab row: the naive full-logit gather the
              sharded sampler exists to avoid

``rank_decode_plans`` verifies each variant statically (deadlock / SPMD /
accounting passes) and ranks by simulated per-token latency, mirroring
``rank_strategies`` for training plans.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.buckets import Bucket, LeafInfo
from repro_torch.core.schedule import (
    ALL_GATHER,
    ALLREDUCE,
    DECODE,
    CollectiveOp,
    CommSchedule,
)
from repro_torch.sim.compute import ComputeModel, UpdateModel, count_params
from repro_torch.sim.engine import SimConfig, Timeline, simulate
from repro_torch.sim.netmodel import NetworkModel

MODEL_AXIS = "model"

#: sampler tail variants ``plan_decode`` knows how to lay out
SAMPLERS = ("argmax", "topk", "full")


@dataclasses.dataclass(frozen=True)
class DecodeModel:
    """Per-token decode signature of one model on one mesh.

    Everything the planner/coster needs, independent of torch: local
    (per-device) parameter element counts — decode compute at small
    batch is an HBM pass over the weights — plus the activation widths
    the tp psums move.
    """

    n_layers: int
    layer_params_local: int    # per-layer param elements on ONE device
    head_params_local: int     # lm_head param elements on ONE device
    d_model: int
    vocab: int
    tp: int = 1                # tensor-parallel group (the psum width)
    dp: int = 1                # data-parallel replicas (batch rows split)
    batch: int = 1             # in-flight decode width W (global)

    @property
    def batch_local(self) -> int:
        """Decode rows resident on one dp replica."""
        return max(1, math.ceil(self.batch / max(self.dp, 1)))

    @classmethod
    def for_config(cls, cfg, mesh_shape: Mapping[str, int], *,
                   batch: int = 1) -> "DecodeModel":
        """Derive the signature from a registered model config + mesh.

        Per-layer local params come from ``count_params`` minus the
        embedding/lm_head tables, split across layers and the tp group —
        exact enough for a bandwidth model, with no tracing.
        """
        total = count_params(cfg)
        tp = max(int(getattr(cfg, "tp", 1)), 1)
        dp = 1
        for a, s in mesh_shape.items():
            if a != MODEL_AXIS:
                dp *= int(s)
        tables = 2 * cfg.vocab * cfg.d_model       # embed + lm_head
        layer_total = max(total - tables, 0) // max(cfg.n_layers, 1)
        return cls(
            n_layers=int(cfg.n_layers),
            layer_params_local=math.ceil(layer_total / tp),
            head_params_local=math.ceil(cfg.vocab * cfg.d_model / tp),
            d_model=int(cfg.d_model),
            vocab=int(cfg.vocab),
            tp=tp, dp=max(dp, 1), batch=int(batch))


def _bucket(bid: int, name: str, size: int,
            axes: tuple[str, ...]) -> Bucket:
    return Bucket(
        leaves=(LeafInfo(name=name, index=bid, shape=(size,),
                         dtype=None, size=int(size)),),
        reduce_axes=axes, channel=0, bucket_id=bid)


def plan_decode(model: DecodeModel, *, sampler: str = "topk",
                k_cand: int = 16) -> CommSchedule:
    """One decode token as a CommSchedule (see module docstring).

    The program is a single dependency chain — decode collectives are
    inherently serial per token (each layer's psum feeds the next
    layer's matmul), which is also what makes every rank's issue order
    trivially SPMD-consistent.
    """
    if sampler not in SAMPLERS:
        raise ValueError(
            f"unknown sampler {sampler!r}; expected one of {SAMPLERS}")
    ops: list[CollectiveOp] = []
    bid = 0
    act = model.batch_local * model.d_model    # psum payload per replica

    def emit(kind: str, bucket: Bucket) -> CollectiveOp:
        deps = (ops[-1].op_id,) if ops else ()
        op = CollectiveOp(op_id=len(ops), bucket=bucket, chain=0,
                          depends_on=deps, kind=kind)
        ops.append(op)
        return op

    tp_axes = (MODEL_AXIS,) if model.tp > 1 else ()
    for i in range(model.n_layers):
        emit(DECODE, _bucket(bid, f"layer{i}.params",
                             model.layer_params_local, ()))
        bid += 1
        if tp_axes:
            emit(ALLREDUCE, _bucket(bid, f"layer{i}.attn_out", act,
                                    tp_axes))
            bid += 1
            emit(ALLREDUCE, _bucket(bid, f"layer{i}.ffn_out", act,
                                    tp_axes))
            bid += 1

    emit(DECODE, _bucket(bid, "head.params", model.head_params_local, ()))
    bid += 1

    # the sampler tail: a local candidate-producing DECODE node and the
    # all-gather that moves its payload across the tp group.  The pair
    # shares ONE bucket (the gathered payload), mirroring how training
    # RS/AG pairs share theirs — which is exactly what the accounting
    # pass checks (``ag-no-producer`` / ``rs-ag-asymmetry``).
    rows = model.batch_local
    if sampler == "argmax":
        cand = rows * 2 * max(model.tp, 1)          # (val, idx) per shard
    elif sampler == "topk":
        cand = rows * 2 * k_cand * max(model.tp, 1)
    else:                                           # full-vocab gather
        cand = rows * model.vocab
    payload = _bucket(bid, f"sampler.{sampler}", cand, tp_axes)
    emit(DECODE, payload)
    if tp_axes:
        emit(ALL_GATHER, payload)
    return CommSchedule(ops=tuple(ops))


def simulate_decode(
    schedule: CommSchedule,
    mesh_shape: Mapping[str, int],
    *,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    update: UpdateModel | None = None,
) -> Timeline:
    """One decode token as a discrete-event timeline.

    Decode has no fwd/bwd release ramp — every op is gated purely by its
    dependency chain — so the compute model is idle and DECODE nodes
    carry all compute cost (HBM passes over local param bytes, priced by
    the engine's DECODE branch against ``UpdateModel.hbm_bw``).
    """
    compute = ComputeModel(t_fwd=0.0, t_bwd=0.0,
                           update=update or UpdateModel())
    return simulate(schedule, mesh_shape, compute=compute, net=net,
                    sim=sim)


def rank_decode_plans(
    model: DecodeModel,
    mesh_shape: Mapping[str, int],
    *,
    samplers: Sequence[str] = SAMPLERS,
    k_cand: int = 16,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    update: UpdateModel | None = None,
    verify: bool = True,
) -> list[dict]:
    """Rank sampler-tail variants by simulated per-token latency.

    The decode analogue of ``rank_strategies``: each variant's schedule
    is built, statically verified (deadlock / SPMD / accounting — a
    decode plan is IR like any other), simulated, and scored.  Returns
    dicts sorted fastest-first:

        {"sampler", "token_time", "tokens_per_s", "comm_time",
         "schedule", "timeline", "findings"}
    """
    from repro_torch.analysis.passes import (
        check_accounting,
        check_deadlock,
        check_spmd,
    )

    out: list[dict] = []
    for name in samplers:
        sched = plan_decode(model, sampler=name, k_cand=k_cand)
        findings = []
        if verify:
            findings = (check_deadlock(sched)
                        + check_spmd(sched, mesh_shape)
                        + check_accounting(sched))
            if findings:
                raise ValueError(
                    f"decode plan {name!r} failed static verification:\n"
                    + "\n".join(f.render() for f in findings))
        tl = simulate_decode(sched, mesh_shape, net=net, sim=sim,
                             update=update)
        token_time = tl.step_time
        out.append({
            "sampler": name,
            "token_time": token_time,
            "tokens_per_s": (model.batch / token_time
                             if token_time > 0 else float("inf")),
            "comm_time": tl.total_comm,
            "schedule": sched,
            "timeline": tl,
            "findings": findings,
        })
    out.sort(key=lambda r: r["token_time"])
    return out

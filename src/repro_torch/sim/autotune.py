"""Cost-model autotuning: simulate every candidate embedding, pick the
winner — the port of ``repro/sim/autotune.py``.

Two entry points:

  ``rank_strategies``  — simulate every *fixed* registered strategy on one
      BucketPlan and return (name, Timeline) sorted by predicted step
      time.  Strategy semantics come from registry metadata: in-scan
      strategies simulate with per-scan-step releases and no cross-bucket
      chain edges.

  ``grid_search``      — the full strategy × num_channels × bucket_bytes
      sweep over freshly built BucketPlans; returns ranked
      ``Prediction`` rows whose best row is directly a GradSyncConfig
      choice.

Importing this module registers the ``auto`` strategy: a *meta* planner
that simulates all fixed candidates on the plan it is handed and
delegates to the winner's schedule.  ``plan_sync`` passes meta
strategies a ``context`` mapping (mesh_shape / reducer / itemsize /
compute / pp / zero1) so the simulation sees the real topology; without
context the planner falls back to an 8-way group per axis — still a
valid schedule, just a less calibrated choice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from repro_torch.core.buckets import Bucket, BucketPlan, make_bucket_plan
from repro_torch.core.pipeline_program import (
    STAGE_AXIS,
    bucket_stage_map,
    compose_step,
    plan_pipeline,
)
from repro_torch.core.registry import (
    fixed_strategy_names,
    get_strategy,
    register_strategy,
)
from repro_torch.core.schedule import UPDATE, CollectiveOp, CommSchedule
from repro_torch.core.stepprogram import zero1_schedule
from repro_torch.sim.compute import ComputeModel, pipeline_timeline
from repro_torch.sim.engine import (
    SimConfig,
    Timeline,
    simulate,
    simulate_pipelined,
)
from repro_torch.sim.netmodel import NetworkModel, default_network


def sim_config_for(name: str, base: SimConfig | None = None, *,
                   in_scan_active: bool = True) -> SimConfig:
    """Map a strategy's registry metadata onto simulator semantics.

    ``in_scan_active=False`` disables the in-scan advantage (per-stage
    releases, no chain edges) even for ``uses_in_scan`` strategies — used
    when the execution being predicted will NOT emit in-scan psums (e.g.
    ``auto`` delegating: the in-backward sync keys off the configured
    strategy, so a delegated depcha runs as plain chains)."""
    info = get_strategy(name)
    base = base or SimConfig()
    flag = info.uses_in_scan and in_scan_active
    return dataclasses.replace(
        base, drop_chain_deps=flag, per_stage_release=flag)


def simulate_strategy(
    name: str,
    plan: BucketPlan,
    mesh_shape: Mapping[str, int],
    *,
    compute: ComputeModel | None = None,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    skip_names: frozenset[str] = frozenset(),
    in_scan_active: bool = True,
) -> tuple[CommSchedule, Timeline]:
    """Plan ``name`` on ``plan`` and execute it in the simulator."""
    schedule = get_strategy(name).plan(plan, skip_names=skip_names)
    timeline = simulate(
        schedule, mesh_shape, compute=compute, net=net,
        sim=sim_config_for(name, sim, in_scan_active=in_scan_active))
    return schedule, timeline


def rank_strategies(
    plan: BucketPlan,
    mesh_shape: Mapping[str, int],
    *,
    compute: ComputeModel | None = None,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    skip_names: frozenset[str] = frozenset(),
    strategies: Sequence[str] | None = None,
    in_scan_active: bool = True,
) -> list[tuple[str, Timeline]]:
    """Every fixed strategy's predicted timeline, best first.

    (Whole-step ZeRO-1 rankings live in ``rank_step_plans`` — the
    deferred/zero1/flat family leaderboard ``auto`` consults.)
    """
    names = tuple(strategies) if strategies else fixed_strategy_names()
    out = []
    for name in names:
        _, tl = simulate_strategy(
            name, plan, mesh_shape, compute=compute, net=net, sim=sim,
            skip_names=skip_names, in_scan_active=in_scan_active)
        out.append((name, tl))
    out.sort(key=lambda p: (p[1].step_time, p[0]))
    return out


def flat_step_schedule(
    plan: BucketPlan,
    strategy: str = "concom",
    *,
    skip_names: frozenset[str] = frozenset(),
) -> CommSchedule:
    """The monolithic baseline the StepProgram replaces: the strategy's
    allreduce schedule followed by ONE full-buffer UPDATE op that waits
    on every sync op (the opaque ``optimizer.update`` post-script)."""
    base = get_strategy(strategy).plan(plan, skip_names=skip_names)
    ops = list(base.ops)
    if not ops:
        return base
    tails = {op.op_id for op in ops}
    for op in ops:
        tails -= set(op.depends_on)
    all_leaves = tuple(l for op in ops for l in op.bucket.leaves)
    full = Bucket(leaves=all_leaves, reduce_axes=(),
                  channel=max(op.chain for op in ops) + 1,
                  bucket_id=max(op.bucket.bucket_id for op in ops) + 1,
                  comm_dtype=ops[0].bucket.comm_dtype)
    ops.append(CollectiveOp(
        op_id=max(op.op_id for op in ops) + 1, bucket=full,
        chain=full.channel, depends_on=tuple(sorted(tails)), kind=UPDATE))
    return CommSchedule(tuple(ops)).validate()


def rank_step_plans(
    dp_plan: BucketPlan,
    mesh_shape: Mapping[str, int],
    *,
    dp_axes: tuple[str, ...],
    clip: bool = False,
    compute: ComputeModel | None = None,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    strategies: Sequence[str] | None = None,
    accum: int = 1,
    accum_overlap: bool = True,
    pp: Mapping[str, Any] | None = None,
) -> list[tuple[str, Timeline]]:
    """Step-plan families × strategies, ranked by predicted step time.

    Rows are labelled ``deferred:<strategy>`` (pipelined StepProgram:
    the all-gathers split into a PRE program hidden under the NEXT
    step's forward — simulated in steady state), ``zero1:<strategy>``
    (per-bucket RS→UPDATE→AG triples, same-step) and ``flat:<strategy>``
    (the strategy's allreduce schedule + one full-buffer update) — the
    §9/§10 arc on one leaderboard: same wire bytes, progressively less
    of them exposed.

    ``compute`` is the PER-MICROBATCH model when ``accum`` > 1: the
    M-microbatch accumulation scan is folded in (releases only from the
    final microbatch's backward — during it with ``accum_overlap``, the
    peeled-tail training shape, else at the scan's end), and the
    deferred PRE window is the FIRST microbatch's forward.

    ``pp`` ({"stages", "microbatches", "virtual", "activation_bytes",
    "stage_axis"}) with stages > 1 adds ``pp:<sched>:<strategy>`` rows:
    each fixed pipeline schedule is planned (``plan_pipeline``), costed
    analytically (``pipeline_timeline`` — wire from the NetworkModel's
    p2p hop), composed with the strategy's ZeRO-1 triple
    (``compose_step``) and executed in the engine with per-op release
    times — SEND/RECV gated on their producing slot, sync ops on their
    owning stage's gradient release — so bucket reduce-scatters overlap
    the drain bubble exactly as the joint plan allows.  The pipeline
    wall (compute + bubble + lockstep wire) stands in for ``t_fwd`` so
    a pp row's step_time is max(pipeline wall, sync comm end).
    """
    names = tuple(strategies) if strategies else fixed_strategy_names()
    base_compute = compute or ComputeModel(t_fwd=0.0, t_bwd=0.0)
    eff = base_compute.with_accum(accum, overlap_tail=accum_overlap)
    out: list[tuple[str, Timeline]] = []
    for name in names:
        base = get_strategy(name).plan(dp_plan)
        zs = zero1_schedule(base, dp_axes=tuple(dp_axes), clip=clip)
        scfg = sim_config_for(name, sim, in_scan_active=False)
        out.append((f"zero1:{name}",
                    simulate(zs, mesh_shape, compute=eff, net=net,
                             sim=scfg)))
        fs = flat_step_schedule(dp_plan, name)
        out.append((f"flat:{name}",
                    simulate(fs, mesh_shape, compute=eff, net=net,
                             sim=scfg)))
        zd = zero1_schedule(base, dp_axes=tuple(dp_axes), clip=clip,
                            defer_ag=True)
        post, pre = zd.split_phases()
        out.append((f"deferred:{name}",
                    simulate_pipelined(
                        post, pre, mesh_shape, compute=eff, net=net,
                        sim=scfg, pre_window=base_compute.t_fwd)))
    ppc = dict(pp or {})
    stages = int(ppc.get("stages", 1) or 1)
    if stages > 1:
        virtual = int(ppc.get("virtual", 1) or 1)
        n_mb = int(ppc.get("microbatches") or
                   (accum if accum > 1 else 2 * stages))
        act = int(ppc.get("activation_bytes", 0) or 0)
        axis = ppc.get("stage_axis", STAGE_AXIS)
        # per-microbatch compute scales to the whole step; the pipeline
        # timeline re-splits it into M × S_tot per-stage slots
        whole = (dataclasses.replace(
            base_compute, t_fwd=base_compute.t_fwd * accum,
            t_bwd=base_compute.t_bwd * accum)
            if accum > 1 else base_compute)
        net_ = net or default_network()
        wire = net_.p2p_time(act, axis, mesh_shape)
        scheds = (("gpipe", "1f1b") if virtual == 1 else ("interleaved",))
        for sched in scheds:
            pplan = plan_pipeline(
                stages, n_mb, kind=sched,
                virtual=virtual if sched == "interleaved" else 1,
                activation_bytes=act, stage_axis=axis)
            ptl = pipeline_timeline(pplan, whole, wire_time=wire)
            for name in names:
                base = get_strategy(name).plan(dp_plan)
                zs = zero1_schedule(base, dp_axes=tuple(dp_axes),
                                    clip=clip)
                joint, id_map = compose_step(pplan, zs)
                stage_of = bucket_stage_map(pplan, zs)
                last = max(ptl.stage_grad_release)
                rel = dict(ptl.op_release)
                for op in zs.ops:
                    s = stage_of.get(op.bucket.bucket_id)
                    rel[id_map[op.op_id]] = (
                        ptl.stage_grad_release[s] if s is not None
                        else last)
                cm = dataclasses.replace(
                    whole, t_fwd=ptl.wall, t_bwd=0.0)
                scfg = sim_config_for(name, sim, in_scan_active=False)
                out.append((f"pp:{sched}:{name}",
                            simulate(joint, mesh_shape, compute=cm,
                                     net=net, sim=scfg,
                                     release_times=rel)))
    out.sort(key=lambda p: (p[1].step_time, p[0]))
    return out


def choose_pp_schedule(
    n_stages: int,
    n_microbatches: int,
    *,
    virtual: int = 1,
    activation_bytes: int = 0,
    compute: ComputeModel | None = None,
    net: NetworkModel | None = None,
    mesh_shape: Mapping[str, int] | None = None,
    stage_axis: str = STAGE_AXIS,
) -> str:
    """The executed counterpart of the ``pp:<sched>`` ranking: argmin of
    the analytic pipeline wall over the fixed schedules a runtime with
    ``pp_schedule="auto"`` could execute.  By construction the choice is
    never worse than any fixed schedule under the same cost model (ties
    break lexicographically — "1f1b" before "gpipe")."""
    net = net or default_network()
    shape = dict(mesh_shape or {stage_axis: n_stages})
    wire = net.p2p_time(activation_bytes, stage_axis, shape)
    cm = compute or ComputeModel(t_fwd=1.0, t_bwd=2.0)
    cands = ("gpipe", "1f1b") if virtual == 1 else ("interleaved",)

    def wall(kind: str) -> float:
        pplan = plan_pipeline(
            n_stages, n_microbatches, kind=kind,
            virtual=virtual if kind == "interleaved" else 1,
            activation_bytes=activation_bytes, stage_axis=stage_axis)
        return pipeline_timeline(pplan, cm, wire_time=wire).wall

    return min(cands, key=lambda k: (wall(k), k))


# ------------------------------------------------------------------ auto

# the last auto decision, for introspection (CLI/benchmarks/tests)
_LAST_AUTO: dict[str, Any] = {}


def last_auto_report() -> dict[str, Any]:
    """{"winner": name, "ranking": [(name, step_time), ...]} of the most
    recent ``auto`` plan; empty before the first plan."""
    return dict(_LAST_AUTO)


def _resolve_network(ctx: Mapping[str, Any],
                     mesh_shape: Mapping[str, int]):
    """The NetworkModel ``auto`` ranks with, by preference: one passed
    in the context, else a calibrated per-mesh profile fitted from
    measured runs of the port (``repro_torch.obs.calibrate``, ``python
    -m repro_torch.obs --fit``; never a profile of the JAX package),
    else the built-in defaults.  Returns (net_or_None,
    source_tag) — the tag lands in ``last_auto_report()["net"]`` so a
    plan is auditable about which cost model chose its winner."""
    net = ctx.get("net")
    if net is not None:
        return net, "context"
    try:
        from repro_torch.obs.calibrate import fitted_network

        net, path = fitted_network(mesh_shape)
    except Exception:
        net, path = None, None
    if net is not None:
        return net, f"fitted:{path}"
    return None, "default"


def _candidates(reducer: str) -> tuple[str, ...]:
    # two-phase strategies emit raw RS/AG ops that would silently ignore
    # a non-flat reducer (same rule plan_sync enforces) — not candidates
    return tuple(
        n for n in fixed_strategy_names()
        if reducer == "flat" or not get_strategy(n).two_phase)


@register_strategy(
    "auto", meta=True,
    doc="simulate every fixed strategy, delegate to the predicted winner")
def plan_auto(
    plan: BucketPlan,
    *,
    skip_names: frozenset[str] = frozenset(),
    context: Mapping[str, Any] | None = None,
) -> CommSchedule:
    """Plan by simulation: run every fixed candidate through the
    discrete-event engine on this exact BucketPlan, return the winner's
    schedule.  ``context`` (supplied by ``plan_sync`` for meta strategies)
    carries mesh_shape / reducer / itemsize / an optional ComputeModel.

    When ``plan_sync`` is planning a ZeRO-1 StepProgram it adds a ``zero1``
    mapping ({"dp_axes", "dp_size", "clip", "defer"}) — the candidates
    are then ranked via ``rank_step_plans`` across ALL THREE step-plan
    families (``deferred:<s>`` / ``zero1:<s>`` / ``flat:<s>``, UPDATE
    ops costed, the deferred rows in pipelined steady state).  ``auto``
    delegates to the best strategy WITHIN the family the caller will
    execute (``defer`` → the pipelined rows, else the same-step zero1
    rows — a deferred-only win must not pick a strategy the scheduled
    execution can't realize); that family lands in
    ``last_auto_report()["plan"]`` and the full ranking in the report."""
    ctx = dict(context or {})
    mesh_shape = ctx.get("mesh_shape") or {
        a: 8 for b in plan.buckets for a in b.reduce_axes}
    reducer = ctx.get("reducer", "flat")
    sim = SimConfig(itemsize=int(ctx.get("itemsize", 4)), reducer=reducer,
                    fused_staging=bool(ctx.get("fused_staging", True)))
    net, net_source = _resolve_network(ctx, mesh_shape)
    zero1 = ctx.get("zero1")
    if zero1 is not None:
        pp = dict(ctx.get("pp") or {})
        pp_stages = int(pp.get("stages", 1) or 1)
        ranked = rank_step_plans(
            plan, mesh_shape, dp_axes=tuple(zero1["dp_axes"]),
            clip=bool(zero1.get("clip", False)),
            compute=ctx.get("compute"), net=net, sim=sim,
            accum=int(zero1.get("accum", 1)),
            accum_overlap=bool(zero1.get("accum_overlap", True)),
            pp=pp if pp_stages > 1 else None)
        # the winner must come from the family the caller will EXECUTE
        # (pipeline context → the joint pp rows, narrowed to the fixed
        # schedule when one is pinned — "auto" spans all of them, so it
        # can never rank worse than the best fixed row; otherwise
        # zero1_plan="deferred" → pipelined rows, else same-step rows);
        # the full ranking stays in the report for visibility,
        # including the flat baseline no zero1 run executes
        pp_sched = None
        if pp_stages > 1:
            sched = pp.get("schedule") or "auto"
            prefix = "pp:" if sched == "auto" else f"pp:{sched}:"
            row = next(n for n, _ in ranked if n.startswith(prefix))
            _, pp_sched, winner = row.split(":", 2)
            family = f"pp:{pp_sched}"
        else:
            family = "deferred" if zero1.get("defer") else "zero1"
            winner = next(n for n, _ in ranked
                          if n.startswith(family + ":")).split(":", 1)[1]
        _LAST_AUTO.clear()
        _LAST_AUTO.update({
            "winner": winner,
            "plan": family,
            "ranking": [(n, tl.step_time) for n, tl in ranked],
            "zero1": True,
            "net": net_source,
            **({"pp_schedule": pp_sched} if pp_sched else {}),
        })
        return get_strategy(winner).plan(plan, skip_names=skip_names)
    # in-scan psums are keyed on the CONFIGURED strategy, so a delegated
    # depcha runs as plain chains — rank it with the semantics the
    # delegated execution can actually realize (in-scan only counts when
    # the caller really dropped in-scan leaves from this plan)
    ranked = rank_strategies(
        plan, mesh_shape,
        compute=ctx.get("compute"), net=net, sim=sim,
        skip_names=skip_names,
        strategies=_candidates(reducer),
        in_scan_active=bool(skip_names))
    winner = ranked[0][0]
    _LAST_AUTO.clear()
    _LAST_AUTO.update({
        "winner": winner,
        "ranking": [(n, tl.step_time) for n, tl in ranked],
        "zero1": False,
        "net": net_source,
    })
    return get_strategy(winner).plan(plan, skip_names=skip_names)


# ----------------------------------------------------------- grid search

@dataclasses.dataclass(frozen=True)
class Prediction:
    """One grid cell: a (strategy, channels, bucket size) candidate and
    its simulated outcome."""

    strategy: str
    num_channels: int
    bucket_bytes: int
    step_time: float
    exposed_comm: float
    overlap_fraction: float
    num_ops: int

    def as_row(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def grid_search(
    grads_like: Any,
    param_specs: Any,
    mesh,
    *,
    mesh_shape: Mapping[str, int],
    compute: ComputeModel | None = None,
    net: NetworkModel | None = None,
    sim: SimConfig | None = None,
    strategies: Sequence[str] | None = None,
    channels: Sequence[int] = (1, 2, 4, 8),
    bucket_bytes: Sequence[int] = (1 << 20, 4 << 20, 16 << 20),
    comm_dtype=None,
    skip_names: frozenset[str] = frozenset(),
) -> list[Prediction]:
    """Simulate the full strategy × num_channels × bucket_bytes grid.

    Returns predictions sorted best-first; ``[0]`` is the tuned choice
    (its fields map 1:1 onto GradSyncConfig).  Single-chain strategies
    collapse the channel dimension (their plan ignores channels).
    """
    net = net or default_network()
    names = tuple(strategies) if strategies else fixed_strategy_names()
    out: list[Prediction] = []
    for bb in bucket_bytes:
        for ch in channels:
            plan = make_bucket_plan(
                grads_like, param_specs, mesh,
                bucket_bytes=bb, num_channels=ch,
                comm_dtype=comm_dtype if comm_dtype is not None
                else torch.float32)
            for name in names:
                if get_strategy(name).single_chain and ch != channels[0]:
                    continue        # funnel ignores channels: sim once
                _, tl = simulate_strategy(
                    name, plan, mesh_shape, compute=compute, net=net,
                    sim=sim, skip_names=skip_names)
                out.append(Prediction(
                    strategy=name, num_channels=ch, bucket_bytes=bb,
                    step_time=tl.step_time, exposed_comm=tl.exposed_comm,
                    overlap_fraction=tl.overlap_fraction,
                    num_ops=len(tl.events)))
    out.sort(key=lambda p: (p.step_time, p.strategy,
                            p.num_channels, p.bucket_bytes))
    return out

"""Training runtime: the data × model parallel step factory and the
loop (``repro/runtime/train_loop.py``).

One step: forward and backward on the local batch (split into
``microbatch`` microbatches whose gradients are summed into f32
accumulators), ``GradSync`` over the gradients (the strategy's schedule
of bucketed all-reduces, staged through the fused pack/unpack kernels),
``clip_by_global_norm``, the optimizer update, and an all-reduce of the
loss for logging.  The loss divides by the GLOBAL batch, so the summed
gradients are the mean.

Under ZeRO-1 (``zero1_mode`` with an ``optim.zero1`` optimizer) the
optimizer state is sharded over the data-parallel ranks.  The
``scheduled`` plan runs the update inside ``GradSync``'s StepProgram:
per bucket a reduce-scatter, the UPDATE of the rank's shard, an
all-gather of the updates, planned by the same strategy, with clipping
as the scheduled NORM op.  ``deferred`` carries the update shards to the
top of the next step (``opt_state["pending"]``; ``TrainStep.finalize``
flushes them); ``monolithic`` runs the wrapper's own single-bucket
schedule after the sync (no clipping, as the reference).

Under a strategy that ``uses_in_scan`` (depcha) with a config that asks
for it (``depcha_in_scan``), the family's stacked layer leaves are
summed inside the backward, one collective a layer (``core/overlap.py::
LayerSync``, set up once here, begun and finished around each
microbatch), and the post-backward schedule skips them.

Tensor parallelism (a mesh with a "model" extent tp > 1, the config's
``tp``): each rank holds its shards, the forward runs on the rank's
``ModelAxis`` (``models/common.py::model_axis``), and, as the reference's
``shard_map(check_vma=False)`` step, every gradient comes out tp × its
per-shard value and is divided by tp: here the loss is divided by tp
before the backward, which for tp a power of two is bit-identical.  The
bucket plan is built on the local shard shapes; a replicated leaf's
partial gradient is summed over "model" by the sync (its reduce axes
include "model").  The loss is summed over the dp axes only.  Clipping
takes the global norm: each leaf's squares summed over exactly the axes
its spec shards it over (one all-reduce a set of axes, on the clip's own
communicators), the replicated leaves' counted once (the reference clips
by each rank's own shards: ROADMAP queue 3).

FSDP (``cfg.fsdp``): the block leaves of ``_FSDP_DIM`` are stored
sharded over the dp axes and gathered a layer inside the forward (and
the remat's recompute) on the rank's ``FsdpAxes``, a communicator of
their own; the backward reduce-scatters their gradients, which are then
the dp sum: no GradSync bucket holds them, and depcha's in-backward sync
passes them through.  ZeRO-1 with FSDP is refused, as the reference
refuses it (its dp plan wants every leaf replicated over dp).

Pipeline stages (a "stage" mesh axis, ``pp_stages``): each rank holds
its stage's slice of the stacked blocks and runs the family's
``pipeline_train_forward`` over the ``microbatch`` waves
(``parallel/pipeline.py``), gpipe in one backward or 1f1b a chunk of S
microbatches at a time; the stage-replicated leaves are summed over
"stage" by the sync, and the clip gathers the staged leaves' row sums
over "stage" so a staged run clips as its stage = 1 twin, bit for bit.

Every communicator a step creates is recorded (``dependency.comm_scope``)
and destroyed by ``TrainStep.close``, collective: the step's life ends
there.

Each stage runs under a profiler label (``step.gather_pending``,
``step.forward``, ``step.backward``, ``step.gradsync``,
``step.depcha_wait``, ``step.optimizer``, ``step.loss_allreduce``;
GradSync's ops nest as ``comm.<kind>...``), so a ``torch.profiler``
trace splits the step by layer.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import statistics
import time
from typing import IO, Any, Callable

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import GradSync, GradSyncConfig, get_strategy
from repro_torch.core import dependency as dep
from repro_torch.core.dependency import coset_groups, reduce_key, resolve_device
from repro_torch.models.common import fsdp_axes, model_axis
from repro_torch.models.registry import family_of
from repro_torch.obs import EventLog, MetricsRegistry, comm_byte_counters, heartbeat_line
from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    clip_by_global_norm,
)
from repro_torch.optim.zero import scheduled_update, zero1_pending, zero1_state
from repro_torch.parallel.pipeline import NO_STAGE_AXIS, stage_axis
from repro_torch.parallel.sharding import (
    MODEL_AXIS,
    STAGE_AXIS,
    dp_axes_of,
    dp_index,
    flat_spec_axes,
    stage_shard_specs,
)
from repro_torch.utils.trees import flatten_with_names, tree_leaves, tree_unflatten

ZERO1_PLANS = ("scheduled", "deferred", "monolithic")
PP_SCHEDULES = ("auto", "gpipe", "1f1b")     # "auto": choose_pp_schedule picks


class SimulatedFailure(RuntimeError):
    """Injected node failure (testing the recovery path)."""


class TransientStepError(RuntimeError):
    """Injected transient step fault, retried IN PLACE (rung 1 of the
    elastic policy ladder): the step committed no state, so the same step
    runs again up to ``step_retries`` times before escalating to
    checkpoint recovery."""


class RankLost(SimulatedFailure):
    """Injected loss of mesh member(s): THIS mesh cannot continue.  The
    Trainer attaches the last committed state (``.step``, ``.params`` —
    the model, whose parameters hold it — and ``.opt_state``) and
    re-raises: recovery is a NEW mesh, the supervisor's job
    (``repro_torch.elastic.supervisor``)."""

    def __init__(self, message: str = "rank lost"):
        super().__init__(message)
        self.step: int = 0
        self.params: Any = None
        self.opt_state: Any = None


class RemeshRequest(SimulatedFailure):
    """Straggler-driven shrink request (opt-in through ``remesh_hook``):
    carries the post-step state as ``RankLost`` does, for the
    supervisor's shrink; the state is healthy, the mesh is slow."""

    def __init__(self, message: str = "remesh requested"):
        super().__init__(message)
        self.step: int = 0
        self.params: Any = None
        self.opt_state: Any = None


@dataclasses.dataclass
class TrainStep:
    fn: Callable[..., Any]   # (model, opt_state, batch, step) -> (model, opt_state, metrics)
    gradsync: GradSync
    device: torch.device
    layer_sync: Any = None   # core.overlap.LayerSync under depcha in-scan, else None
    opt_init: Callable[..., Any] | None = None
    # deferred zero1 only: (model, opt_state) -> model, applying the carried
    # update shards (what the next step's top would) and zeroing the carry
    finalize: Callable[..., Any] | None = None
    # what a checkpoint or the state codec reads: the mesh, the params'
    # specs (a tree like the params) and whether the optimizer is ZeRO-1's
    mesh: Any = None
    param_specs: Any = None
    zero1: bool = False
    # the communicators the step made besides its GradSync's (the loss
    # group, the clip's, the in-backward sync's, the model, FSDP and stage
    # axes), in creation order: what ``close`` destroys
    comms: list = dataclasses.field(default_factory=list)

    def close(self) -> None:
        """Collective (every world rank, the same step): destroy every
        communicator the step made, in creation order, the GradSync's
        first (its peer rings, then its chains' and pods' groups), then
        the step's own.  The step runs no more after it."""
        self.gradsync.close()
        dep.destroy_groups(self.comms)

    def init_opt(self) -> Any:
        """Zero-initialized optimizer state: under ZeRO-1 sharded, sized
        from the dp plan (scheduled, deferred) or the local params
        (monolithic); else the optimizer's ``init`` of the params."""
        return self.opt_init()

    @property
    def opt_state_like(self) -> Any:
        """``init_opt()``'s tree on ``meta``: its structure, shapes and
        dtypes, no memory."""
        return self.opt_init(torch.device("meta"))

    @property
    def member(self) -> bool:
        """Whether this process is a rank of the step's mesh (a rank
        outside an elastic rung builds the step, for its collectives,
        and runs none)."""
        return dep.mesh_rank(self.mesh) is not None

    @property
    def mesh_group(self) -> Any:
        """The communicator over every rank of the mesh (None for a
        mesh of one rank in a larger world, and outside the mesh)."""
        comms = self.gradsync.groups[min(self.gradsync.groups)]
        return comms.get(self.mesh.axis_names)


def pipeline_split(batch: dict, microbatch: int) -> dict:
    """The reference's ``split``: every batch tensor reshaped to
    (M, rows / M, ...); a scalar broadcast to (M,), ``global_tokens`` as
    its 1/M share (so each microbatch's loss is its share of the batch
    mean)."""
    out = {}
    for k, x in batch.items():
        if x.dim() == 0:
            x = x / microbatch if k == "global_tokens" else x
            out[k] = x.expand(microbatch)
            continue
        if x.shape[0] % microbatch:
            raise ValueError(f"batch {k!r} of {x.shape[0]} rows does not split "
                             f"into {microbatch} microbatches")
        out[k] = x.reshape(microbatch, x.shape[0] // microbatch, *x.shape[1:])
    return out


def split_microbatches(batch: dict, microbatch: int) -> list[dict]:
    """``pipeline_split``'s microbatches, one dict each."""
    split = pipeline_split(batch, microbatch)
    return [{k: v[i] for k, v in split.items()} for i in range(microbatch)]


def _pp_check(cfg, api, mesh, pp_stages: int, pp_schedule: str) -> str:
    """The reference's refusals of a staged step (``ValueError``), and the
    schedule it runs."""
    if STAGE_AXIS not in mesh.axis_names:
        raise ValueError(f"pp_stages={pp_stages} needs a {STAGE_AXIS!r} mesh axis "
                         f"(make_smoke_mesh(..., stage=N)); mesh has {mesh.axis_names}")
    if mesh.shape[STAGE_AXIS] != pp_stages:
        raise ValueError(f"pp_stages={pp_stages} != mesh {STAGE_AXIS!r} extent "
                         f"{mesh.shape[STAGE_AXIS]}")
    if api.pipeline_train_forward is None:
        raise ValueError(f"family {api.family!r} has no pipeline_train_forward")
    if getattr(cfg, "depcha_in_scan", False):
        raise ValueError("depcha_in_scan is not supported with pipeline stages")
    n_layers = getattr(cfg, "n_layers", 0)
    if n_layers and n_layers % pp_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by pp_stages={pp_stages}")
    if pp_schedule not in PP_SCHEDULES:
        raise ValueError(f"pp_schedule must be one of {PP_SCHEDULES}, "
                         f"got {pp_schedule!r}")
    return pp_schedule


def _micro_compute(cfg: Any, batch_like: dict | None, mesh, microbatch: int):
    """The PER-MICROBATCH ``repro_torch.sim.compute.ComputeModel`` a meta
    strategy (``auto``) ranks with, from the batch the step will run
    (``batch_like``: this rank's rows; the global batch is them times the
    dp extent) and the mesh's size, as the reference's ``_micro_compute``.
    None without a batch, or for a config outside the FLOP model
    (``auto`` then ranks on communication alone)."""
    if not batch_like:
        return None
    try:
        from repro_torch.sim.compute import compute_model_for

        dims = next(tuple(batch_like[k].shape) for k in sorted(batch_like)
                    if batch_like[k].dim() > 0)
        dp = math.prod(mesh.shape[a] for a in dp_axes_of(mesh))
        cm = compute_model_for(
            cfg, global_batch=dims[0] * dp,
            seq_len=dims[1] if len(dims) > 1 else 1, n_devices=mesh.size)
        if microbatch > 1:
            cm = dataclasses.replace(cm, t_fwd=cm.t_fwd / microbatch,
                                     t_bwd=cm.t_bwd / microbatch)
        return cm
    except Exception:
        return None


def pp_activation_bytes(cfg: Any, batch_like: dict | None, microbatch: int) -> int:
    """The stage-boundary payload a hop: one microbatch of (local rows,
    seq, d_model) in the compute dtype (0 without a token batch)."""
    if batch_like is None or "tokens" not in batch_like or batch_like["tokens"].dim() != 2:
        return 0
    rows, seq = batch_like["tokens"].shape
    return (rows // max(microbatch, 1) * seq * cfg.d_model
            * torch.empty((), dtype=cfg.dtype).element_size())


def resolve_pp_schedule(cfg: Any, mesh, pp_stages: int, pp_schedule: str,
                        microbatch: int, batch_like: dict | None = None) -> str:
    """The schedule a staged step runs: ``pp_schedule``, or for "auto"
    ``repro_torch.sim.choose_pp_schedule``'s pick (the argmin of the
    analytic pipeline wall over gpipe and 1f1b) at the stage-boundary
    payload and the whole step's compute model, as the reference's
    ``make_train_step`` resolves it."""
    if pp_schedule != "auto":
        return pp_schedule
    from repro_torch.sim.autotune import choose_pp_schedule

    mb = max(int(microbatch), 1)
    return choose_pp_schedule(
        pp_stages, mb, activation_bytes=pp_activation_bytes(cfg, batch_like, mb),
        compute=_micro_compute(cfg, batch_like, mesh, 1),
        mesh_shape=dict(mesh.shape))


def make_train_step(
    cfg: Any,
    mesh,
    sync: GradSyncConfig,
    optimizer: Optimizer,
    *,
    model: torch.nn.Module,
    clip_norm: float = 1.0,
    zero1_mode: bool = False,
    zero1_plan: str = "scheduled",
    microbatch: int = 1,
    pp_stages: int = 1,
    pp_schedule: str = "auto",
    batch_like: dict | None = None,
    device: str | torch.device = "cuda",
) -> TrainStep:
    """Build the train step for one (arch, mesh, sync).

    ``model`` gives the parameter shapes (its ``params_tree()`` is the
    reference's tree).  The step updates the model's parameters and
    ``opt_state`` in place and returns them with the metrics
    (``loss`` summed over ranks, ``grad_norm``).  Runs on ``device``:
    CUDA unless the caller passes ``"cpu"``; raises if CUDA is asked for
    and absent.

    ``zero1_mode`` needs ``optimizer`` wrapped by ``optim.zero1``; the dp
    axes are then excluded from the sync (the reduce-scatter is their
    sum) and ``zero1_plan`` is one of ``ZERO1_PLANS`` (module docstring).
    Start from ``TrainStep.init_opt()``.

    ``microbatch`` > 1 accumulates: each microbatch's forward and backward
    in turn, its gradients added into f32 accumulators from zero
    (``acc + g``, the reference's order), loss and gradients divided by M
    at the end.  The adds run inside each backward, from
    post-accumulate-grad hooks, the moment autograd has a leaf's gradient
    (whose ``.grad`` is dropped then); the in-backward sync's rows are
    added after it.  The sync starts after the last backward: launching
    buckets from inside it (the reference's ``accum_overlap``) is not
    ported (ROADMAP queue 1 item 15b, part 5), so a meta strategy ranks
    with ``zero1_accum_overlap=False``, the order the step runs.

    Pipeline stages (DESIGN.md §15): with a "stage" mesh axis
    (``make_smoke_mesh(..., stage=S)``, S = ``pp_stages``; extent 1 runs
    the staged path with a trivial pipeline) the stacked block params
    are sharded over "stage" on dim 0 (``stage_shard_specs``) and the
    step runs the family's ``pipeline_train_forward``: ``microbatch`` is
    the pipeline's M, the batch split by ``pipeline_split``, as the
    accumulation path splits it.  ``pp_schedule`` "gpipe" differentiates
    one M-wave program in one backward; "1f1b" runs chunks of S
    microbatches, each through its own backward, the gradients summed in
    f32 (the reference's executed 1F1B: at most S microbatches of
    activations live).  "auto" picks one of them by simulation
    (``resolve_pp_schedule``).  Loss and
    gradients are divided by M; the loss is summed over "stage" and the
    dp axes.  The stage-replicated leaves (the embedding, ``ln_f``, the
    head) are summed over "stage" by the sync, the stages that do not
    use them adding zeros.  ``batch_like`` (a batch of the step's shape)
    sizes the stage-boundary payload for ``GradSyncConfig``'s pipeline
    context and, under a meta strategy (``auto``), the compute model it
    ranks with (``sim_compute``, per microbatch).  Refused as in the reference: a mesh without "stage" or of
    another extent, a family without the hook, ``depcha_in_scan``,
    ``n_layers`` not divisible by S, scheduled ZeRO-1 with clipping.
    """
    if zero1_plan not in ZERO1_PLANS:
        raise ValueError(f"unknown zero1_plan {zero1_plan!r}, want one of {ZERO1_PLANS}")
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    zmeta = optimizer.zero1_meta
    if zero1_mode != (zmeta is not None):
        raise ValueError("zero1_mode and an optimizer wrapped by optim.zero1 go "
                         "together: pass both or neither")
    device = resolve_device(device)
    api = family_of(cfg)
    params_like = model.params_tree()
    pp_active = pp_stages > 1 or STAGE_AXIS in mesh.axis_names
    pp_sched = _pp_check(cfg, api, mesh, pp_stages, pp_schedule) if pp_active else None
    dp = dp_axes_of(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    tp = mesh.shape.get(MODEL_AXIS, 1)
    if getattr(cfg, "tp", 1) != tp:
        raise ValueError(f"the config's tp={getattr(cfg, 'tp', 1)} is not the mesh's "
                         f"model extent {tp}")
    # sum leaves inside the backward, and skip them from the post-backward
    # schedule, ONLY when the strategy and the config both ask for it
    in_scan = (api.in_scan_names(params_like)
               if get_strategy(sync.strategy).uses_in_scan
               and getattr(cfg, "depcha_in_scan", False) else frozenset())
    if zero1_mode and in_scan and dp_size > 1:
        # the reference sums these leaves twice: in the backward and again
        # in the zero1 reduce-scatter, whose dp plan covers every leaf
        raise ValueError(
            f"ZeRO-1 with depcha's in-backward sum at dp={dp_size} would sum "
            f"the stacked leaves twice; use another strategy, or "
            f"depcha_in_scan=False")
    fsdp = getattr(cfg, "fsdp", False)
    if zero1_mode and fsdp:
        raise ValueError("ZeRO-1 with FSDP: the params are already sharded over the dp "
                         "axes; refused as in the reference (core/stepprogram.py), "
                         "ROADMAP queue 3")
    zero1_scheduled = zero1_mode and zero1_plan != "monolithic"
    defer_ag = zero1_mode and zero1_plan == "deferred"
    if pp_active and zero1_scheduled and clip_norm:
        # the NORM op sums squared shard norms over the dp axes only: the
        # stage-sharded blocks' terms would be missing from the norm
        raise ValueError("scheduled ZeRO-1 clipping is not supported with pipeline "
                         "stages; pass clip_norm=0")
    if pp_active:
        pp_sched = resolve_pp_schedule(cfg, mesh, pp_stages, pp_sched, microbatch,
                                       batch_like)
        sync = dataclasses.replace(sync, pp_stages=pp_stages, pp_schedule=pp_sched,
                                   pp_microbatches=max(microbatch, 1),
                                   pp_activation_bytes=pp_activation_bytes(
                                       cfg, batch_like, microbatch))
    if zero1_mode:
        inner, z_dp_size, _ = zmeta
        if z_dp_size != dp_size:
            raise ValueError(f"optimizer sharded {z_dp_size} ways on a dp mesh of {dp_size}")
        sync = dataclasses.replace(sync, exclude_axes=tuple(dp))
    if zero1_scheduled:
        sync = dataclasses.replace(
            sync, zero1_dp_axes=tuple(dp), zero1_clip=bool(clip_norm),
            zero1_defer_ag=defer_ag, zero1_accum=microbatch,
            zero1_accum_overlap=False)
    if get_strategy(sync.strategy).meta and sync.sim_compute is None:
        sync = dataclasses.replace(
            sync, sim_compute=_micro_compute(cfg, batch_like, mesh, microbatch))
    specs = api.param_specs(params_like, cfg)
    if pp_active:
        specs = stage_shard_specs(specs)
    # every communicator made here is the step's (``close`` destroys them)
    with dep.comm_scope() as made:
        layer_sync = None
        if in_scan:
            layer_sync = (api.layer_sync(cfg, params_like, mesh, device)
                          if api.layer_sync else None)
            if layer_sync is None or set(layer_sync.names) != set(in_scan):
                raise ValueError(f"{api.family}: the in-backward sync does not cover "
                                 f"the in-scan leaves")
        gs = GradSync(sync, mesh, specs, params_like, in_scan_names=in_scan, device=device)
        # the loss is summed over "stage" and the dp axes (None: a group of one)
        loss_axes = dp + ((STAGE_AXIS,) if pp_active else ())
        loss_group = coset_groups([loss_axes], mesh, device)[reduce_key(loss_axes, mesh)]
        stage_ax = stage_axis(mesh, device) if pp_active else NO_STAGE_AXIS
        fwd_kw = {"layer_sync": layer_sync} if layer_sync is not None else {}
        if tp > 1:
            fwd_kw["model_axis"] = model_axis(mesh, device)
        if fsdp:
            fwd_kw["fsdp"] = fsdp_axes(mesh, tuple(cfg.dp_axes), device)
        # the clip's squares: each sharded leaf's summed over its spec's
        # axes; a staged leaf's rows gathered over "stage" by the clip itself
        staged = frozenset(n for n, sp in flatten_with_names(specs)[0]
                           if pp_active and sp and sp[0] == STAGE_AXIS)
        shard_sets = {n: key for n, sp in flatten_with_names(specs)[0]
                      if (key := reduce_key(flat_spec_axes(sp) - (
                          {STAGE_AXIS} if n in staged else set()), mesh))}
        clip_kw = {}
        if clip_norm and not zero1_mode:
            if shard_sets:
                clip_kw.update(shard_sets=shard_sets, comms=dep.mesh_comms(
                    [0], set(shard_sets.values()), mesh, device)[0])
            if staged:
                clip_kw.update(staged=staged, stage_group=stage_ax.group)
        if zero1_mode and not zero1_scheduled and optimizer.zero1_setup is not None:
            optimizer.zero1_setup(mesh, device)
    # a rank outside the mesh (an elastic rung of fewer ranks than the
    # world) creates every communicator with the members and steps never
    me = dep.mesh_rank(mesh)
    rank = dp_index(me, mesh) if me is not None else 0

    def init_opt(on: torch.device | None = None):
        on = device if on is None else on
        if zero1_scheduled:
            state = zero1_state(inner, gs.dp_plan, dp_size, on)
            if defer_ag:
                state["pending"] = zero1_pending(gs.dp_plan, dp_size, on)
            return state
        named = flatten_with_names(model.params_tree())[0]
        return optimizer.init({n: p.detach() if on.type != "meta"
                               else torch.empty(p.shape, dtype=p.dtype, device=on)
                               for n, p in named})

    pend_keys = ()
    post_sched = None
    if defer_ag:
        pend_keys = tuple((b.bucket_id, str(i)) for i, b in enumerate(gs.dp_plan.buckets))
        post_sched = gs.program.post_schedule()

    def gather_pending(model, pending):
        """The PRE program: all-gather the previous step's update shards
        and apply them to the params (the step's top and ``finalize``
        share it, so the two stay bit-identical)."""
        named = flatten_with_names(model.params_tree())[0]
        prev = gs.apply_pending({bid: pending[k] for bid, k in pend_keys})
        apply_updates({n: p.data for n, p in named},
                      dict(flatten_with_names(prev)[0]))

    def finalize(model, opt_state):
        gather_pending(model, opt_state["pending"])
        for t in opt_state["pending"].values():
            t.zero_()
        return model

    def backward(tree, named, batch, acc=None):
        """One forward and backward.  With ``acc`` (name → f32 tensor)
        each leaf's gradient is added into its accumulator by a hook, in
        the backward, and dropped.  Returns the loss and the names the
        hooks took."""
        hooks = []
        seen: set[str] = set()
        if acc is not None:
            def add_into(n):
                def hook(p):
                    acc[n].add_(p.grad)
                    p.grad = None
                    seen.add(n)
                return hook
            hooks = [p.register_post_accumulate_grad_hook(add_into(n))
                     for n, p in named if n not in in_scan]
        try:
            if layer_sync is not None:
                layer_sync.begin()
            with record_function("step.forward"):
                loss = api.train_forward(tree, batch, cfg, **fwd_kw)
            with record_function("step.backward"):
                # tp > 1: the gradients come out tp x (psum's transpose)
                (loss / tp if tp > 1 else loss).backward()
        finally:
            for h in hooks:
                h.remove()
        return loss.detach(), seen

    def finish_sync(named) -> None:
        """Wait on the in-backward sync and write its reduced rows into
        the stacked leaves' ``.grad``."""
        if layer_sync is not None:
            stacked = dict(named)
            with record_function("step.depcha_wait"):
                layer_sync.finish([stacked[n] for n in layer_sync.names])

    def check_grads(named, skip) -> None:
        missing = [n for n, p in named if p.grad is None and n not in skip]
        if missing:
            raise RuntimeError(f"no gradient for {missing}")

    # one backward without a StepProgram keeps the in-backward sync's wait
    # after the post-backward schedule is issued, so the two overlap
    late_finish = microbatch == 1 and not zero1_scheduled

    def pipeline_grads(tree, named, batch) -> tuple[torch.Tensor, list]:
        """The staged step's loss and f32 gradients, both divided by M: one
        backward over the M-wave program (gpipe) or one a chunk of S
        microbatches, summed into f32 (1f1b).  A leaf this stage does not
        use (the embedding past stage 0, the head before the last) has a
        zero gradient."""
        mbs = pipeline_split(batch, microbatch)
        chunk = microbatch if pp_sched == "gpipe" else pp_stages
        acc = {n: None for n, _ in named}
        loss = None
        for c0 in range(0, microbatch, chunk):
            part = {k: v[c0:c0 + chunk] for k, v in mbs.items()}
            with record_function("step.forward"):
                l = api.pipeline_train_forward(tree, part, cfg, stage_axis=stage_ax,
                                               **fwd_kw)
            with record_function("step.backward"):
                (l / tp if tp > 1 else l).backward()
            loss = l.detach() if loss is None else loss + l.detach()
            for n, p in named:
                if p.grad is not None:
                    g = p.grad.to(torch.float32)
                    acc[n] = g if acc[n] is None else acc[n].add_(g)
                    p.grad = None
        return loss / microbatch, [
            (a if a is not None else torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device)).div_(microbatch)
            for (_, p), a in zip(named, acc.values())]

    def step(model, opt_state, batch, step_idx: int):
        if me is None:
            raise RuntimeError(f"rank {dist.get_rank()} is outside the mesh over the "
                               f"world ranks {mesh.world_ranks}: it makes no step")
        model.zero_grad(set_to_none=True)
        tree = model.params_tree()
        named, treedef = flatten_with_names(tree)
        params = {n: p.data for n, p in named}
        if defer_ag:
            with record_function("step.gather_pending"):
                # last step's deferred updates land before the forward
                gather_pending(model, opt_state.pop("pending"))
        if pp_active:
            loss, grad_list = pipeline_grads(tree, named, batch)
        elif microbatch == 1:
            loss, _ = backward(tree, named, batch)
            if late_finish:
                # the in-scan leaves' gradients come from the in-backward sync
                check_grads(named, in_scan)
            else:
                finish_sync(named)
                check_grads(named, ())
            grad_list = [p.grad for _, p in named]
        else:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in named}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for mb in split_microbatches(batch, microbatch):
                mb_loss, seen = backward(tree, named, mb, acc)
                finish_sync(named)       # its slots are the next backward's
                check_grads(named, seen)
                for n, p in named:
                    if n not in seen:
                        acc[n].add_(p.grad)
                        p.grad = None
                loss = loss + mb_loss
            loss = loss / microbatch
            grad_list = [acc[n].div_(microbatch) for n, _ in named]
            del acc
        grads_tree = tree_unflatten(treedef, grad_list)
        del grad_list
        gnorm = torch.zeros((), device=device)
        if zero1_scheduled:
            # the StepProgram: the optimizer runs inside GradSync's
            # schedule, clipped by its NORM op
            update_fn, new_state = scheduled_update(
                inner, gs.dp_plan, tree, opt_state, step_idx, dp_size=dp_size, rank=rank)
            aux: dict = {}
            with record_function("step.gradsync"):
                updates = gs(grads_tree, update_fn=update_fn, clip_norm=float(clip_norm or 0.0),
                             aux=aux, schedule=post_sched)
            del grads_tree
            opt_state["inner"] = new_state["inner"]
            if defer_ag:
                # the gathers wait for the next step's top
                opt_state["pending"] = {k: aux["update_shards"][bid] for bid, k in pend_keys}
            else:
                with record_function("step.optimizer"):
                    apply_updates(params, dict(flatten_with_names(updates)[0]))
            del updates
            gnorm = aux.get("grad_norm", gnorm)
        else:
            with record_function("step.gradsync"):
                grads = dict(flatten_with_names(gs(grads_tree))[0])
            del grads_tree
            if late_finish and layer_sync is not None:
                finish_sync(named)
                grads.update({n: p.grad for n, p in named if n in in_scan})
            with record_function("step.optimizer"):
                if clip_norm and not zero1_mode:
                    # (monolithic zero1 does not clip: its gradients are
                    # not yet summed over dp here, as in the reference)
                    grads, gnorm = clip_by_global_norm(grads, clip_norm, **clip_kw)
                updates, opt_state = optimizer.update(grads, opt_state, params,
                                                      step_idx)
                del grads
                apply_updates(params, updates)
        with record_function("step.loss_allreduce"):
            if loss_group is not None:
                dep.collective(dist.all_reduce, loss_group, loss).wait()
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(step, gs, device, layer_sync, init_opt,
                     finalize if defer_ag else None, mesh=mesh, param_specs=specs,
                     zero1=zero1_mode, comms=made)


class Trainer:
    """Fault-tolerant training driver (``repro/runtime/train_loop.py::
    Trainer``): runs the step over the pipeline's batches, times each
    step and keeps the losses, with the reference's ``repro.obs``
    accounting and its rungs of the elastic policy ladder.

    - checkpoint/restart through ``ckpt`` (a ``repro_torch.checkpoint.
      CheckpointManager``, or the elastic ``ElasticCheckpointer``):
      ``run`` first restores the latest checkpoint, if there is one,
      saves every ``ckpt.every`` steps, and waits for the last save.  A
      restore writes into the live parameters and optimizer tensors
      (``copy_``): the step and its syncers hold references to them.  A
      ``zero1_plan="deferred"`` step restores only a checkpoint that
      holds its ``pending`` carry (``_guard_pending``).
    - batches are a function of (seed, step), so a resume is exact.
    - ``fail_at``: a ``SimulatedFailure`` at those steps (once each),
      recovered by restoring the latest checkpoint and replaying (rung 2).
    - ``fault_injector(step)`` runs at the top of every step attempt: a
      ``TransientStepError`` is retried in place up to ``step_retries``
      times (rung 1; ``retry``), then recovered as a failure
      (``retry_exhausted``); a ``RankLost`` carries the step and the
      committed state out to the caller (``rank_lost``: the supervisor
      builds a new mesh).
    - stragglers: a step slower than ``straggler_factor`` × the running
      median is a ``straggler`` event; ``straggler_patience`` in a row
      make a ``remesh_requested`` event, and when ``remesh_hook(step)``
      answers ``"shrink"`` a ``RemeshRequest`` with the post-step state.
      With a hook each step's time is the MAX over the mesh's ranks (one
      scalar all-reduce a step), so every rank decides alike; without
      one each rank's events are its own and nothing more is issued.

    The first step is reported apart, as ``compile_time`` (the gauge
    ``compile_time_s`` and a ``compile`` event, the reference's names):
    it carries one-time set-up such as kernel loading and communicator
    creation.  Into ``metrics`` (a ``MetricsRegistry``, new if None) go
    ``mem.state_bytes`` (params + optimizer state) and one step's
    ``comm_bytes.<kind>.<reducer>.<phase>`` counters from the planned
    schedule, once a run; then a ``step_time_s`` histogram of the later
    steps, ``steps_total``, ``loss`` and ``grad_norm`` (and
    ``tokens_total`` / ``tokens_per_s`` for token batches) each step.
    ``events_path`` (a path or file object) gets one JSONL ``step`` event
    a step and every lifecycle event (``restore``, ``recover``,
    ``retry``, ``retry_exhausted``, ``rank_lost``, ``failure``,
    ``straggler``, ``remesh_requested``).  Each logged step prints the
    trainer line and the heartbeat.

    Under ZeRO-1 ``mem.state_bytes`` counts the rank's sharded optimizer
    state (and, deferred, the carried update shards).  Once a run the
    simulator's estimate of the planned schedule goes into the gauges
    ``sim.step_time_s`` and ``sim.exposed_comm_s`` (``repro_torch.sim.
    simulate`` under the sync's ``sim_compute``, comm itemsize, reducer
    and staging mode); an estimate never fails a step."""

    def __init__(self, step_fn: TrainStep, pipeline, ckpt=None, *,
                 fail_at: frozenset[int] = frozenset(),
                 straggler_factor: float = 3.0,
                 straggler_patience: int = 3,
                 step_retries: int = 0,
                 fault_injector: Callable[[int], None] | None = None,
                 remesh_hook: Callable[[int], str | None] | None = None,
                 log_every: int = 10,
                 printer: Callable[[str], None] = print,
                 metrics: MetricsRegistry | None = None,
                 events_path: str | IO[str] | None = None):
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.ckpt = ckpt
        if ckpt is not None and hasattr(ckpt, "attach_step"):
            ckpt.attach_step(step_fn)
        self.fail_at = set(fail_at)
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.step_retries = step_retries
        self.fault_injector = fault_injector
        self.remesh_hook = remesh_hook
        self.log_every = log_every
        self.printer = printer
        self.step_times: list[float] = []
        self.first_step_time: float | None = None
        self.events: list[dict] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events_path = events_path
        self._log: EventLog | None = None

    def _event(self, kind: str, **fields) -> None:
        """A lifecycle event, in memory and on the JSONL stream."""
        self.events.append({"kind": kind, **fields})
        if self._log is not None:
            self._log.emit(kind, **fields)

    def _account_static(self, model, opt_state) -> None:
        """The per-run gauges and counters: resident state bytes, one
        execution of the planned schedule's comm bytes, and the
        simulator's step time and exposed communication for the plan."""
        leaves = list(model.parameters()) + [
            t for t in tree_leaves(opt_state) if isinstance(t, torch.Tensor)]
        self.metrics.gauge("mem.state_bytes").set(
            sum(t.numel() * t.element_size() for t in leaves))
        gs = self.step_fn.gradsync
        comm_byte_counters(gs.schedule, self.metrics,
                           itemsize=gs.cfg.comm_dtype.itemsize)
        try:
            from repro_torch.sim.engine import SimConfig, simulate

            tl = simulate(gs.schedule, gs.mesh_shape, compute=gs.cfg.sim_compute,
                          sim=SimConfig(itemsize=gs.cfg.comm_dtype.itemsize,
                                        reducer=gs.cfg.reducer,
                                        fused_staging=gs.cfg.use_fused_staging))
            self.metrics.gauge("sim.step_time_s").set(tl.step_time)
            self.metrics.gauge("sim.exposed_comm_s").set(tl.exposed_comm)
        except Exception:
            pass    # an estimate must never take down training

    def _guard_pending(self, step: int) -> None:
        """Deferred-plan restore guard: a step that carries an
        ``opt_state["pending"]`` tree restores only a checkpoint that
        holds one, else the resume would read a zero carry where the
        saved run had live update shards, and diverge."""
        like = self.step_fn.opt_state_like
        if not isinstance(like, dict) or "pending" not in like:
            return
        manifest = getattr(self.ckpt, "manifest", None)
        if manifest is None:
            return
        try:
            names = manifest(step)
        except (OSError, KeyError, ValueError):
            return      # no manifest to check against: restore decides
        if not any("pending" in n for n in names):
            raise RuntimeError(
                f"checkpoint at step {step} has no opt_state['pending'] "
                f"carry but this zero1_plan='deferred' step requires one "
                f"— resuming would silently drop the deferred updates "
                f"(flush via TrainStep.finalize before saving, or restore "
                f"into a scheduled-plan step)")

    def _restore(self, model, opt_state) -> int:
        """Restore the latest checkpoint into the live tensors; its step."""
        self._guard_pending(self.ckpt.latest())
        s, state = self.ckpt.restore({"params": model.params_tree(), "opt": opt_state})
        copy_into({"params": model.params_tree(), "opt": opt_state}, state)
        return s

    def _recover(self, model, opt_state) -> int | None:
        """Restore and replay (rung 2): the step to resume at, or None
        without a checkpoint."""
        if self.ckpt is None or self.ckpt.latest() is None:
            return None
        s = self._restore(model, opt_state)
        self._event("recover", step=s)
        return s

    def _step_time(self, dt: float) -> float:
        """The step's time; with a remesh hook the max over the mesh."""
        if self.remesh_hook is None:
            return dt
        group = self.step_fn.mesh_group
        if group is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.step_fn.device)
        dep.collective(functools.partial(dist.all_reduce, op=dist.ReduceOp.MAX),
                       group, t).wait()
        return float(t[0])

    def run(self, model, opt_state, num_steps: int, start_step: int = 0
            ) -> tuple[Any, Any, dict]:
        with EventLog(self.events_path) as event_log:
            self._log = event_log
            try:
                return self._run(model, opt_state, num_steps, start_step)
            finally:
                self._log = None

    def _run(self, model, opt_state, num_steps: int, start_step: int
             ) -> tuple[Any, Any, dict]:
        device = self.step_fn.device
        step = start_step
        if self.ckpt is not None and self.ckpt.latest() is not None:
            step = self._restore(model, opt_state)
            self._event("restore", step=step)
            self.printer(f"[trainer] restored checkpoint at step {step}")
        self._account_static(model, opt_state)
        losses: list[float] = []
        consec_slow = 0
        retries_used = 0
        while step < num_steps:
            batch = self.pipeline.batch_at(step)
            tokens = batch["tokens"].numel() if "tokens" in batch else 0
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            try:
                # injected faults fire at the top of the attempt, after
                # t0: a straggler's sleep counts in its time
                if self.fault_injector is not None:
                    self.fault_injector(step)
                if step in self.fail_at:
                    self.fail_at.discard(step)
                    raise SimulatedFailure(f"injected node loss @ {step}")
                model, opt_state, metrics = self.step_fn.fn(
                    model, opt_state, batch, step)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                retries_used = 0
            except TransientStepError as e:
                # rung 1: the step committed nothing; retry it in place
                retries_used += 1
                if retries_used <= self.step_retries:
                    self._event("retry", step=step, attempt=retries_used)
                    self.printer(f"[trainer] transient fault @ {step} ({e}); "
                                 f"retry {retries_used}/{self.step_retries}")
                    continue
                retries_used = 0
                self._event("retry_exhausted", step=step)
                self.printer(f"[trainer] {e}; retries exhausted — recovering "
                             f"from checkpoint")
                recovered = self._recover(model, opt_state)
                if recovered is None:
                    self.printer("[trainer] no checkpoint; restart from 0")
                    step = start_step
                    continue
                step = recovered
                continue
            except RankLost as e:
                # rung 3 is outside the loop: this mesh is gone; hand the
                # last committed state to the supervisor
                e.step = step
                e.params, e.opt_state = model, opt_state
                self._event("rank_lost", step=step)
                self.printer(f"[trainer] {e}; surrendering to supervisor")
                raise
            except SimulatedFailure as e:
                self._event("failure", step=step)
                self.printer(f"[trainer] {e}; recovering from checkpoint")
                recovered = self._recover(model, opt_state)
                if recovered is None:
                    self.printer("[trainer] no checkpoint; restart from 0")
                    step = start_step
                    continue
                step = recovered
                continue
            dt = self._step_time(time.perf_counter() - t0)
            if self.first_step_time is None:
                self.first_step_time = dt
                self.metrics.gauge("compile_time_s").set(dt)
                self._event("compile", step=step, dt=dt)
            else:
                if len(self.step_times) >= 5:
                    med = statistics.median(self.step_times[-50:])
                    if dt > self.straggler_factor * med:
                        consec_slow += 1
                        self._event("straggler", step=step, dt=dt, median=med)
                        if consec_slow >= self.straggler_patience:
                            decision = (self.remesh_hook(step)
                                        if self.remesh_hook else None)
                            self._event("remesh_requested", step=step,
                                        decision=decision or "log-only")
                            self.printer(
                                f"[trainer] {consec_slow} consecutive straggler "
                                f"steps — requesting re-shard / hot-spare swap "
                                f"({decision or 'log-only'})")
                            consec_slow = 0
                            if decision == "shrink":
                                # the committed post-step state; resume at step + 1
                                e = RemeshRequest(f"straggler shrink @ {step}")
                                e.step = step + 1
                                e.params, e.opt_state = model, opt_state
                                raise e
                    else:
                        consec_slow = 0
                self.step_times.append(dt)
                self.metrics.histogram("step_time_s").observe(dt)
                if tokens:
                    self.metrics.counter("tokens_total").inc(tokens)
                    self.metrics.gauge("tokens_per_s").set(tokens / dt)
            loss = float(metrics["loss"])
            gnorm = float(metrics.get("grad_norm", 0.0))
            losses.append(loss)
            self.metrics.counter("steps_total").inc()
            self.metrics.gauge("loss").set(loss)
            self.metrics.gauge("grad_norm").set(gnorm)
            self._log.emit(
                "step", step=step, loss=loss, dt=dt, grad_norm=gnorm,
                tokens=tokens, compile_step=self.first_step_time == dt)
            if step % self.log_every == 0:
                self.printer(f"[trainer] step {step} loss {loss:.4f} "
                             f"({dt * 1e3:.1f} ms)")
                recent = self.step_times[-50:]
                self.printer(heartbeat_line(
                    step, loss=loss, step_ms=dt * 1e3,
                    avg_ms=sum(recent) / len(recent) * 1e3 if recent else None,
                    tokens_per_s=tokens / dt if tokens else None,
                    grad_norm=gnorm, compile_s=self.first_step_time))
            step += 1
            if self.ckpt is not None:
                self.ckpt.maybe_save(step, {"params": model.params_tree(),
                                            "opt": opt_state})
        if self.ckpt is not None:
            self.ckpt.wait()
        return model, opt_state, {
            "losses": losses,
            "step_times": list(self.step_times),
            "compile_time": self.first_step_time,
            "events": self.events,
            "metrics": self.metrics.snapshot(),
        }


def copy_into(live: Any, restored: Any) -> None:
    """Write a restored tree into the live one's tensors, leaf by leaf
    (``copy_``; same names, shapes; the dtype and device are the live
    tensor's), rebinding none: the step and its syncers hold references
    to the parameters and the optimizer state."""
    got = dict(flatten_with_names(restored)[0])
    with torch.no_grad():
        for n, t in flatten_with_names(live)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            v = got[n]
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{n}: restored {tuple(v.shape)} != live {tuple(t.shape)}")
            t.copy_(v)

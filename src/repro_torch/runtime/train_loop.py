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

Each stage runs under a profiler label (``step.gather_pending``,
``step.forward``, ``step.backward``, ``step.gradsync``,
``step.depcha_wait``, ``step.optimizer``, ``step.loss_allreduce``;
GradSync's ops nest as ``comm.<kind>...``), so a ``torch.profiler``
trace splits the step by layer.
"""
from __future__ import annotations

import dataclasses
import math
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
from repro_torch.parallel.sharding import MODEL_AXIS, dp_axes_of, dp_index, flat_spec_axes
from repro_torch.utils.trees import flatten_with_names, tree_leaves, tree_unflatten

ZERO1_PLANS = ("scheduled", "deferred", "monolithic")


@dataclasses.dataclass
class TrainStep:
    fn: Callable[..., Any]   # (model, opt_state, batch, step) -> (model, opt_state, metrics)
    gradsync: GradSync
    device: torch.device
    layer_sync: Any = None   # core.overlap.LayerSync under depcha in-scan, else None
    opt_init: Callable[[], Any] | None = None
    # deferred zero1 only: (model, opt_state) -> model, applying the carried
    # update shards (what the next step's top would) and zeroing the carry
    finalize: Callable[..., Any] | None = None

    def init_opt(self) -> Any:
        """Zero-initialized optimizer state: under ZeRO-1 sharded, sized
        from the dp plan (scheduled, deferred) or the local params
        (monolithic); else the optimizer's ``init`` of the params."""
        return self.opt_init()


def split_microbatches(batch: dict, microbatch: int) -> list[dict]:
    """The reference's ``split``: every batch tensor cut into
    ``microbatch`` equal slices along dim 0; a scalar repeated, except
    ``global_tokens``, which becomes its 1/M share (so each microbatch's
    loss is its share of the batch mean)."""
    mbs: list[dict] = [{} for _ in range(microbatch)]
    for k, x in batch.items():
        if x.dim() == 0:
            x = x / microbatch if k == "global_tokens" else x
            for mb in mbs:
                mb[k] = x
            continue
        if x.shape[0] % microbatch:
            raise ValueError(f"batch {k!r} of {x.shape[0]} rows does not split "
                             f"into {microbatch} microbatches")
        for mb, part in zip(mbs, x.reshape(microbatch, x.shape[0] // microbatch,
                                           *x.shape[1:]).unbind(0)):
            mb[k] = part
    return mbs


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
    ported.
    """
    if pp_stages != 1:
        raise NotImplementedError("pipeline stages: ROADMAP queue 1 item 13")
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
    if zero1_mode:
        inner, z_dp_size, _ = zmeta
        if z_dp_size != dp_size:
            raise ValueError(f"optimizer sharded {z_dp_size} ways on a dp mesh of {dp_size}")
        sync = dataclasses.replace(sync, exclude_axes=tuple(dp))
    if zero1_scheduled:
        sync = dataclasses.replace(
            sync, zero1_dp_axes=tuple(dp), zero1_clip=bool(clip_norm),
            zero1_defer_ag=defer_ag)
    layer_sync = None
    if in_scan:
        layer_sync = api.layer_sync(cfg, params_like, mesh, device) if api.layer_sync else None
        if layer_sync is None or set(layer_sync.names) != set(in_scan):
            raise ValueError(f"{api.family}: the in-backward sync does not cover "
                             f"the in-scan leaves")
    specs = api.param_specs(params_like, cfg)
    gs = GradSync(sync, mesh, specs, params_like, in_scan_names=in_scan, device=device)
    # the loss is summed over the dp axes (None: a dp group of one)
    loss_group = coset_groups([dp], mesh, device)[reduce_key(dp, mesh)]
    rank = dp_index(dist.get_rank(), mesh)
    fwd_kw = {"layer_sync": layer_sync} if layer_sync is not None else {}
    if tp > 1:
        fwd_kw["model_axis"] = model_axis(mesh, device)
    if fsdp:
        fwd_kw["fsdp"] = fsdp_axes(mesh, tuple(cfg.dp_axes), device)
    # the clip's squares: each sharded leaf's summed over its spec's axes
    shard_sets = {n: key for n, sp in flatten_with_names(specs)[0]
                  if (key := reduce_key(flat_spec_axes(sp), mesh))}
    clip_kw = {}
    if shard_sets and clip_norm and not zero1_mode:
        clip_kw = dict(shard_sets=shard_sets, comms=dep.mesh_comms(
            [0], set(shard_sets.values()), mesh, device)[0])

    def init_opt():
        if zero1_scheduled:
            state = zero1_state(inner, gs.dp_plan, dp_size, device)
            if defer_ag:
                state["pending"] = zero1_pending(gs.dp_plan, dp_size, device)
            return state
        named = flatten_with_names(model.params_tree())[0]
        return optimizer.init({n: p.detach() for n, p in named})

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

    def step(model, opt_state, batch, step_idx: int):
        model.zero_grad(set_to_none=True)
        tree = model.params_tree()
        named, treedef = flatten_with_names(tree)
        params = {n: p.data for n, p in named}
        if defer_ag:
            with record_function("step.gather_pending"):
                # last step's deferred updates land before the forward
                gather_pending(model, opt_state.pop("pending"))
        if microbatch == 1:
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
                     finalize if defer_ag else None)


class Trainer:
    """Training driver: runs the step over the pipeline's batches, times
    each step and keeps the losses, with the reference's ``repro.obs``
    accounting (``repro/runtime/train_loop.py::Trainer``).

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
    a step.  Each logged step prints the trainer line and the heartbeat.

    Under ZeRO-1 ``mem.state_bytes`` counts the rank's sharded optimizer
    state (and, deferred, the carried update shards).

    Not here: the reference's simulator gauges (``sim.step_time_s``,
    ``sim.exposed_comm_s``; ROADMAP queue 1 item 15b), and its
    checkpoint, retry, straggler and fault-injection rungs with their
    events (items 10 and 14), among them the check that a deferred run
    resumes from a checkpoint holding its carry (``_guard_pending``,
    item 10)."""

    def __init__(self, step_fn: TrainStep, pipeline, *, log_every: int = 10,
                 printer: Callable[[str], None] = print,
                 metrics: MetricsRegistry | None = None,
                 events_path: str | IO[str] | None = None):
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.log_every = log_every
        self.printer = printer
        self.step_times: list[float] = []
        self.first_step_time: float | None = None
        self.events: list[dict] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events_path = events_path

    def _account_static(self, model, opt_state) -> None:
        """The per-run gauges and counters: resident state bytes and one
        execution of the planned schedule's comm bytes."""
        leaves = list(model.parameters()) + [
            t for t in tree_leaves(opt_state) if isinstance(t, torch.Tensor)]
        self.metrics.gauge("mem.state_bytes").set(
            sum(t.numel() * t.element_size() for t in leaves))
        gs = self.step_fn.gradsync
        comm_byte_counters(gs.schedule, self.metrics,
                           itemsize=gs.cfg.comm_dtype.itemsize)

    def run(self, model, opt_state, num_steps: int, start_step: int = 0
            ) -> tuple[Any, Any, dict]:
        with EventLog(self.events_path) as event_log:
            return self._run(model, opt_state, num_steps, start_step, event_log)

    def _run(self, model, opt_state, num_steps: int, start_step: int,
             event_log: EventLog) -> tuple[Any, Any, dict]:
        device = self.step_fn.device
        self._account_static(model, opt_state)
        losses: list[float] = []
        for step in range(start_step, num_steps):
            batch = self.pipeline.batch_at(step)
            tokens = batch["tokens"].numel() if "tokens" in batch else 0
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            model, opt_state, metrics = self.step_fn.fn(
                model, opt_state, batch, step)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if self.first_step_time is None:
                self.first_step_time = dt
                self.metrics.gauge("compile_time_s").set(dt)
                self.events.append({"kind": "compile", "step": step, "dt": dt})
                event_log.emit("compile", step=step, dt=dt)
            else:
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
            event_log.emit(
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
        return model, opt_state, {
            "losses": losses,
            "step_times": list(self.step_times),
            "compile_time": self.first_step_time,
            "events": self.events,
            "metrics": self.metrics.snapshot(),
        }

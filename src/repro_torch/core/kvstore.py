"""GradSync facade + the paper's KVStore API, both on the CommSchedule IR
— the port of ``repro/core/kvstore.py``.

``GradSync`` is the production entry point: built once per train setup
from the gradient tree and param specs, it plans the configured
strategy's ``CommSchedule`` once (``plan_sync``: bucket plan, reducer,
schedule and the six ``repro_torch.analysis`` passes, no process group
needed; inspectable as ``.schedule``), creates per chain a communicator
for each set of mesh axes its buckets reduce over
(``dependency.mesh_comms``: under tensor parallelism ("data",) for the
model-sharded leaves, ("data", "model") for the replicated ones) and one
staging stream, and executes the schedule over each step's gradients via
``repro_torch.core.schedule.execute``.  With a hierarchical reducer on a
mesh with a pod axis each chain also gets its intra- and inter-pod
sub-communicators (``dependency.pod_comms``) and, for
``hierarchical_ring`` on CUDA, its intra-pod ``PeerRing``.

``KVStore`` reproduces the paper's python API (Figs 3, 5, 8, 10): "push"
copies a gradient into its comm buffer and issues (or, for depcha,
stages) its collective, "pull" waits for the reduced value.  Both paths
issue every collective through the same ``emit_gated`` emitter, and
KVStore records the ops it issues as the same ``CollectiveOp`` IR
(``.schedule()``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import dependency as dep
from repro_torch.core.buckets import Bucket, BucketPlan, LeafInfo, make_bucket_plan
from repro_torch.core.registry import StrategyInfo, get_strategy
from repro_torch.core.schedule import (
    ALL_GATHER,
    ALLREDUCE,
    REDUCE_SCATTER,
    REGROUP,
    CollectiveOp,
    CommSchedule,
    emit_gated,
    execute,
    group_size,
)
from repro_torch.core.strategies import make_reducer
from repro_torch.kernels.collectives.kernel import PeerRing
from repro_torch.parallel.sharding import Mesh, flat_spec_axes
from repro_torch.utils.trees import flatten_with_names, tree_unflatten


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """The reference's sync knobs: the strategies and reducers, the
    ZeRO-1 StepProgram (``zero1_*``), and what a meta strategy's planning
    (``auto``, ``repro_torch.sim``) reads besides: the step's compute
    model (``sim_compute``), the accumulation context (``zero1_accum*``)
    and the pipeline context (``pp_*``), which the train step fills."""

    strategy: str = "depcha"         # any registered strategy name
    reducer: str = "flat"            # any registered reducer name
    bucket_bytes: int = 4 * 1024 * 1024
    num_channels: int = 4            # ConCom communicator count
    comm_dtype: Any = torch.float32
    mean_axes: tuple[str, ...] = ()  # axes whose sum becomes a mean
    exclude_axes: tuple[str, ...] = ()  # reduced elsewhere
    use_fused_staging: bool = True   # fused pack/unpack kernels
    loss_scale: float = 1.0          # folded into pack; unpack divides
    # StepProgram: non-empty → plan the ZeRO-1 step as per-bucket
    # RS→UPDATE→AG ops over these axes, appended to the sync schedule
    # (set exclude_axes to the same axes — the RS *is* their reduction)
    zero1_dp_axes: tuple[str, ...] = ()
    zero1_clip: bool = False         # plan the NORM op (grad clipping)
    # pipelined StepProgram: tag the zero1 all-gathers PRE so they run at
    # the NEXT step's top (``GradSync.apply_pending``, with the carried
    # update shards) instead of closing this step
    zero1_defer_ag: bool = False
    # gradient accumulation context for ``auto``'s ZeRO-1 ranking: the
    # microbatch count M and whether releases ride the final microbatch's
    # backward (``make_train_step`` sets False: the port's sync starts
    # after the last backward)
    zero1_accum: int = 1
    zero1_accum_overlap: bool = True
    # the PER-MICROBATCH ``repro_torch.sim.compute.ComputeModel`` a meta
    # strategy ranks with (None: communication alone)
    sim_compute: Any = None
    # pipeline context (DESIGN.md §15), set by ``make_train_step`` with
    # pipeline stages: stages, the resolved schedule, the microbatch
    # count M and the stage-boundary payload a hop, in bytes
    pp_stages: int = 1
    pp_schedule: str = "auto"        # "auto" | "gpipe" | "1f1b"
    pp_microbatches: int = 0         # 0 → derived (accum, else 2·stages)
    pp_activation_bytes: int = 0
    # static analysis: validate() and the six repro_torch.analysis passes
    # over the planned schedule, raising ScheduleError (with a printable
    # witness) before any communicator sees it
    verify: bool = True


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """Everything ``GradSync`` plans before it touches a process group."""

    info: StrategyInfo
    mesh_shape: dict[str, int]
    plan: BucketPlan
    reducer: Any                     # (buf, bucket, communicator) -> Handle
    skip_names: frozenset[str]
    schedule: CommSchedule           # the StepProgram's, under zero1_dp_axes
    program: Any = None              # core.stepprogram.StepProgram, or None


def plan_sync(cfg: GradSyncConfig, mesh, param_specs: Any, grads_like: Any, *,
              in_scan_names: frozenset[str] = frozenset()) -> SyncPlan:
    """Plan ``cfg``'s strategy over ``grads_like`` on ``mesh`` (anything
    with a ``shape`` dict and ``axis_names``: a stand-in mesh will do) and,
    under ``cfg.verify``, verify the schedule as the reference's
    ``GradSync`` does.  Needs no process group.  A meta strategy
    (``auto``) gets the reference's planning ``context``: the mesh, the
    reducer, the comm itemsize, the staging mode, ``sim_compute``, the
    pipeline context and, under ZeRO-1, the dp axes, clip, defer and
    accumulation.  Raises ``ValueError`` for a strategy/reducer pair the
    constructor contract refuses and ``ScheduleError`` for a schedule
    that fails a pass."""
    info = get_strategy(cfg.strategy)  # fail fast
    if info.two_phase and cfg.reducer not in ("flat", "ring"):
        raise ValueError(
            f"strategy {cfg.strategy!r} emits raw reduce-scatter/"
            f"all-gather ops and would silently ignore "
            f"reducer={cfg.reducer!r}; use reducer='flat'/'ring' or "
            f"a non-two-phase strategy")
    mesh_shape = dict(mesh.shape)
    plan = make_bucket_plan(
        grads_like, param_specs, mesh,
        bucket_bytes=cfg.bucket_bytes,
        num_channels=1 if info.single_chain else cfg.num_channels,
        comm_dtype=cfg.comm_dtype,
        exclude_axes=cfg.exclude_axes)
    reducer = make_reducer(cfg.reducer, mesh_shape, mean_axes=cfg.mean_axes)
    # leaves whose sum already happened inside the backward scan
    skip_names = in_scan_names if info.uses_in_scan else frozenset()
    # meta strategies (auto) plan by simulating candidates: hand them the
    # real topology so the cost model is calibrated
    plan_kw: dict[str, Any] = {}
    if info.meta:
        plan_kw["context"] = {
            "mesh_shape": mesh_shape,
            "reducer": cfg.reducer,
            "itemsize": cfg.comm_dtype.itemsize,
            "fused_staging": cfg.use_fused_staging,
            "compute": cfg.sim_compute,
        }
        if cfg.pp_stages > 1:
            plan_kw["context"]["pp"] = {
                "stages": cfg.pp_stages,
                "schedule": cfg.pp_schedule,
                "microbatches": cfg.pp_microbatches,
                "activation_bytes": cfg.pp_activation_bytes,
            }
    # the strategy's dependency structure, planned once, inspectable
    schedule = info.plan(plan, skip_names=skip_names, **plan_kw)
    # StepProgram: the ZeRO-1 RS→UPDATE→AG triples, planned by the SAME
    # strategy over the dp-axes bucket plan, appended to the sync ops
    program = None
    if cfg.zero1_dp_axes:
        from repro_torch.core.stepprogram import build_step_program, zero1_bucket_plan

        id_offset = (max(b.bucket_id for b in plan.buckets) + 1
                     if plan.buckets else 0)
        dp_plan = zero1_bucket_plan(
            grads_like, param_specs, mesh, dp_axes=tuple(cfg.zero1_dp_axes),
            bucket_bytes=cfg.bucket_bytes,
            num_channels=1 if info.single_chain else cfg.num_channels,
            id_offset=id_offset)
        dp_size = group_size(cfg.zero1_dp_axes, mesh_shape)
        plan_kw2 = {}
        if info.meta:
            plan_kw2["context"] = {
                **plan_kw["context"],
                "zero1": {"dp_axes": tuple(cfg.zero1_dp_axes),
                          "dp_size": dp_size,
                          "clip": cfg.zero1_clip,
                          "defer": cfg.zero1_defer_ag,
                          "accum": cfg.zero1_accum,
                          "accum_overlap": cfg.zero1_accum_overlap},
            }
        base = info.plan(dp_plan, skip_names=frozenset(), **plan_kw2)
        program = build_step_program(
            schedule, plan, base, dp_plan, dp_axes=tuple(cfg.zero1_dp_axes),
            dp_size=dp_size,
            clip=cfg.zero1_clip, defer_ag=cfg.zero1_defer_ag)
        schedule = program.schedule
    if cfg.verify:
        from repro_torch.analysis import verify_schedule

        schedule.validate()
        verify_schedule(schedule, mesh_shape=mesh_shape,
                        default_reducer=cfg.reducer,
                        plan_comm_dtype=cfg.comm_dtype,
                        expect_defer=program is not None and program.defer_ag)
    return SyncPlan(info, mesh_shape, plan, reducer, skip_names, schedule, program)


class GradSync:
    """Configured gradient synchronizer (the KVStore.create analogue).

    Construction is collective: every rank builds the same plan and
    creates the same per-chain communicators, in the same order.
    """

    def __init__(
        self,
        cfg: GradSyncConfig,
        mesh,
        param_specs: Any,
        grads_like: Any,
        *,
        in_scan_names: frozenset[str] = frozenset(),
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.device = dep.resolve_device(device)
        planned = plan_sync(cfg, mesh, param_specs, grads_like,
                            in_scan_names=in_scan_names)
        self.info: StrategyInfo = planned.info
        self.mesh_shape = planned.mesh_shape
        self.plan: BucketPlan = planned.plan
        self.reducer = planned.reducer
        self.skip_names = planned.skip_names
        self.schedule: CommSchedule = planned.schedule
        self.program = planned.program
        self.dp_plan = planned.program.dp_plan if planned.program is not None else None

        chains = [op.chain for op in self.schedule.ops]
        # one communicator a reduce set, on every chain (the model axis's
        # for the NORM's sum over it; each axis's for a ring over several)
        sets = set(self.schedule.axes_used())
        specs = dict(flatten_with_names(param_specs)[0])
        # each leaf's spec axes: gathering a leaf's global view (a
        # checkpoint's, ``repro_torch.checkpoint``) runs on them
        sets |= {dep.reduce_key(flat_spec_axes(spec), mesh) for spec in specs.values()}
        self.model_sharded = frozenset()
        if self.mesh_shape.get("model", 1) > 1:
            sets.add(("model",))
            self.model_sharded = frozenset(
                n for n, spec in specs.items() if "model" in flat_spec_axes(spec))
        hier = cfg.reducer.startswith("hierarchical") and "pod" in self.mesh_shape
        if hier:
            sets |= {tuple(a for a in ax if a not in ("pod", "data")) for ax in list(sets)}
        if cfg.reducer == "ring" or cfg.reducer.endswith("_ring"):
            sets |= {(a,) for ax in list(sets) for a in ax}
        with dep.comm_scope() as self._made:     # what ``close`` destroys
            self.groups = dep.mesh_comms(chains, sets, mesh, self.device)
            pods = (dep.pod_comms(self.groups, self.mesh_shape["pod"],
                                  self.mesh_shape["data"], self.device,
                                  self.mesh_shape.get("model", 1),
                                  ranks=getattr(mesh, "world_ranks", None))
                    if hier else {})
        self.streams = dep.ChainStreams(chains, self.device)
        self.rings: list[PeerRing] = []
        if hier:
            for c, comms in self.groups.items():
                comms.pod = pods[c]
            if (cfg.reducer == "hierarchical_ring" and self.device.type == "cuda"
                    and self.mesh_shape["data"] > 1):
                slot = self._chunk_bytes(self.mesh_shape["data"])
                for c, comms in sorted(self.groups.items()):
                    comms.pod.ring = PeerRing(comms.pod.intra, slot, chain=c)
                    self.rings.append(comms.pod.ring)

    def _chunk_bytes(self, g: int) -> int:
        """The largest intra-pod chunk of the schedule, in bytes: a peer
        ring's message slot."""
        def itemsize(bucket):
            dt = bucket.comm_dtype if bucket.comm_dtype is not None else self.plan.comm_dtype
            return dt.itemsize
        return max(-(-op.bucket.size // g) * itemsize(op.bucket)
                   for op in self.schedule.ops)

    def close(self) -> None:
        """Collective: free the peer rings' buffers, then destroy the
        chains' communicators (and their pods'), in creation order.  The
        syncer runs no schedule after it."""
        rings, self.rings = self.rings, []
        for ring in rings:
            ring.close()
        dep.destroy_groups(self._made)
        self.groups = {}

    def _two_phase_impl(self) -> str:
        """The reduce-scatter/all-gather transport: ring-family reducers
        carry the RS/AG ops of two-phase strategies, and the zero1
        triples, on the rings."""
        ring_family = (self.cfg.reducer == "ring"
                       or self.cfg.reducer.endswith("_ring"))
        emits_rs_ag = self.info.two_phase or self.program is not None
        return "ring" if ring_family and emits_rs_ag else "psum"

    def _execute(self, schedule: CommSchedule, tree: Any, **kw) -> Any:
        out = execute(
            schedule, tree, self.plan,
            reducer=self.reducer,
            groups=self.groups,
            streams=self.streams,
            mesh_shape=self.mesh_shape,
            mean_axes=self.cfg.mean_axes,
            use_fused_staging=self.cfg.use_fused_staging,
            two_phase_impl=self._two_phase_impl(),
            model_sharded=self.model_sharded, **kw)
        # a peer ring's wait that ran out voids the step: no result returned
        for ring in self.rings:
            ring.check()
        return out

    def __call__(self, grads: Any, *, update_fn=None, clip_norm: float = 0.0,
                 aux: dict | None = None,
                 schedule: CommSchedule | None = None) -> Any:
        """Execute the planned schedule over ``grads``.

        For a sync schedule this returns the reduced gradients (written
        into ``grads`` in place on the fused staging path).  A StepProgram
        (``zero1_dp_axes``) also needs ``update_fn`` (see
        ``repro_torch.optim.zero.scheduled_update``); the returned tree
        then holds the gathered f32 *updates*, and ``aux`` gets
        ``grad_norm`` (with ``zero1_clip``) and ``update_shards``.
        ``schedule`` overrides the planned one: the deferred step passes
        ``program.post_schedule()`` and gathers last step's shards with
        ``apply_pending``."""
        return self._execute(
            self.schedule if schedule is None else schedule, grads,
            loss_scale=self.cfg.loss_scale, update_fn=update_fn,
            clip_norm=clip_norm, aux=aux)

    def apply_pending(self, pending: dict[int, torch.Tensor],
                      updates_like: Any = None) -> Any:
        """Run the deferred PRE program: all-gather the update shards
        carried from the previous step (``pending``: bucket_id → local
        shard) into ``updates_like`` (a tree shaped like the params; by
        default all None, and each leaf becomes a new f32 tensor).  The
        gathers free-fly."""
        if self.program is None or not self.program.defer_ag:
            raise ValueError(
                "apply_pending requires a StepProgram planned with "
                "zero1_defer_ag=True")
        if updates_like is None:
            updates_like = tree_unflatten(self.plan.treedef,
                                          [None] * self.plan.num_leaves)
        return self._execute(self.program.pre_schedule(), updates_like,
                             pending=pending)


class KVStore:
    """Paper API: create / init / push / pull / barrier / regroup  (Figs 3,
    5, 8, 10; the regroup is the MXNET-MPI companion paper's).

    Any registered strategy name is a valid ``kind``; semantics derive
    from the strategy's registry metadata, not name strings:
      funnel   (single_chain)  — pushes reduce immediately on ONE chain.
      concom / priority        — key hashed to ``num_channels`` chains.
      depcha   (deferred_pull) — push only stages the buffer; pull
               performs the chained allreduce (paper Fig 10).
      rsag     (two_phase)     — push issues the reduce-scatter, pull the
               all-gather.

    Each channel is its own communicator over the ranks of
    ``reduce_axes`` (with ``mesh_shape``, the ranks that share this
    rank's coordinates on the other axes; else every rank).  Every op
    issued is recorded as CommSchedule IR — ``.schedule()``.
    """

    def __init__(self, kind: str, *, reduce_axes: tuple[str, ...],
                 num_channels: int = 4,
                 mesh_shape: dict[str, int] | None = None,
                 device: str | torch.device = "cuda"):
        self.info = get_strategy(kind)
        self.kind = kind
        self.reduce_axes = tuple(reduce_axes)
        self.num_channels = 1 if self.info.single_chain else num_channels
        self.mesh_shape = mesh_shape
        self.device = dep.resolve_device(device)
        self._made: list = []             # every grouping's communicators: ``close``
        self._groups = self._make_groups()
        self._regroups = 0
        self._handles: dict[int, dep.Handle] = {}
        self._staged: dict[int, torch.Tensor] = {}
        self._reduced: dict[int, tuple[dep.Handle, int]] = {}
        self._shards: dict[int, tuple[dep.Handle, int]] = {}
        self._shapes: dict[int, tuple[int, ...]] = {}
        self._ops: list[CollectiveOp] = []
        self._last_op: dict[int, int] = {}   # channel -> last op_id
        self._rs_ops: dict[int, int] = {}    # key -> its RS op_id
        self._barrier_join: tuple[int, ...] = ()  # chain tails at barrier()

    def _make_groups(self) -> dict[int, dist.ProcessGroup | None]:
        """A communicator a channel over ``reduce_axes`` (collective)."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.mesh_shape is not None:
            mesh = Mesh(tuple(self.mesh_shape), dict(self.mesh_shape))
            axes = self.reduce_axes
        else:
            # without a mesh every channel spans every rank: one data axis
            mesh, axes = Mesh(("data",), {"data": world}), ("data",)
        if group_size(axes, mesh.shape) == 1 < world:
            raise ValueError(f"a KVStore over {self.reduce_axes} of {self.mesh_shape} "
                             f"would reduce over one rank of {world}")
        with dep.comm_scope() as made:
            comms = dep.mesh_comms(range(self.num_channels), [axes], mesh, self.device)
        self._made += made
        return {c: cc.get(axes) for c, cc in comms.items()}

    def close(self) -> None:
        """Collective: destroy every communicator the store created (its
        channels', and those of earlier groupings), in creation order."""
        dep.destroy_groups(self._made)
        self._groups = {}

    @classmethod
    def create(cls, kind: str, **kw) -> "KVStore":
        return cls(kind, **kw)

    def _chan(self, key: int) -> int:
        return key % self.num_channels

    def init(self, key: int, value: torch.Tensor) -> torch.Tensor:
        """Paper Fig 4: broadcast the initial value from rank 0.  Non-root
        ranks contribute zeros to a sum, so every rank receives rank 0's
        value bit-exactly; the collective rides the key's channel."""
        if not self.reduce_axes:
            return value
        self._shapes[key] = tuple(value.shape)
        root = dist.get_rank(self._groups[self._chan(key)]) == 0
        masked = (value.reshape(-1).clone() if root
                  else torch.zeros(value.numel(), dtype=value.dtype,
                                   device=value.device))
        return self._emit(key, masked, ALLREDUCE).wait().reshape(value.shape)

    def _bucket(self, key: int, buf: torch.Tensor) -> Bucket:
        leaf = LeafInfo(name=str(key), index=key, shape=self._shapes[key],
                        dtype=buf.dtype, size=buf.numel())
        return Bucket(leaves=(leaf,), reduce_axes=self.reduce_axes,
                      channel=self._chan(key), bucket_id=key)

    def _record(self, key: int, buf: torch.Tensor, kind: str,
                extra_deps: tuple[int, ...] = ()) -> CollectiveOp:
        c = self._chan(key)
        deps = tuple(extra_deps)
        if c in self._last_op:
            if self._last_op[c] not in deps:
                deps = (self._last_op[c],) + deps
        elif self._barrier_join:
            # first op on this channel after a barrier(): gated on every
            # pre-barrier chain tail
            deps = tuple(d for d in self._barrier_join
                         if d not in deps) + deps
        op = CollectiveOp(op_id=len(self._ops), bucket=self._bucket(key, buf),
                          chain=c, depends_on=deps, kind=kind)
        self._ops.append(op)
        self._last_op[c] = op.op_id
        return op

    def _emit(self, key: int, buf: torch.Tensor, kind: str,
              extra_deps: tuple[int, ...] = ()) -> dep.Handle:
        """Record the op in the IR and issue it through THE emitter."""
        op = self._record(key, buf, kind, extra_deps)
        if kind == REDUCE_SCATTER:
            self._rs_ops[key] = op.op_id
        group = self._groups[self._chan(key)]
        g = dist.get_world_size(group)

        def issue(b: torch.Tensor) -> dep.Handle:
            if kind == ALLREDUCE:                            # MPI_Allreduce
                return dep.Handle(dep.collective(dist.all_reduce, group, b), b)
            if kind == REDUCE_SCATTER:
                out = torch.empty(b.numel() // g, dtype=b.dtype, device=b.device)
                return dep.Handle(dep.collective(
                    dist.reduce_scatter_tensor, group, out, b), out)
            if kind == ALL_GATHER:
                out = torch.empty(b.numel() * g, dtype=b.dtype, device=b.device)
                return dep.Handle(dep.collective(
                    dist.all_gather_into_tensor, group, out, b), out)
            raise ValueError(kind)

        h = emit_gated(buf, op.depends_on, self._handles, issue)
        self._handles[op.op_id] = h
        return h

    def push(self, key: int, grad: torch.Tensor) -> None:
        self._shapes[key] = tuple(grad.shape)
        send_buf = grad.reshape(-1).clone()          # CopyFromTo → comm_buf
        if self.info.deferred_pull:
            self._staged[key] = send_buf             # decoupled: reduce at pull
            return
        n = send_buf.numel()
        if self.info.two_phase:
            g = dist.get_world_size(self._groups[self._chan(key)])
            if (-n) % g:
                send_buf = F.pad(send_buf, (0, (-n) % g))
            self._shards[key] = (self._emit(key, send_buf, REDUCE_SCATTER), n)
            return
        self._reduced[key] = (self._emit(key, send_buf, ALLREDUCE), n)

    def pull(self, key: int) -> torch.Tensor:
        if self.info.deferred_pull and key in self._staged:
            buf = self._staged.pop(key)
            self._reduced[key] = (self._emit(key, buf, ALLREDUCE), buf.numel())
        if self.info.two_phase and key in self._shards:
            shard, n = self._shards.pop(key)
            # the RS is an extra dep: gated before the gather reads it
            self._reduced[key] = (self._emit(
                key, shard.out, ALL_GATHER,
                extra_deps=(self._rs_ops[key],)), n)
        h, n = self._reduced[key]
        return h.wait()[:n].reshape(self._shapes[key])  # CopyFromTo(recv_buf, g)

    def barrier(self) -> None:
        """Paper Fig 8 line 13: join all outstanding chains — every
        channel's next op depends on every pre-barrier chain tail."""
        self._barrier_join = tuple(sorted(self._last_op.values()))
        self._last_op = {}

    def regroup(self, *, reduce_axes: tuple[str, ...] | None = None,
                mesh_shape: dict[str, int] | None = None) -> torch.Tensor:
        """MXNET-MPI group rebuild: dissolve the channels' communicators
        and re-form them over ``reduce_axes``/``mesh_shape``.

        Stronger than ``barrier()``: besides joining every outstanding
        chain, the OLD group runs one scalar all-reduce that every member
        must reach, recorded as a REGROUP op that depends on every chain
        tail; every later op's first emission on a channel depends on it.
        Then the new communicators are created (collective, as at
        construction).  Returns the barrier's scalar: the old group's
        size."""
        tails = tuple(sorted(self._last_op.values())) or self._barrier_join
        bucket = Bucket(
            leaves=(LeafInfo(name=f"__regroup{self._regroups}", index=0, shape=(),
                             dtype=torch.float32, size=1),),
            reduce_axes=self.reduce_axes, channel=0,
            bucket_id=1_000_000 + self._regroups)
        op = CollectiveOp(op_id=len(self._ops), bucket=bucket, chain=0,
                          depends_on=tails, kind=REGROUP)
        self._ops.append(op)
        self._regroups += 1
        group = self._groups[0]

        def psum(v: torch.Tensor) -> dep.Handle:
            if group is None:
                return dep.Handle(dep.Recorded(v.device), v)
            return dep.Handle(dep.collective(dist.all_reduce, group, v), v)

        one = torch.ones((), dtype=torch.float32, device=self.device)
        done = emit_gated(one, tails, self._handles, psum)
        self._handles[op.op_id] = done
        self._last_op = {}
        self._barrier_join = (op.op_id,)
        if reduce_axes is not None:
            self.reduce_axes = tuple(reduce_axes)
        if mesh_shape is not None:
            self.mesh_shape = mesh_shape
        out = done.wait()
        self._groups = self._make_groups()
        return out

    def schedule(self, verify: bool = True) -> CommSchedule:
        """The IR of every collective this store has issued so far.

        ``verify`` runs ``validate()`` and the six ``repro_torch.analysis``
        passes over it (rank simulation only when ``mesh_shape`` was
        given), raising ``ScheduleError`` on a finding; False skips both."""
        s = CommSchedule(tuple(self._ops))
        if verify:
            from repro_torch.analysis import verify_schedule

            s.validate()
            verify_schedule(s, mesh_shape=self.mesh_shape, expect_defer=False)
        return s

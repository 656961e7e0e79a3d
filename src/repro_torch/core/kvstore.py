"""GradSync facade + the paper's KVStore API, both on the CommSchedule IR
— the port of ``repro/core/kvstore.py``.

``GradSync`` is the production entry point: built once per train setup
from the gradient tree and param specs, it plans the configured
strategy's ``CommSchedule`` once (``plan_sync``: bucket plan, reducer,
schedule and the six ``repro_torch.analysis`` passes, no process group
needed; inspectable as ``.schedule``), creates one communicator and one
staging stream per chain, and executes the schedule over each step's
gradients via ``repro_torch.core.schedule.execute``.  With a hierarchical reducer on a
mesh with a pod axis each chain gets its intra- and inter-pod
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
    CollectiveOp,
    CommSchedule,
    emit_gated,
    execute,
    group_size,
)
from repro_torch.core.strategies import make_reducer
from repro_torch.kernels.collectives.kernel import PeerRing


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """The reference's sync knobs that the data-parallel slice runs.  The
    ZeRO-1 StepProgram, pipeline and simulator fields come with ROADMAP
    queue 1 items 8, 13 and 15b."""

    strategy: str = "depcha"         # any registered strategy name
    reducer: str = "flat"            # any registered reducer name
    bucket_bytes: int = 4 * 1024 * 1024
    num_channels: int = 4            # ConCom communicator count
    comm_dtype: Any = torch.float32
    mean_axes: tuple[str, ...] = ()  # axes whose sum becomes a mean
    exclude_axes: tuple[str, ...] = ()  # reduced elsewhere
    use_fused_staging: bool = True   # fused pack/unpack kernels
    loss_scale: float = 1.0          # folded into pack; unpack divides
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
    schedule: CommSchedule


def plan_sync(cfg: GradSyncConfig, mesh, param_specs: Any, grads_like: Any, *,
              in_scan_names: frozenset[str] = frozenset()) -> SyncPlan:
    """Plan ``cfg``'s strategy over ``grads_like`` on ``mesh`` (anything
    with a ``shape`` dict and ``axis_names``: a stand-in mesh will do) and,
    under ``cfg.verify``, verify the schedule as the reference's
    ``GradSync`` does.  Needs no process group.  Raises ``ValueError`` for
    a strategy/reducer pair the constructor contract refuses,
    ``NotImplementedError`` for a meta strategy and ``ScheduleError`` for a
    schedule that fails a pass."""
    info = get_strategy(cfg.strategy)  # fail fast
    if info.meta:
        raise NotImplementedError(
            f"meta strategy {cfg.strategy!r} plans by simulation: "
            f"ROADMAP queue 1 item 15b")
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
    # the strategy's dependency structure, planned once, inspectable
    schedule = info.plan(plan, skip_names=skip_names)
    if cfg.verify:
        from repro_torch.analysis import verify_schedule

        schedule.validate()
        verify_schedule(schedule, mesh_shape=mesh_shape,
                        default_reducer=cfg.reducer,
                        plan_comm_dtype=cfg.comm_dtype, expect_defer=False)
    return SyncPlan(info, mesh_shape, plan, reducer, skip_names, schedule)


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

        chains = [op.chain for op in self.schedule.ops]
        world = dist.get_world_size()
        for axes in self.schedule.axes_used():
            # a pod mesh's ("pod", "data", "model") buckets span the world too
            if group_size(axes, self.mesh_shape) != world:
                raise NotImplementedError(
                    f"buckets reducing over {axes} (a group of "
                    f"{group_size(axes, self.mesh_shape)} of {world} ranks) "
                    f"need sub-communicators: tensor parallelism, ROADMAP "
                    f"queue 1 item 9")
        self.groups = dep.chain_groups(chains, self.device)
        self.streams = dep.ChainStreams(chains, self.device)
        self.rings: list[PeerRing] = []
        if cfg.reducer.startswith("hierarchical") and "pod" in self.mesh_shape:
            self.groups = dep.pod_comms(self.groups, self.mesh_shape["pod"],
                                        self.mesh_shape["data"], self.device)
            if (cfg.reducer == "hierarchical_ring" and self.device.type == "cuda"
                    and self.mesh_shape["data"] > 1):
                slot = self._chunk_bytes(self.mesh_shape["data"])
                for c, comm in sorted(self.groups.items()):
                    comm.ring = PeerRing(comm.intra, slot, chain=c)
                    self.rings.append(comm.ring)

    def _chunk_bytes(self, g: int) -> int:
        """The largest intra-pod chunk of the schedule, in bytes: a peer
        ring's message slot."""
        def itemsize(bucket):
            dt = bucket.comm_dtype if bucket.comm_dtype is not None else self.plan.comm_dtype
            return dt.itemsize
        return max(-(-op.bucket.size // g) * itemsize(op.bucket)
                   for op in self.schedule.ops)

    def close(self) -> None:
        """Collective: free the peer rings' buffers (a no-op without them)."""
        rings, self.rings = self.rings, []
        for ring in rings:
            ring.close()

    def _two_phase_impl(self) -> str:
        """The reduce-scatter/all-gather transport: ring-family reducers
        carry the RS/AG ops of two-phase strategies on the rings."""
        ring_family = (self.cfg.reducer == "ring"
                       or self.cfg.reducer.endswith("_ring"))
        return "ring" if ring_family and self.info.two_phase else "psum"

    def __call__(self, grads: Any) -> Any:
        """Execute the planned schedule over ``grads``; returns the
        reduced gradients (written into ``grads`` in place on the fused
        staging path)."""
        out = execute(
            self.schedule, grads, self.plan,
            reducer=self.reducer,
            groups=self.groups,
            streams=self.streams,
            mesh_shape=self.mesh_shape,
            mean_axes=self.cfg.mean_axes,
            use_fused_staging=self.cfg.use_fused_staging,
            loss_scale=self.cfg.loss_scale,
            two_phase_impl=self._two_phase_impl())
        # a peer ring's wait that ran out voids the step: no result returned
        for ring in self.rings:
            ring.check()
        return out


class KVStore:
    """Paper API: create / init / push / pull / barrier  (Figs 3, 5, 8, 10).

    Any registered strategy name is a valid ``kind``; semantics derive
    from the strategy's registry metadata, not name strings:
      funnel   (single_chain)  — pushes reduce immediately on ONE chain.
      concom / priority        — key hashed to ``num_channels`` chains.
      depcha   (deferred_pull) — push only stages the buffer; pull
               performs the chained allreduce (paper Fig 10).
      rsag     (two_phase)     — push issues the reduce-scatter, pull the
               all-gather.

    Each channel is its own communicator over every rank.  Every op
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
        self._groups = dep.chain_groups(range(self.num_channels), self.device)
        if mesh_shape is not None and group_size(
                self.reduce_axes, mesh_shape) != dist.get_world_size():
            raise NotImplementedError(
                "a KVStore over a subset of ranks needs sub-communicators: "
                "ROADMAP queue 1 item 9")
        self._handles: dict[int, dep.Handle] = {}
        self._staged: dict[int, torch.Tensor] = {}
        self._reduced: dict[int, tuple[dep.Handle, int]] = {}
        self._shards: dict[int, tuple[dep.Handle, int]] = {}
        self._shapes: dict[int, tuple[int, ...]] = {}
        self._ops: list[CollectiveOp] = []
        self._last_op: dict[int, int] = {}   # channel -> last op_id
        self._rs_ops: dict[int, int] = {}    # key -> its RS op_id
        self._barrier_join: tuple[int, ...] = ()  # chain tails at barrier()

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

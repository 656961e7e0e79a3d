"""CommSchedule IR: the dependency structure handed to the scheduler, as
inspectable data — the port of ``repro/core/schedule.py``.

  ``CollectiveOp``  — one collective: a bucket, the chain it rides, the
                      ops it depends on, its kind and an optional
                      reducer tag.
  ``CommSchedule``  — a topologically ordered tuple of ops, with chain /
                      ordering accessors.
  ``execute``       — the ONE emitter: walks the ops and issues each as
                      an async collective on its chain's communicator,
                      after waiting on its dependencies
                      (``repro_torch.core.dependency``).

The IR half is the reference's unchanged, so planners here and in
``repro`` produce equal schedules.  The emitter runs the sync kinds
(ALLREDUCE, REDUCE_SCATTER, ALL_GATHER), the StepProgram's UPDATE and
NORM (``core/stepprogram.py``), the elastic RESHARD and REGROUP
(``repro_torch.elastic``), the pipeline's SEND and RECV
(``core/pipeline_program.py``) and the serving kind DECODE (a scheduling
point of ``repro_torch.sim.serve``'s decode plans).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import dependency as dep
from repro_torch.core.buckets import Bucket, BucketPlan, pack, unpack
from repro_torch.kernels.collectives import ops as coll_ops
from repro_torch.kernels.collectives import ref as coll_ref
from repro_torch.utils.trees import tree_leaves, tree_unflatten

# (buf, bucket, chain communicator) -> issued collective
Reducer = Callable[[torch.Tensor, Bucket, dist.ProcessGroup], dep.Handle]

# op kinds
ALLREDUCE = "allreduce"
REDUCE_SCATTER = "reduce_scatter"
ALL_GATHER = "all_gather"
UPDATE = "update"    # sharded optimizer update of one bucket's RS shard
NORM = "norm"        # scalar sum of local squared grad norms (clipping)
RESHARD = "reshard"  # elastic: move one state bucket across a mesh change
REGROUP = "regroup"  # elastic: the group-rebuild barrier
DECODE = "decode"    # serving: local decode math for one layer group
SEND = "send"        # pipeline: pack the boundary payload
RECV = "recv"        # pipeline: the hop, delivered into the leaves

KINDS = (ALLREDUCE, REDUCE_SCATTER, ALL_GATHER, UPDATE, NORM,
         RESHARD, REGROUP, DECODE, SEND, RECV)
# kinds that move a bucket's payload over the wire exactly once (RS/AG
# pairs are counted at the RS; SEND/RECV pairs at the SEND)
_WIRE_KINDS = (ALLREDUCE, REDUCE_SCATTER)
_PAYLOAD_KINDS = _WIRE_KINDS + (SEND,)

# execution phases: POST ops run after this step's backward; PRE ops are
# deferred to the top of the next step
POST = "post"
PRE = "pre"
PHASES = (POST, PRE)


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One staged collective in the schedule."""

    op_id: int
    bucket: Bucket
    chain: int                          # which dependency chain it rides
    depends_on: tuple[int, ...] = ()    # op_ids that must complete first
    kind: str = ALLREDUCE
    reducer: str = ""                   # registered reducer tag; "" = default
    phase: str = POST                   # POST (same step) | PRE (next step)
    shift: int = 1                      # SEND/RECV only: hop along the stage axis


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Topologically ordered collective ops (op i may only depend on j<i)."""

    ops: tuple[CollectiveOp, ...]

    def chains(self) -> dict[int, list[CollectiveOp]]:
        out: dict[int, list[CollectiveOp]] = {}
        for op in self.ops:
            out.setdefault(op.chain, []).append(op)
        return out

    @property
    def num_chains(self) -> int:
        return len({op.chain for op in self.ops})

    def chain_lengths(self) -> dict[int, int]:
        return {ch: len(ops) for ch, ops in self.chains().items()}

    def bucket_order(self, chain: int | None = None) -> tuple[int, ...]:
        """bucket_ids in emission order (optionally for one chain),
        counting each reduce-scatter/all-gather pair once (at the RS)."""
        return tuple(
            op.bucket.bucket_id for op in self.ops
            if op.kind in _WIRE_KINDS
            and (chain is None or op.chain == chain))

    def leaf_names(self) -> frozenset[str]:
        return frozenset(l.name for op in self.ops for l in op.bucket.leaves)

    def comm_bytes(self, itemsize: int = 4) -> int:
        """Total payload bytes moved (RS/AG pairs counted once)."""
        return sum(op.bucket.size * itemsize for op in self.ops
                   if op.kind in _PAYLOAD_KINDS)

    def chain_bytes(self, itemsize: int = 4) -> dict[int, int]:
        """Payload bytes per dependency chain."""
        out: dict[int, int] = {}
        for op in self.ops:
            if op.kind in _PAYLOAD_KINDS:
                out[op.chain] = out.get(op.chain, 0) + op.bucket.size * itemsize
        return out

    def axes_used(self) -> frozenset[tuple[str, ...]]:
        """Distinct reduction-axis groups (the communicators involved)."""
        return frozenset(op.bucket.reduce_axes for op in self.ops)

    def phase_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.ops:
            out[op.phase] = out.get(op.phase, 0) + 1
        return out

    def deferred_bytes(self, itemsize: int = 4) -> int:
        """Payload bytes whose materialization crosses the step boundary
        (the PRE ops' buckets)."""
        return sum(op.bucket.size * itemsize_of(op.bucket.comm_dtype, itemsize)
                   for op in self.ops if op.phase == PRE)

    def split_phases(self) -> tuple["CommSchedule", "CommSchedule"]:
        """(post, pre) sub-schedules for pipelined execution.  POST ops
        keep their ids and deps — nothing may depend on a PRE op inside
        one step; PRE ops drop every dep on a POST op (those producers
        ran in the previous step)."""
        pre_ids = {op.op_id for op in self.ops if op.phase == PRE}
        for op in self.ops:
            if op.phase != PRE and pre_ids.intersection(op.depends_on):
                raise ValueError(
                    f"post op {op.op_id} depends on deferred (PRE) op(s) "
                    f"{sorted(pre_ids.intersection(op.depends_on))} — a "
                    f"deferred result does not exist until the next step")
        post = tuple(op for op in self.ops if op.phase != PRE)
        pre = tuple(
            dataclasses.replace(
                op, depends_on=tuple(d for d in op.depends_on if d in pre_ids))
            for op in self.ops if op.phase == PRE)
        return CommSchedule(post).validate(), CommSchedule(pre).validate()

    def split_regroup(self) -> tuple["CommSchedule", "CommSchedule"]:
        """(old, new) sub-schedules of an elastic transition, split at the
        first REGROUP op (which stays on the old side); new-side deps on
        old-side ops are dropped."""
        cut = next((i for i, op in enumerate(self.ops)
                    if op.kind == REGROUP), None)
        if cut is None:
            raise ValueError("split_regroup: schedule has no REGROUP op")
        old = self.ops[:cut + 1]
        old_ids = {op.op_id for op in old}
        new_ids = {op.op_id for op in self.ops[cut + 1:]}
        new = tuple(
            dataclasses.replace(
                op, depends_on=tuple(d for d in op.depends_on if d in new_ids))
            for op in self.ops[cut + 1:])
        for op in old:
            if not old_ids.issuperset(op.depends_on):
                raise ValueError(
                    f"old-side op {op.op_id} depends on post-regroup "
                    f"op(s) {sorted(set(op.depends_on) - old_ids)}")
        return CommSchedule(old).validate(), CommSchedule(new).validate()

    def update_ops(self) -> tuple[CollectiveOp, ...]:
        """The StepProgram's optimizer-update nodes (empty for pure-sync
        schedules)."""
        return tuple(op for op in self.ops if op.kind == UPDATE)

    def stats(self) -> dict[str, Any]:
        lengths = self.chain_lengths()
        kinds: dict[str, int] = {}
        for op in self.ops:
            kinds[op.kind] = kinds.get(op.kind, 0) + 1
        return {
            "num_ops": len(self.ops),
            "num_chains": self.num_chains,
            "max_chain_len": max(lengths.values()) if lengths else 0,
            "kinds": kinds,
            "phases": self.phase_counts(),
        }

    def validate(self) -> "CommSchedule":
        """Structural soundness: op_id uniqueness, no dangling / forward
        chain-dep references, known kinds/phases/bucket indices
        (``repro_torch.analysis.passes.structural_findings``).  Returns
        self so planners can end with ``return CommSchedule(ops).validate()``.
        """
        from repro_torch.analysis.passes import structural_findings

        findings = structural_findings(self)
        if findings:
            raise ValueError(findings[0].message)
        return self


def itemsize_of(dtype: Any, fallback: int) -> int:
    """Wire bytes per element for a bucket's pinned comm dtype (the
    schedule-level itemsize when the bucket has no pin)."""
    return fallback if dtype is None else dtype.itemsize


def group_size(axes: tuple[str, ...], mesh_shape: Mapping[str, int]) -> int:
    """Ranks participating in a collective over ``axes`` (the MPI
    communicator size)."""
    g = 1
    for a in axes:
        g *= mesh_shape[a]
    return g


def mean_scale(axes: tuple[str, ...], mesh_shape: Mapping[str, int],
               mean_axes: tuple[str, ...]) -> float:
    """1/size over the ``mean_axes`` subset of ``axes`` (data-parallel
    mean; the paper's rescale=1/mini_batch_size lives in the loss when
    ``mean_axes`` is empty)."""
    n = 1
    for a in axes:
        if a in mean_axes:
            n *= mesh_shape[a]
    return 1.0 / n


def live_buckets(plan: BucketPlan,
                 skip_names: frozenset[str] = frozenset()) -> list[Bucket]:
    """Buckets in creation order with ``skip_names`` leaves dropped;
    buckets left empty disappear entirely."""
    out: list[Bucket] = []
    for bucket in plan.buckets:
        keep = [l for l in bucket.leaves if l.name not in skip_names]
        if not keep:
            continue
        if len(keep) != len(bucket.leaves):
            bucket = dataclasses.replace(bucket, leaves=tuple(keep))
        out.append(bucket)
    return out


def live_channels(plan: BucketPlan, skip_names: frozenset[str] = frozenset()
                  ) -> dict[int, list[Bucket]]:
    """``live_buckets`` grouped by channel (the ConCom communicator)."""
    out: dict[int, list[Bucket]] = {}
    for bucket in live_buckets(plan, skip_names):
        out.setdefault(bucket.channel, []).append(bucket)
    return out


def emit_gated(buf: torch.Tensor, deps: tuple[int, ...],
               handles: Mapping[int, dep.Handle],
               reduce_fn: Callable[[torch.Tensor], dep.Handle]) -> dep.Handle:
    """THE collective emitter (MXNET engine-thread analogue).

    Wait on the collectives of ``deps`` (read-dependency), issue
    ``reduce_fn(buf)`` and return its handle (the write to the dummy
    variable).  The schedule executor and ``KVStore`` both issue every
    collective through here.
    """
    dep.gate(handles, deps)
    return reduce_fn(buf)


def op_scope_name(op: CollectiveOp) -> str:
    """Profiler label for one op, as the reference names its scopes."""
    return f"comm.{op.kind}.b{op.bucket.bucket_id}.op{op.op_id}.{op.phase}"


def _rank_ordered_reduce_scatter(buf: torch.Tensor, comm: dist.ProcessGroup,
                                 g: int) -> dep.Handle:
    """The zero1 reduce-scatter: an all-to-all of the g chunks, then this
    rank's chunk summed over the peers in rank order.  Every element is
    summed in the same order wherever the bucket plan puts it, so the
    per-bucket StepProgram and the monolithic optimizer's one bucket
    agree bit for bit (as the reference's psum_scatter does); the wire
    bytes are the reduce-scatter's."""
    chunks = torch.empty_like(buf)
    dep.collective(dist.all_to_all_single, comm, chunks, buf).wait()
    rows = chunks.view(g, -1)
    shard = rows[0].clone()
    for i in range(1, g):
        shard.add_(rows[i])
    return dep.Handle(dep.Recorded(shard.device), shard)


class _OpEmitter:
    """Per-op emission engine behind ``execute``: holds the handles of
    issued ops, the reduce-scatter and update shards not yet consumed and
    the clip scales, and emits ONE op at a time into a flat leaf list."""

    def __init__(
        self,
        schedule: CommSchedule,
        plan: BucketPlan,
        *,
        reducer: Reducer,
        groups: Mapping[int, dist.ProcessGroup],
        mesh_shape: Mapping[str, int] | None = None,
        mean_axes: tuple[str, ...] = (),
        use_fused_staging: bool = True,
        loss_scale: float = 1.0,
        two_phase_impl: str = "psum",
        update_fn: Callable[[CollectiveOp, torch.Tensor], torch.Tensor] | None = None,
        clip_norm: float = 0.0,
        aux: dict | None = None,
        pending: Mapping[int, torch.Tensor] | None = None,
        model_sharded: frozenset[str] = frozenset(),
        device: torch.device = torch.device("cpu"),
    ):
        if two_phase_impl not in ("psum", "ring"):
            raise ValueError(f"unknown two_phase_impl {two_phase_impl!r}")
        self.plan = plan
        self.two_phase_impl = two_phase_impl
        self.reducer = reducer
        self.groups = groups
        self.mesh_shape = mesh_shape
        self.mean_axes = mean_axes
        self.use_fused_staging = use_fused_staging
        self.loss_scale = loss_scale
        self.update_fn = update_fn
        self.clip_norm = clip_norm
        self.aux = aux
        self.pending = pending
        self.model_sharded = model_sharded
        self.device = device
        self.by_id = {op.op_id: op for op in schedule.ops}
        self.handles: dict[int, dep.Handle] = {}
        # op_id -> (handle of the op that made the shard, unpadded size);
        # a consumer pops its shard and releases it
        self.shards: dict[int, tuple[dep.Handle, int]] = {}
        self.clip_scales: dict[int, torch.Tensor] = {}
        # reduce-scatters whose shard an UPDATE consumes: nothing reads
        # their leaves again, so the staged gradients are let go at once
        self.feeds_update = {
            d for op in schedule.ops if op.kind == UPDATE for d in op.depends_on
            if d in self.by_id and self.by_id[d].kind == REDUCE_SCATTER
            and self.by_id[d].bucket.bucket_id == op.bucket.bucket_id}

    # -- staging helpers ---------------------------------------------

    def _dtype_of(self, bucket: Bucket):
        return (bucket.comm_dtype if bucket.comm_dtype is not None
                else self.plan.comm_dtype)

    def _fused_ok(self, bucket: Bucket) -> bool:
        return self.use_fused_staging and coll_ops.staging_supported(
            (l.dtype for l in bucket.leaves), self._dtype_of(bucket))

    def _stage_in(self, bucket: Bucket, flat_out: list) -> torch.Tensor:
        """CopyFromTo(g, comm_buf): pack + cast (+ loss-scale), fused."""
        if self._fused_ok(bucket):
            return coll_ops.fused_pack(bucket, flat_out, self._dtype_of(bucket),
                                       scale=self.loss_scale)
        if self.loss_scale != 1.0:
            # scale in f32 BEFORE the comm-dtype cast, as the fused path
            return coll_ref.leafwise_pack(
                [flat_out[l.index] for l in bucket.leaves],
                self._dtype_of(bucket), scale=self.loss_scale)
        return pack(bucket, flat_out, self._dtype_of(bucket))

    def _stage_out(self, bucket: Bucket, buf: torch.Tensor,
                   inv_scale: float, flat_out: list) -> None:
        """CopyFromTo(recv_buf, g): unscale + cast back + scatter, fused.
        The fused path writes into the leaves of ``flat_out`` in place
        where they hold a contiguous tensor of the plan's shape and dtype
        (the gradients), else into new tensors (the f32 updates of a
        StepProgram, whose gradients were bf16 or were let go)."""
        if self._fused_ok(bucket):
            for l in bucket.leaves:
                t = flat_out[l.index]
                if (t is None or t.dtype != l.dtype or tuple(t.shape) != tuple(l.shape)
                        or t.device != buf.device or not t.is_contiguous()):
                    flat_out[l.index] = torch.empty(l.shape, dtype=l.dtype,
                                                    device=buf.device)
            coll_ops.fused_unpack(bucket, buf, flat_out, scale=inv_scale)
            return
        if inv_scale != 1.0:
            pieces = coll_ref.leafwise_unpack(
                buf, [l.size for l in bucket.leaves],
                [l.dtype for l in bucket.leaves], scale=inv_scale)
            for l, piece in zip(bucket.leaves, pieces):
                flat_out[l.index] = piece.reshape(l.shape)
            return
        unpack(bucket, buf, flat_out)

    def _scale_of(self, bucket: Bucket) -> float:
        if self.mesh_shape is None:
            return 1.0
        return mean_scale(bucket.reduce_axes, self.mesh_shape, self.mean_axes)

    def _group_size(self, bucket: Bucket, group) -> int:
        """Ranks in the bucket's reduce group: from the mesh (axes of size
        1, as the model axis at tp=1, make a group of one however many
        ranks the communicator holds), else the communicator's."""
        if self.mesh_shape is None:
            return dist.get_world_size(group.get(bucket.reduce_axes))
        return group_size(bucket.reduce_axes, self.mesh_shape)

    def _norm_parts(self, d: int) -> torch.Tensor:
        """Reduce-scatter ``d``'s shard's sums of squares (mean and loss
        scale undone) split as [model-sharded leaves, replicated leaves]:
        the shard of group rank k covers elements [k·c, (k+1)·c) of the
        packed bucket, each element in the leaf that packed it.  Each
        run of adjacent leaves of one kind is summed at once, the last
        with the shard's padding: without model-sharded leaves, the
        whole shard in one sum."""
        op = self.by_id[d]
        s = self.shards[d][0].out.to(torch.float32)
        g_scale = self._scale_of(op.bucket) / self.loss_scale
        group = self.groups[op.chain]
        c = s.numel()
        lo = 0
        if self._group_size(op.bucket, group) > 1:
            lo = dist.get_rank(group.get(op.bucket.reduce_axes)) * c
        runs: list[list[int]] = []          # [kind, start, end] in the bucket
        off = 0
        for leaf in op.bucket.leaves:
            a, b = max(off, lo), min(off + leaf.size, lo + c)
            if a < b:
                i = 0 if leaf.name in self.model_sharded else 1
                if runs and runs[-1][0] == i:
                    runs[-1][2] = b
                else:
                    runs.append([i, a, b])
            off += leaf.size
        if not runs:
            runs.append([1, lo, lo + c])
        runs[-1][2] = lo + c
        parts = torch.zeros(2, dtype=torch.float32, device=s.device)
        for i, a, b in runs:
            parts[i] += g_scale * g_scale * torch.sum(torch.square(s[a - lo:b - lo]))
        return parts

    def _shard_src(self, op: CollectiveOp, want: str,
                   optional: bool = False) -> int | None:
        """The dep producing this op's same-bucket shard (deps may also
        carry chain-ordering edges to other buckets' ops).  ``optional``
        returns None instead of raising: a deferred gather whose shard
        arrives through ``pending`` has no producer in the schedule."""
        srcs = [d for d in op.depends_on if d in self.shards
                and self.by_id[d].bucket.bucket_id == op.bucket.bucket_id]
        if not srcs:
            if optional:
                return None
            raise ValueError(
                f"{op.kind} op {op.op_id} has no {want} dep for "
                f"bucket {op.bucket.bucket_id}")
        return srcs[0]

    def _gate_data(self, op: CollectiveOp) -> None:
        """Wait on the deps that wrote this op's leaves (a zero1
        reduce-scatter after the model-axis sync of the same leaves)
        before staging reads them; the other deps only order the
        collective, and gate it (``emit_gated``)."""
        names = set(op.bucket.names)
        dep.gate(self.handles, [d for d in op.depends_on
                                if names.intersection(self.by_id[d].bucket.names)])

    # -- the per-op body ---------------------------------------------

    def emit(self, op: CollectiveOp, flat_out: list) -> None:
        """Issue one op on its chain's communicator after its deps,
        reading/writing leaves in ``flat_out``."""
        bucket = op.bucket
        group = self.groups[op.chain]

        if op.kind == ALLREDUCE:
            alone = self._group_size(bucket, group) == 1 < dist.get_world_size()
            if alone and self.loss_scale == 1.0 and all(
                    l.dtype == self._dtype_of(bucket) for l in bucket.leaves):
                # a group of one whose round trip through the buffer is a
                # bit copy: nothing to stage, sum or write back
                dep.gate(self.handles, op.depends_on)
                self.handles[op.op_id] = dep.Handle(
                    dep.Recorded(flat_out[bucket.leaves[0].index].device), None)
                return
            self._gate_data(op)
            send_buf = self._stage_in(bucket, flat_out)
            if alone:
                # a group of one inside a larger world: nothing to sum
                def reduce(b):
                    return dep.Handle(dep.Recorded(b.device), b)
            else:
                def reduce(b):
                    return self.reducer(b, bucket, group)
            h = emit_gated(send_buf, op.depends_on, self.handles, reduce)
            self._stage_out(bucket, h.wait(), 1.0 / self.loss_scale, flat_out)
            # done once its leaves are written: a dependent on another chain
            # (a zero1 reduce-scatter of these leaves) reads them
            self.handles[op.op_id] = dep.Handle(dep.Recorded(send_buf.device), None)

        elif op.kind == REDUCE_SCATTER:
            g = self._group_size(bucket, group)
            comm = group.get(bucket.reduce_axes) if g > 1 else None
            self._gate_data(op)
            send_buf = self._stage_in(bucket, flat_out)
            if op.op_id in self.feeds_update:
                for l in bucket.leaves:
                    flat_out[l.index] = None
            n = send_buf.numel()
            if (-n) % g:
                send_buf = F.pad(send_buf, (0, (-n) % g))

            def rs(b):
                if g == 1:
                    return dep.Handle(dep.Recorded(b.device), b)
                if self.two_phase_impl == "ring":
                    # the event after the ring's kernels: a NORM on another
                    # chain's stream reads the shard once it has fired
                    shard = coll_ops.ring_reduce_scatter(b, bucket.reduce_axes,
                                                         self.mesh_shape, group)
                    return dep.Handle(dep.Recorded(b.device), shard)
                if op.op_id in self.feeds_update:
                    return _rank_ordered_reduce_scatter(b, comm, g)
                shard = torch.empty(b.numel() // g, dtype=b.dtype, device=b.device)
                return dep.Handle(dep.collective(
                    dist.reduce_scatter_tensor, comm, shard, b), shard)

            h = emit_gated(send_buf, op.depends_on, self.handles, rs)
            self.handles[op.op_id] = h
            self.shards[op.op_id] = (h, n)

        elif op.kind == NORM:
            # the global squared norm: each gradient element lives in one
            # shard across the group, so the sum of every producing RS
            # shard's local sum of squares is the whole norm.  The shards
            # are still loss-scaled and pre-mean (UPDATE applies both
            # later): undone here, so the clip sees the true gradients.
            dep.gate(self.handles, op.depends_on)
            srcs = [d for d in op.depends_on
                    if d in self.shards and self.by_id[d].kind == REDUCE_SCATTER]
            if not srcs:
                raise ValueError(f"norm op {op.op_id} has no reduce_scatter dep")
            # [model-sharded, replicated]: under tensor parallelism the
            # model-sharded leaves' squares are summed over "model" too,
            # the replicated ones (equal on every model rank after their
            # sync) counted once
            sq = sum(self._norm_parts(d) for d in srcs)
            comm = (group.get(bucket.reduce_axes)
                    if self._group_size(bucket, group) > 1 else None)

            def psum(v):
                if comm is None:
                    return dep.Handle(dep.Recorded(v.device), v)
                return dep.Handle(dep.collective(dist.all_reduce, comm, v), v)

            red = emit_gated(sq, op.depends_on, self.handles, psum).wait()
            sharded = red[:1]
            if self.model_sharded:
                sharded = sharded.clone()
                dep.collective(dist.all_reduce, group.get(("model",)), sharded).wait()
            norm = torch.sqrt(sharded[0] + red[1])
            if self.clip_norm > 0:
                # on the device: no host sync
                self.clip_scales[op.op_id] = torch.clamp(
                    self.clip_norm / (norm + 1e-9), max=1.0)
            if self.aux is not None:
                self.aux["grad_norm"] = norm
            # UPDATEs on other chains read the scale: they wait on this
            self.handles[op.op_id] = dep.Handle(dep.Recorded(norm.device), norm)

        elif op.kind == UPDATE:
            if self.update_fn is None:
                raise ValueError(
                    f"schedule contains UPDATE op {op.op_id} but no "
                    f"update_fn was supplied")
            src = self._shard_src(op, "reduce_scatter")
            dep.gate(self.handles, op.depends_on)
            h, n = self.shards.pop(src)
            g_shard = h.out.to(torch.float32)
            h.release()
            # dp mean + loss unscale
            s = self._scale_of(bucket) / self.loss_scale
            if s != 1.0:
                g_shard = g_shard * s
            for d in op.depends_on:             # clip on shards, pre-update
                if d in self.clip_scales:
                    g_shard = g_shard * self.clip_scales[d]
            upd = self.update_fn(op, g_shard)
            del g_shard
            self.handles[op.op_id] = dep.Handle(dep.Recorded(upd.device), upd)
            self.shards[op.op_id] = (self.handles[op.op_id], n)
            if self.aux is not None:
                self.aux.setdefault("update_shards", {})[bucket.bucket_id] = upd

        elif op.kind == ALL_GATHER:
            has_pending = (self.pending is not None
                           and bucket.bucket_id in self.pending)
            src = self._shard_src(op, "reduce_scatter", optional=has_pending)
            h_src = None
            if src is not None:
                h_src, n = self.shards.pop(src)
                shard = h_src.out
                gathers_updates = self.by_id[src].kind == UPDATE
            else:
                # a PRE program: last step's UPDATE made the shard, carried
                # across the boundary (dp mean and loss unscale applied)
                shard, n = self.pending[bucket.bucket_id], bucket.size
                gathers_updates = True
            g = self._group_size(bucket, group)
            comm = group.get(bucket.reduce_axes) if g > 1 else None

            def ag(b):
                if g == 1:
                    return dep.Handle(dep.Recorded(b.device), b)
                if self.two_phase_impl == "ring":
                    full = coll_ops.ring_all_gather(b, bucket.reduce_axes,
                                                    self.mesh_shape, group)
                    return dep.Handle(dep.Recorded(b.device), full)
                full = torch.empty(b.numel() * g, dtype=b.dtype, device=b.device)
                return dep.Handle(dep.collective(
                    dist.all_gather_into_tensor, comm, full, b), full)

            # the producer is among the deps: gated before ag reads it
            h = emit_gated(shard, op.depends_on, self.handles, ag)
            self.handles[op.op_id] = h
            full = h.wait()[:n]
            del shard
            if h_src is not None:
                h_src.release()
            if gathers_updates:
                # optimizer updates: the dp mean and loss unscale were
                # applied to the grad shard
                self._stage_out(bucket, full, 1.0, flat_out)
            else:
                s = self._scale_of(bucket)
                if s != 1.0:
                    full = full * s
                self._stage_out(bucket, full, 1.0 / self.loss_scale, flat_out)
            # done once its leaves are written (as an allreduce)
            self.handles[op.op_id] = dep.Handle(dep.Recorded(full.device), None)
            del full

        elif op.kind == RESHARD:
            # elastic state movement: one kind, two sides, told apart as a
            # deferred gather is.  A shard in ``pending`` is the GATHER
            # side (the old mesh: the bucket's whole view rebuilt from the
            # dp shards); none is the SCATTER side (the new mesh: pack the
            # leaves, keep this rank's dp shard).  State values, never
            # gradients: no dp mean, no loss scale.
            g = self._group_size(bucket, group)
            comm = group.get(bucket.reduce_axes) if g > 1 else None
            if self.pending is not None and bucket.bucket_id in self.pending:
                shard, n = self.pending[bucket.bucket_id], bucket.size

                def rag(b):
                    if g == 1:
                        return dep.Handle(dep.Recorded(b.device), b)
                    if self.two_phase_impl == "ring":
                        full = coll_ops.ring_all_gather(b, bucket.reduce_axes,
                                                        self.mesh_shape, group)
                        return dep.Handle(dep.Recorded(b.device), full)
                    full = torch.empty(b.numel() * g, dtype=b.dtype, device=b.device)
                    return dep.Handle(dep.collective(
                        dist.all_gather_into_tensor, comm, full, b), full)

                full = emit_gated(shard, op.depends_on, self.handles, rag).wait()[:n]
                self._stage_out(bucket, full, 1.0, flat_out)
                self.handles[op.op_id] = dep.Handle(dep.Recorded(full.device), None)
                del full
            else:
                dep.gate(self.handles, op.depends_on)
                buf = self._stage_in(bucket, flat_out)
                n = buf.numel()
                if (-n) % g:
                    buf = F.pad(buf, (0, (-n) % g))
                n_shard = buf.numel() // g
                idx = dist.get_rank(comm) if comm is not None else 0
                shard = buf[idx * n_shard:(idx + 1) * n_shard].clone()
                del buf
                self.handles[op.op_id] = dep.Handle(dep.Recorded(shard.device), shard)
                if self.aux is not None:
                    self.aux.setdefault("reshard_shards", {})[bucket.bucket_id] = shard

        elif op.kind == REGROUP:
            # the group-rebuild barrier: a scalar sum every member of the
            # dissolving communicator joins (the MXNET-MPI regroup moment)
            g = self._group_size(bucket, group)
            one = torch.ones((), dtype=torch.float32, device=self.device)

            def psum(v):
                if g == 1:
                    return dep.Handle(dep.Recorded(v.device), v)
                return dep.Handle(dep.collective(
                    dist.all_reduce, group.get(bucket.reduce_axes), v), v)

            h = emit_gated(one, op.depends_on, self.handles, psum)
            self.handles[op.op_id] = h
            if self.aux is not None:
                self.aux["regroup_done"] = h.wait()

        elif op.kind == SEND:
            # pipeline boundary, sender half (DESIGN.md §15): pack the
            # payload (row 1 when fused, loss scale folded in) and park it
            # for the matched RECV, which makes the hop: the one transfer
            # is both halves, so the SEND carries the sender's deps and
            # the staging
            self._gate_data(op)
            buf = self._stage_in(bucket, flat_out)
            h = dep.Handle(dep.Recorded(buf.device), buf)
            self.handles[op.op_id] = h
            self.shards[op.op_id] = (h, buf.numel())

        elif op.kind == RECV:
            # receiver half: gate on the matched SEND (the same-bucket dep)
            # and the receiver's deps, make the hop on the bucket's stage
            # communicator (group rank i sends to i + shift and receives
            # from i - shift, mod the group), and deliver through the
            # unpack (row 2, loss scale undone)
            if len(bucket.reduce_axes) != 1:
                raise ValueError(
                    f"recv op {op.op_id}: SEND/RECV ride exactly one stage axis, "
                    f"got {bucket.reduce_axes!r}")
            src = self._shard_src(op, "send")
            h_src, _ = self.shards.pop(src)
            g = self._group_size(bucket, group)
            comm = group.get(bucket.reduce_axes) if g > 1 else None

            def hop(b, _shift=op.shift, _tag=bucket.bucket_id):
                i = dist.get_rank(comm) if g > 1 else 0
                out, = dep.ring_exchange(comm, i, g, _shift, [b], tags=[_tag])
                return dep.Handle(dep.Recorded(out.device), out)

            h = emit_gated(h_src.out, op.depends_on, self.handles, hop)
            h_src.release()
            self._stage_out(bucket, h.wait(), 1.0 / self.loss_scale, flat_out)
            self.handles[op.op_id] = dep.Handle(dep.Recorded(self.device), None)

        elif op.kind == DECODE:
            # local decode compute placeholder: the serving engine runs the
            # real math (``repro_torch.runtime.serve_loop``); here the node
            # is a pure scheduling point — it waits on its deps and is done,
            # so decode plans execute and replay without special cases
            dep.gate(self.handles, op.depends_on)
            self.handles[op.op_id] = dep.Handle(dep.Recorded(self.device), None)
            if self.aux is not None:
                self.aux.setdefault("decode_nodes", []).append(bucket.bucket_id)

        else:
            raise ValueError(f"unknown op kind {op.kind!r}")


def execute(
    schedule: CommSchedule,
    grads: Any,
    plan: BucketPlan,
    *,
    reducer: Reducer,
    groups: Mapping[int, dist.ProcessGroup],
    streams: dep.ChainStreams,
    mesh_shape: Mapping[str, int] | None = None,
    mean_axes: tuple[str, ...] = (),
    use_fused_staging: bool = True,
    loss_scale: float = 1.0,
    two_phase_impl: str = "psum",
    update_fn: Callable[[CollectiveOp, torch.Tensor], torch.Tensor] | None = None,
    clip_norm: float = 0.0,
    aux: dict | None = None,
    pending: Mapping[int, torch.Tensor] | None = None,
    model_sharded: frozenset[str] = frozenset(),
) -> Any:
    """Materialize a CommSchedule over a gradient tree.

    ``reducer`` runs every allreduce op.  ``groups`` maps each chain to
    its communicators (a ``dependency.ChainComms``: one a reduce set; or
    a single communicator over the ranks of every bucket) and ``streams``
    gives each chain its staging stream.
    ``mesh_shape`` and ``mean_axes`` apply the data-parallel mean on the
    reduce-scatter/all-gather path (the reducer carries its own).

    ``use_fused_staging`` stages each bucket through the fused pack /
    unpack kernels (``repro_torch.kernels.collectives``): one pass each
    way with the comm-dtype cast and the optional ``loss_scale`` folded
    in.  Buckets with non-float dtypes go the leafwise way.

    ``two_phase_impl`` is the reduce-scatter/all-gather transport:
    ``"psum"`` (``reduce_scatter_tensor``/``all_gather_into_tensor``) or
    ``"ring"`` (the chunked rings of ``kernels/collectives``).  A group
    of one moves nothing: its shard is the buffer.

    Full-step (StepProgram) ops, as the reference's ``execute``:
      UPDATE — ``update_fn(op, g_shard) -> upd_shard`` runs the sharded
        optimizer on the producing reduce-scatter's shard, cast to f32
        with the dp mean, ``1/loss_scale`` and the clip scale applied;
        the ALL_GATHER after it gathers updates (no mean, no unscale).
      NORM — sums the squares of every producing RS shard (mean and loss
        scale undone), split [model-sharded leaves, the rest], and
        all-reduces the two f32 sums on its chain; with
        ``clip_norm > 0`` the dependent UPDATEs see their shards times
        ``min(1, clip/(norm + 1e-9))``, computed on the device.  The norm
        lands in ``aux["grad_norm"]`` when ``aux`` is given.  Under tensor
        parallelism ``model_sharded`` names the leaves sharded over
        "model": their squares are summed over the model axis too, the
        replicated leaves' counted once, so the norm is the global one.
      ``pending`` maps bucket_id → the update shard carried from the
        previous step: an ALL_GATHER with no producer in the schedule (a
        PRE program's) gathers it.  UPDATEs record their shards in
        ``aux["update_shards"]`` (bucket_id-keyed) for the next step.

    Elastic ops (``repro_torch.elastic.reshard``), as the reference's:
      RESHARD — with a shard for its bucket in ``pending`` (the gather
        side, on the old mesh): all-gathers it over the bucket's axes,
        trims it and unpacks it into the leaves at scale 1; without (the
        scatter side, on the new mesh): packs the leaves, pads to the
        group and keeps this rank's dp shard in
        ``aux["reshard_shards"]`` (bucket_id-keyed).
      REGROUP — a scalar all-reduce over the bucket's axes that every
        member of the old group joins after its deps; the sum (the old
        group's size) lands in ``aux["regroup_done"]``.

    Pipeline ops (``core/pipeline_program.py``), as the reference's:
      SEND — packs the bucket's leaves (loss-scaled) and parks the buffer
        for its RECV.
      RECV — after its matched SEND (the same-bucket dep) and its other
        deps, moves the parked buffer one hop along the bucket's one
        stage axis (group rank i → i + ``shift``, mod the group; a
        ``dependency.exchange``, host-staged on gloo with CUDA tensors)
        and unpacks what arrived into the leaves, the loss scale undone.

    DECODE (``repro_torch.sim.serve``'s decode plans), as the reference's:
      a scheduling point that waits on its deps; its bucket_id is
      appended to ``aux["decode_nodes"]``.

    Ops are issued in schedule order; each waits on its ``depends_on``
    before it is issued.  The fused path writes reduced values into the
    gradient tensors in place; gathered updates go into new f32 tensors,
    and a reduce-scatter that feeds an UPDATE lets its leaves go once
    packed.  Each shard is released once its consumer has read it.  The
    returned tree holds the results.
    """
    flat_out = tree_leaves(grads)
    if len(flat_out) != plan.num_leaves:
        raise ValueError(
            f"plan built for {plan.num_leaves} leaves, got {len(flat_out)}")
    em = _OpEmitter(
        schedule, plan, reducer=reducer, groups=groups, mesh_shape=mesh_shape, mean_axes=mean_axes,
        use_fused_staging=use_fused_staging, loss_scale=loss_scale,
        two_phase_impl=two_phase_impl, update_fn=update_fn, clip_norm=clip_norm,
        aux=aux, pending=pending, model_sharded=model_sharded,
        device=getattr(streams, "device", torch.device("cpu")))
    with streams:
        for op in schedule.ops:
            with streams.on(op.chain), torch.profiler.record_function(
                    op_scope_name(op)):
                em.emit(op, flat_out)
    return tree_unflatten(plan.treedef, flat_out)

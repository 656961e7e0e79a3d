"""Live state reshard as scheduled collectives
(``repro/elastic/reshard.py``).

ZeRO-1 optimizer state is a dp-sharded flat array a bucket.  Under
tensor parallelism each model rank's shards hold the statistics of ITS
slice of the params: no global flat array holds them all.
``StateCodec`` moves the state through the IR instead: a *gather*
program (RESHARD ops through the shared ``_OpEmitter``) all-gathers each
bucket's dp shards into an f32 tree shaped like the rank's params, so
every model rank's values survive, and a *scatter* program re-slices
such a tree into the dp shards of any mesh.  ``encode ∘ decode`` on one
mesh is bit-exact: pack and unpack are exact inverses, and the pads stay
zero (AdamW: m' = b1·0 + (1-b1)·0 = 0, v likewise; SGD's momentum 0; a
pending update at a pad is -lr·(0/(√0+eps) + wd·0) = 0, the padded
param being 0 too).

``plan_reshard`` builds the mesh-transition IR (per-stream gathers on
the old mesh, ONE REGROUP barrier every old member joins, then
per-stream scatters on the new mesh) with GLOBAL leaf sizes and the
per-leaf divisibility facts of the new mesh, and verifies it with the
reshard analysis pass (``analysis/passes.py::check_reshard``).
``repro_torch.sim.simulate`` costs it: the gather side's RESHARDs as
all-gathers plus their unpack, the REGROUP as a scalar allreduce, the
scatter side's RESHARDs as a local pack.

``reshard_state`` is the execution.  The reference's one ``device_get``
crosses processes here: the old members' gather outputs (param-shaped,
each its own block of each leaf) are assembled to the global view
(``checkpoint/manager.py::host_global``) on the ranks in both meshes and
on the old mesh's first rank, which send the ranks that join (a
grow-back's, which hold nothing) their blocks; each new member keeps its
blocks and scatters them.  A deferred step's carry must be
flushed (``TrainStep.finalize``) before a transition: the pending
stream is not part of the transition IR, and the analysis pass rejects
a PRE op that crosses the regroup.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import Layout, global_shape, host_global
from repro_torch.core import dependency as dep
from repro_torch.core.buckets import Bucket, LeafInfo
from repro_torch.core.schedule import REGROUP, RESHARD, CollectiveOp, CommSchedule, execute
from repro_torch.parallel.sharding import local_shape, shard_leaf
from repro_torch.utils.trees import flatten_with_names, tree_unflatten

SHARD = "shard"     # the inner optimizer's one key (optim/zero.py)


def _require_zero1(ts) -> Any:
    gs = ts.gradsync
    if gs is None or gs.dp_plan is None:
        raise ValueError(
            "elastic reshard needs a scheduled ZeRO-1 TrainStep "
            "(gradsync with a dp_plan); non-zero1 optimizer state is "
            "param-shaped and moves through the plain checkpoint path")
    return gs


def _no_allreduce(buf, bucket, group):
    raise ValueError("a reshard program plans no allreduce")


class StateCodec:
    """Gather/scatter programs between one ``TrainStep``'s zero1 state
    shards and the param-shaped view, on every rank (the step is built on
    every world rank; a rank outside its mesh encodes and decodes
    nothing).

    One gather program and one scatter program serve every stream
    ("inner/m", "inner/v", "pending", …): they depend only on the dp
    bucket plan.  Streams are named as the reference names them (the
    port's inner state keeps each statistic under ``"shard"``)."""

    def __init__(self, ts):
        gs = _require_zero1(ts)
        self.ts = ts
        self.gs = gs
        self.dp_plan = gs.dp_plan
        self.keys = tuple((b.bucket_id, str(i)) for i, b in enumerate(self.dp_plan.buckets))
        for b in self.dp_plan.buckets:
            for leaf in b.leaves:
                if leaf.dtype != torch.float32:
                    raise ValueError(
                        f"StateCodec requires f32 params (stat values "
                        f"round-trip through the param-shaped view); "
                        f"leaf {leaf.name!r} is {leaf.dtype}")
        dp_axes = self.dp_plan.buckets[0].reduce_axes
        self.dp_size = math.prod(int(gs.mesh_shape.get(a, 1)) for a in dp_axes)
        like = ts.opt_state_like
        inner0 = like["inner"]["0"]
        self.stat_names = tuple(sorted(inner0))
        for n in self.stat_names:
            sub = inner0[n]
            leaf = sub[SHARD] if isinstance(sub, dict) else sub
            if leaf.dim() != 1:
                raise ValueError(
                    f"inner stat {n!r} has shape {tuple(leaf.shape)}; the codec "
                    f"only understands flat (n_shard,) zero1 stat leaves")
        self.has_pending = "pending" in like
        # one RESHARD op a dp bucket; the SAME schedule serves both sides
        # (a shard in ``pending`` flips the emitter to the gather side)
        ops = tuple(CollectiveOp(op_id=i, bucket=b, chain=i, kind=RESHARD)
                    for i, b in enumerate(self.dp_plan.buckets))
        self._sched = CommSchedule(ops).validate()
        comms = gs.groups[min(gs.groups)]
        self._groups = {i: comms for i in range(len(ops))}
        self._streams = dep.ChainStreams(range(len(ops)), gs.device)
        self._exec_kw = dict(
            reducer=_no_allreduce, groups=self._groups, streams=self._streams,
            mesh_shape=gs.mesh_shape, use_fused_staging=gs.cfg.use_fused_staging,
            two_phase_impl=gs._two_phase_impl())
        streams = [f"inner/{s}" for s in self.stat_names] + (
            ["pending"] if self.has_pending else [])
        self.layout = Layout(ts.mesh, {"params": ts.param_specs,
                                       "stats": {s: ts.param_specs for s in streams}},
                             comms, gs.device)

    # ------------------------------------------------------- the programs

    def _zeros(self) -> Any:
        leaves = {l.index: l for b in self.dp_plan.buckets for l in b.leaves}
        return tree_unflatten(self.dp_plan.treedef, [
            torch.zeros(leaves[i].shape, dtype=torch.float32, device=self.gs.device)
            for i in range(self.dp_plan.num_leaves)])

    def _gather(self, shards: Mapping[int, torch.Tensor]) -> Any:
        """Local shards {bucket_id: (n_shard,) f32} → the param-shaped
        (this rank's blocks) f32 tree."""
        return execute(self._sched, self._zeros(), self.dp_plan, pending=dict(shards),
                       **self._exec_kw)

    def _scatter(self, tree: Any) -> dict[int, torch.Tensor]:
        aux: dict = {}
        execute(self._sched, tree, self.dp_plan, aux=aux, **self._exec_kw)
        return {bid: aux["reshard_shards"][bid] for bid, _ in self.keys}

    # ------------------------------------------------------------ encode

    def _stat(self, opt_state, k: str, stat: str) -> torch.Tensor:
        sub = opt_state["inner"][k][stat]
        return sub[SHARD] if isinstance(sub, dict) else sub

    def _stream_shards(self, opt_state, stream: str) -> dict[int, torch.Tensor]:
        if stream == "pending":
            return {bid: opt_state["pending"][k] for bid, k in self.keys}
        stat = stream.split("/", 1)[1]
        return {bid: self._stat(opt_state, k, stat) for bid, k in self.keys}

    def encode(self, params, opt_state, *, include_pending: bool = True) -> dict[str, Any]:
        """Live (params, opt_state) → ``{"params": ..., "stats": {stream:
        tree}}``, every stats tree param-shaped f32: this rank's blocks
        of the mesh-portable global view (``layout`` gathers it).
        Collective over the mesh."""
        streams = [f"inner/{s}" for s in self.stat_names]
        if include_pending and self.has_pending:
            streams.append("pending")
        stats = {}
        for stream in streams:
            shards = self._stream_shards(opt_state, stream)
            for b in self.dp_plan.buckets:
                want = (b.size + (-b.size) % self.dp_size) // self.dp_size
                if tuple(shards[b.bucket_id].shape) != (want,):
                    raise ValueError(
                        f"stream {stream!r} bucket {b.bucket_id}: shard is "
                        f"{tuple(shards[b.bucket_id].shape)}, expected ({want},) — "
                        f"opt_state does not match this codec's dp plan")
            stats[stream] = self._gather(shards)
        named, treedef = flatten_with_names(params)
        return {"params": tree_unflatten(treedef, [p.detach() for _, p in named]),
                "stats": stats}

    def _local_like(self) -> Any:
        leaves = {l.index: l for b in self.dp_plan.buckets for l in b.leaves}
        return tree_unflatten(self.dp_plan.treedef, [
            torch.empty(leaves[i].shape, dtype=leaves[i].dtype, device="meta")
            for i in range(self.dp_plan.num_leaves)])

    def _streams_of(self, include_pending: bool) -> list[str]:
        return [f"inner/{s}" for s in self.stat_names] + (
            ["pending"] if include_pending and self.has_pending else [])

    def encoded_like(self, include_pending: bool = True) -> dict[str, Any]:
        """``encode``'s output as ``meta`` tensors (this rank's blocks; a
        checkpoint restore template): params in their dtype, stats f32."""
        params = self._local_like()
        named, treedef = flatten_with_names(params)
        f32 = tree_unflatten(treedef, [torch.empty(p.shape, dtype=torch.float32,
                                                   device="meta") for _, p in named])
        return {"params": params,
                "stats": {s: f32 for s in self._streams_of(include_pending)}}

    def _params_like(self) -> Any:
        """The GLOBAL param structs (``meta``): the dp plan's local leaf
        shapes scaled back up by the sharded mesh axes of each spec dim."""
        named_specs, treedef = flatten_with_names(self.ts.param_specs)
        by_name = {l.name: l for b in self.dp_plan.buckets for l in b.leaves}
        if len(by_name) != len(named_specs):
            raise ValueError(
                "dp plan does not cover every param leaf; the codec "
                "cannot reconstruct the global param structs")
        return tree_unflatten(treedef, [
            torch.empty(global_shape(by_name[n].shape, spec, self.ts.mesh),
                        dtype=by_name[n].dtype, device="meta")
            for n, spec in named_specs])

    def global_like(self, include_pending: bool = True) -> dict[str, Any]:
        """``encoded_like`` at the global shapes (what ``host_global``
        of an encoding holds)."""
        params = self._params_like()
        named, treedef = flatten_with_names(params)
        f32 = tree_unflatten(treedef, [torch.empty(p.shape, dtype=torch.float32,
                                                   device="meta") for _, p in named])
        return {"params": params,
                "stats": {s: f32 for s in self._streams_of(include_pending)}}

    # ------------------------------------------------------------ decode

    def decode(self, encoded: Mapping[str, Any]) -> tuple[Any, Any]:
        """This rank's blocks of the global view (``encode``'s output on
        this codec's mesh, or a restored checkpoint's) → (params tree on
        the step's device, opt_state).  Streams absent from
        ``encoded["stats"]`` (the pending carry after a flush) stay zero:
        gathering zeros is the identity update, so the first step after a
        transition starts as a fresh deferred run.  Collective over the
        mesh."""
        device = self.gs.device
        named, treedef = flatten_with_names(encoded["params"])
        params = tree_unflatten(treedef, [p.to(device, copy=True) for _, p in named])
        opt_state = self.ts.init_opt()
        for stream, tree in encoded["stats"].items():
            if stream != "pending" and stream.split("/", 1)[1] not in self.stat_names:
                raise ValueError(
                    f"encoded stream {stream!r} has no slot in this "
                    f"step's opt_state (stats: {self.stat_names})")
            if stream == "pending" and not self.has_pending:
                continue        # a scheduled step: the carry has no home
            named, treedef = flatten_with_names(tree)
            shards = self._scatter(tree_unflatten(treedef, [
                t.to(device=device, dtype=torch.float32, copy=True) for _, t in named]))
            for bid, k in self.keys:
                if stream == "pending":
                    opt_state["pending"][k] = shards[bid]
                else:
                    sub = opt_state["inner"][k]
                    stat = stream.split("/", 1)[1]
                    if isinstance(sub[stat], dict):
                        sub[stat][SHARD] = shards[bid]
                    else:
                        sub[stat] = shards[bid]
        return params, opt_state


# ------------------------------------------------------ transition IR

@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """One planned mesh transition: the verified IR and its static facts."""

    transition: CommSchedule
    old_mesh_shape: dict[str, int]
    new_mesh_shape: dict[str, int]
    leaf_divisibility: dict[str, tuple[int, int]]
    reshard_bytes: int              # gather-side state moved (f32 bytes)
    streams: tuple[str, ...]


def plan_reshard(old_ts, new_ts, params) -> ReshardPlan:
    """Plan, and verify statically, the old-mesh → new-mesh transition:
    per-stream gather RESHARDs on the old mesh, ONE REGROUP barrier over
    every old mesh axis depending on all of them, then per-stream scatter
    RESHARDs on the new mesh anchored on the barrier.  Leaves carry GLOBAL
    sizes and per-stream names ("param:<leaf>", "inner/m:<leaf>", …), so
    byte conservation holds even when tp changes the local shapes.  The
    pending carry is not in it: it must be flushed first.

    ``params`` is the global param tree (tensors or ``meta`` tensors);
    only shapes are read."""
    from repro_torch.analysis import verify_schedule

    old_gs = _require_zero1(old_ts)
    new_gs = _require_zero1(new_ts)
    named, _ = flatten_with_names(params)
    global_size = {n: math.prod(l.shape) for n, l in named}
    inner0 = old_ts.opt_state_like["inner"]["0"]
    streams = ("param",) + tuple(f"inner/{n}" for n in sorted(inner0))

    def rename(bucket: Bucket, stream: str, bid: int) -> Bucket:
        leaves = tuple(
            LeafInfo(name=f"{stream}:{l.name}", index=i, shape=(global_size[l.name],),
                     dtype=torch.float32, size=global_size[l.name])
            for i, l in enumerate(bucket.leaves))
        return Bucket(leaves=leaves, reduce_axes=bucket.reduce_axes, channel=0,
                      bucket_id=bid, comm_dtype=torch.float32)

    ops: list[CollectiveOp] = []
    for si, stream in enumerate(streams):
        for b in old_gs.dp_plan.buckets:
            oid = len(ops)
            ops.append(CollectiveOp(op_id=oid, bucket=rename(b, stream, oid),
                                    chain=si, kind=RESHARD))
    rg_id = len(ops)
    regroup_bucket = Bucket(
        leaves=(LeafInfo(name="__regroup", index=0, shape=(), dtype=torch.float32, size=1),),
        reduce_axes=tuple(old_gs.mesh_shape), channel=0, bucket_id=rg_id,
        comm_dtype=torch.float32)
    ops.append(CollectiveOp(op_id=rg_id, bucket=regroup_bucket, chain=0,
                            depends_on=tuple(range(rg_id)), kind=REGROUP))
    for si, stream in enumerate(streams):
        for b in new_gs.dp_plan.buckets:
            oid = len(ops)
            ops.append(CollectiveOp(op_id=oid, bucket=rename(b, stream, oid),
                                    chain=si, depends_on=(rg_id,), kind=RESHARD))
    transition = CommSchedule(tuple(ops))

    # static divisibility of every param leaf on the NEW mesh: the
    # scatter side must tile each sharded dim
    new_specs, _ = flatten_with_names(new_ts.param_specs)
    divis: dict[str, tuple[int, int]] = {}
    for (name, leaf), (_, spec) in zip(named, new_specs):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
            div = math.prod(int(new_gs.mesh_shape.get(a, 1)) for a in axes)
            divis[f"{name}@dim{dim}"] = (int(leaf.shape[dim]), div)

    reshard_bytes = sum(op.bucket.size * 4 for op in ops[:rg_id])
    verify_schedule(transition, mesh_shape=None,
                    old_mesh_shape=dict(old_gs.mesh_shape),
                    new_mesh_shape=dict(new_gs.mesh_shape),
                    leaf_divisibility=divis)
    return ReshardPlan(transition=transition, old_mesh_shape=dict(old_gs.mesh_shape),
                       new_mesh_shape=dict(new_gs.mesh_shape), leaf_divisibility=divis,
                       reshard_bytes=reshard_bytes, streams=streams)


# ------------------------------------------------------ execution

def _param_of(name: str) -> str:
    """The param leaf an encoded leaf ("params/<leaf>", "stats/inner/<stat>/
    <leaf>", "stats/pending/<leaf>") is shaped like."""
    for prefix in ("params/", "stats/pending/"):
        if name.startswith(prefix):
            return name[len(prefix):]
    return name.split("/", 3)[3]


def reshard_state(old_ts, new_ts, params, opt_state, *,
                  old_codec: StateCodec | None = None,
                  new_codec: StateCodec | None = None,
                  include_pending: bool = False,
                  group=None, view: dict | None = None) -> tuple[Any, Any]:
    """Move live (params, opt_state) from ``old_ts``'s mesh onto
    ``new_ts``'s: encode on the old mesh (RESHARD gathers), the global
    view assembled on the host of every rank that is in both meshes (the
    holders; the old mesh's first rank must be one), which send each rank
    that joins its blocks, a holder a joining rank in turn (point to
    point on ``group``, a gloo group over every world rank; the world by
    default), decode on the new mesh (RESHARD scatters).

    Called on every world rank; ``params``/``opt_state`` are read on the
    old mesh's ranks only.  Returns the new mesh's (params tree,
    opt_state) on its members, (None, None) elsewhere.  A deferred step's
    pending carry must be flushed (``TrainStep.finalize``) before, with
    the default ``include_pending=False``: the decoded carry is zero.
    ``view`` (a dict) gets the global host view on the ranks that
    assemble it (name → tensor, the encoding's names)."""
    old_mesh, new_mesh = old_ts.mesh, new_ts.mesh
    if old_mesh.world_ranks[0] not in new_mesh.world_ranks:
        raise ValueError(f"the old mesh's first rank {old_mesh.world_ranks[0]} is not in "
                         f"the new mesh over {new_mesh.world_ranks}: no rank in both "
                         f"would hold the view")
    old_codec = old_codec or StateCodec(old_ts)
    new_codec = new_codec or StateCodec(new_ts)
    holders = sorted(set(old_mesh.world_ranks) & set(new_mesh.world_ranks))
    joiners = sorted(set(new_mesh.world_ranks) - set(holders))
    # each joining rank is sent its blocks by one holder, in turn
    sender = {j: holders[i % len(holders)] for i, j in enumerate(joiners)}
    me = dist.get_rank()
    group = dist.group.WORLD if group is None else group
    host = None
    if old_ts.member:
        encoded = old_codec.encode(params, opt_state, include_pending=include_pending)
        layout = dataclasses.replace(old_codec.layout, specs={
            "params": old_codec.layout.specs["params"],
            "stats": {s: old_codec.layout.specs["params"] for s in encoded["stats"]}})
        host = host_global(encoded, layout, need={old_mesh.rank_in(w) for w in holders})
        host = dict(host) if host is not None else None
        if view is not None and host is not None:
            view.update(host)
        del encoded
    if not new_ts.member:
        return None, None
    spec_of = dict(flatten_with_names(new_ts.param_specs)[0])
    named, treedef = flatten_with_names(old_codec.global_like(include_pending))
    blocks = []
    for n, like in named:
        spec = spec_of[_param_of(n)]
        if host is not None:
            full = host.pop(n)
            for j in (j for j in joiners if sender[j] == me):
                coords = new_mesh.coords(new_mesh.rank_in(j))
                dist.send(shard_leaf(full, spec, new_mesh, coords).contiguous(), dst=j,
                          group=group)
            coords = new_mesh.coords(new_mesh.rank_in(me))
            blocks.append(shard_leaf(full, spec, new_mesh, coords).contiguous())
            del full
        else:
            t = torch.empty(local_shape(like.shape, spec, new_mesh), dtype=like.dtype)
            dist.recv(t, src=sender[me], group=group)
            blocks.append(t)
    return new_codec.decode(tree_unflatten(treedef, blocks))

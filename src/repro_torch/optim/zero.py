"""ZeRO-1 on the CommSchedule IR: reduce-scatter gradient sync, optimizer
state sharded over the data-parallel ranks, all-gather of the updates —
the port of ``repro/optim/zero.py``.

The wire bytes are those of the flat allreduce; the optimizer state and
its update math drop to 1/dp a rank.  Two shapes, both running through
``repro_torch.core.schedule.execute`` (no collective of their own):

  monolithic — ``zero1(...)`` wraps an inner optimizer whose ``update``
      packs every gradient into ONE f32 bucket and runs a 3-op
      RS→UPDATE→AG schedule on its own communicator.  The drop-in
      ``Optimizer`` API; the whole step serializes behind one pair.
  scheduled  — the StepProgram (``repro_torch.core.stepprogram``):
      GradSync plans per-bucket RS→UPDATE→AG triples with the registered
      strategies, and ``scheduled_update`` supplies the per-bucket shard
      math the UPDATE ops call.  Bit-identical with the monolithic path.

The port's optimizers work on name → tensor dicts: the inner optimizer
runs on a one-entry dict ``{"shard": flat f32 shard}``, so its state of a
bucket is, for AdamW, ``{"m": {"shard": ...}, "v": {"shard": ...}}``.
The rank's dp index is its rank in its dp group (the ranks of its model
coordinate on the step's mesh, ``Optimizer.zero1_setup``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import dependency as dep
from repro_torch.core.buckets import Bucket, BucketPlan, LeafInfo
from repro_torch.core.schedule import (
    ALL_GATHER,
    REDUCE_SCATTER,
    UPDATE,
    CollectiveOp,
    CommSchedule,
    execute,
)
from repro_torch.kernels.collectives import ops as coll_ops
from repro_torch.optim.optimizers import Optimizer
from repro_torch.parallel.sharding import MODEL_AXIS, Mesh
from repro_torch.utils.trees import flatten_with_names, tree_leaves

SHARD = "shard"     # the inner optimizer's one key


def shard_size(n: int, dp_size: int) -> int:
    """Per-rank shard of an ``n``-element buffer padded to ``dp_size``."""
    return (n + (-n) % dp_size) // dp_size


def _param_shard(bucket: Bucket, params_flat, dp_size: int, n_shard: int,
                 rank: int) -> torch.Tensor:
    """This rank's slice of the bucket's packed f32 params, padded to a
    multiple of ``dp_size`` as the reduce-scatter pads the gradients.
    Staged by ``fused_pack`` (row 1 on CUDA; a bf16 → f32 cast is exact,
    so the result equals the plain pack bit for bit)."""
    p_buf = coll_ops.fused_pack(bucket, [p.detach() for p in params_flat],
                                torch.float32)
    pad = (-p_buf.numel()) % dp_size
    if pad:
        p_buf = F.pad(p_buf, (0, pad))
    return p_buf[rank * n_shard:(rank + 1) * n_shard]


def _inner_update(inner: Optimizer, g_shard, state, p_shard, step):
    upd, new_state = inner.update({SHARD: g_shard}, state, {SHARD: p_shard}, step)
    return upd[SHARD], new_state


def _no_allreduce(buf, bucket, group):
    raise ValueError("the monolithic zero1 schedule plans no allreduce")


def zero1(inner: Optimizer, dp_axes: tuple[str, ...], dp_size: int) -> Optimizer:
    """Wrap ``inner`` so its state and update run on a 1/``dp_size`` shard.

    The UNREDUCED gradients go in (the reduce-scatter is the dp sum): run
    the step's sync with the dp axes excluded.  ``update`` runs the
    3-op schedule on a communicator of its own: the dp group of the mesh
    given to ``zero1_setup(mesh, device)`` (``make_train_step`` calls it;
    collective over the world), else created on the first call as if
    the mesh were the world (every rank updates at the same point)."""
    comms: dict[torch.device, tuple] = {}

    def setup(mesh, device):
        device = dep.resolve_device(device)
        comms[device] = (dep.mesh_comms([0], [dp_axes], mesh, device),
                         dep.ChainStreams([0], device))

    def init(params):
        n = sum(p.numel() for p in params.values())
        device = next(iter(params.values())).device
        return {"inner": inner.init(
            {SHARD: torch.empty(shard_size(n, dp_size), device=device)})}

    def update(grads, state, params, step):
        names = list(grads)
        leaves = [grads[n] for n in names]
        device = leaves[0].device
        infos = tuple(
            LeafInfo(name=n, index=i, shape=tuple(g.shape),
                     dtype=torch.float32, size=g.numel())
            for i, (n, g) in enumerate(zip(names, leaves)))
        bucket = Bucket(leaves=infos, reduce_axes=tuple(dp_axes),
                        channel=0, bucket_id=0, comm_dtype=torch.float32)
        _, treedef = flatten_with_names(leaves)
        plan = BucketPlan(buckets=(bucket,), treedef=treedef,
                          num_leaves=len(infos), comm_dtype=torch.float32)
        schedule = CommSchedule((
            CollectiveOp(op_id=0, bucket=bucket, chain=0,
                         kind=REDUCE_SCATTER),
            CollectiveOp(op_id=1, bucket=bucket, chain=0,
                         depends_on=(0,), kind=UPDATE),
            CollectiveOp(op_id=2, bucket=bucket, chain=0,
                         depends_on=(1,), kind=ALL_GATHER),
        )).validate()
        # only the product of the axis sizes matters to the emitter
        mesh_shape = {a: 1 for a in dp_axes}
        mesh_shape[dp_axes[0]] = dp_size
        if device not in comms:
            # no mesh given: the world, ranks row-major with "model" last
            setup(Mesh((*dp_axes, MODEL_AXIS),
                       {**mesh_shape, MODEL_AXIS: dist.get_world_size() // dp_size}), device)
        groups, streams = comms[device]
        dp_group = groups[0].get(dp_axes)
        rank = dist.get_rank(dp_group) if dp_group is not None else 0
        params_flat = [params[n] for n in names]
        carry: dict[str, Any] = {}

        def update_fn(op, g_shard):
            p_shard = _param_shard(op.bucket, params_flat, dp_size,
                                   g_shard.numel(), rank)
            upd, carry["inner"] = _inner_update(inner, g_shard, state["inner"],
                                                p_shard, step)
            return upd

        del leaves
        updates = execute(schedule, [grads[n] for n in names], plan,
                          reducer=_no_allreduce, groups=groups, streams=streams,
                          mesh_shape=mesh_shape, update_fn=update_fn)
        return dict(zip(names, updates)), {"inner": carry["inner"]}

    return Optimizer(init, update, zero1_meta=(inner, dp_size, tuple(dp_axes)),
                     zero1_setup=setup)


# ------------------------------------------------- scheduled (StepProgram)

def zero1_state(inner: Optimizer, dp_plan: BucketPlan, dp_size: int,
                device: torch.device) -> dict:
    """The per-bucket sharded state the scheduled path carries,
    zero-initialized: ``{"inner": {"<k>": state_k}}``, state_k being
    ``inner.init`` of bucket k's shard."""
    return {"inner": {
        str(i): inner.init({SHARD: torch.empty(shard_size(b.size, dp_size),
                                               device=device)})
        for i, b in enumerate(dp_plan.buckets)}}


def zero1_pending(dp_plan: BucketPlan, dp_size: int,
                  device: torch.device) -> dict:
    """The deferred all-gathers' carry: one f32 update shard a dp bucket,
    keyed like the inner state, zero-initialized (gathering zeros is the
    identity update, so a fresh deferred run starts as a scheduled one)."""
    return {str(i): torch.zeros(shard_size(b.size, dp_size), dtype=torch.float32,
                                device=device)
            for i, b in enumerate(dp_plan.buckets)}


def scheduled_update(inner: Optimizer, dp_plan: BucketPlan, params: Any,
                     state: Any, step: int, *, dp_size: int, rank: int):
    """The UPDATE-op callback of a StepProgram schedule.

    Returns ``(update_fn, new_state)``: ``update_fn(op, g_shard)`` slices
    this rank's param shard of the op's bucket (``params``: the tree the
    plan indexes), runs the inner optimizer on the reduced gradient
    shard, records the bucket's new inner state in ``new_state["inner"]``
    and returns the update shard, which the schedule's all-gather then
    materializes.  ``new_state`` is complete once every UPDATE ran."""
    params_flat = tree_leaves(params)
    key_of = {b.bucket_id: str(i) for i, b in enumerate(dp_plan.buckets)}
    new_state: dict[str, dict] = {"inner": {}}

    def update_fn(op, g_shard):
        key = key_of[op.bucket.bucket_id]
        p_shard = _param_shard(op.bucket, params_flat, dp_size,
                               g_shard.numel(), rank)
        upd, new_state["inner"][key] = _inner_update(
            inner, g_shard, state["inner"][key], p_shard, step)
        return upd

    return update_fn, new_state

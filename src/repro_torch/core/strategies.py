"""Collective-embedding strategies as pure CommSchedule planners — the
port of ``repro/core/strategies.py``.

Every strategy computes the identical reduction (a sum of each bucket
over its reduction axes); they differ ONLY in the dependency structure:
which collective waits on which — the direct analogue of which MXNET
thread issues the MPI call.  A strategy is a pure

    plan(bucket_plan, *, skip_names=frozenset()) -> CommSchedule

function registered in ``repro_torch.core.registry``.

Paper strategies (§4):
  funnel  — ONE chain through every collective.  Paper §4.1.
  concom  — buckets hashed to ``num_channels`` independent chains, one
            communicator each.  Paper §4.2.
  depcha  — in-scan leaves were reduced inside the backward; the rest
            ride independent chains like concom.  Paper §4.3.
Beyond-paper:
  priority — concom's chains with each chain's buckets reversed.
  rsag     — each bucket's allreduce split into reduce-scatter →
             all-gather, RS ops chained per channel.

Reducers, each a ``(buf, bucket, comms) -> Handle``, given the chain's
``dependency.ChainComms`` and running on the communicator of the
bucket's reduce axes:
  flat            — an async ``dist.all_reduce`` on that communicator.
  ring            — the chunked bidirectional ring (``kernels/collectives``),
                    over several axes a ring an axis.
  compressed      — int8 block-quantized two-phase allreduce
                    (``core/compression.py``); flat below 256·g elements.
  compressed_ring — compressed with its gather phase on the ring.
  hierarchical    — on a ("pod", "data") mesh the three stages of
                    ``core/hierarchical.py``: intra-pod reduce-scatter,
                    inter-pod allreduce of the shard, intra-pod
                    all-gather, then a psum over the bucket's other axes
                    (a replicated leaf's "model"); flat otherwise.  The
                    stages run on the ``PodComm`` of the chain's
                    ``ChainComms`` (``GradSync`` builds both).
  hierarchical_ring — hierarchical with stages 1 and 3 on the intra-pod
                    ring: the peer-memory ring kernels on CUDA.
A ring, compressed or hierarchical reducer is a sequence of collectives
ordered on the current stream (run to its end on the host where the
transport is host-staged), so its handle needs no work of its own.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import dependency as dep
from repro_torch.core import registry
from repro_torch.core.buckets import Bucket, BucketPlan
from repro_torch.core.compression import compressed_allreduce
from repro_torch.core.dependency import ChainComms, Handle
from repro_torch.core.hierarchical import flat_allreduce, hierarchical_allreduce
from repro_torch.core.registry import register_reducer, register_strategy
from repro_torch.core.schedule import (
    ALL_GATHER,
    REDUCE_SCATTER,
    CollectiveOp,
    CommSchedule,
    Reducer,
    group_size,
    live_buckets,
    live_channels,
    mean_scale,
)
from repro_torch.kernels.collectives import ops as coll_ops


# ---------------------------------------------------------------- reducers

@register_reducer("flat")
def _flat_factory(mesh_shape: dict[str, int], *,
                  mean_axes: tuple[str, ...] = ()) -> Reducer:
    """Plain sum over all reduction axes (the paper's primitive).  It
    always issues ``dist.all_reduce`` on the chain's communicator, at
    world size 1 too."""

    def reduce_flat(buf: torch.Tensor, bucket: Bucket, comms: ChainComms) -> Handle:
        return Handle(flat_allreduce(buf, comms.get(bucket.reduce_axes)), buf,
                      mean_scale(bucket.reduce_axes, mesh_shape, mean_axes))

    return reduce_flat


def _hier_impl(mesh_shape: dict[str, int], *,
               mean_axes: tuple[str, ...] = (),
               use_ring: bool = False) -> Reducer:
    def reduce_hier(buf: torch.Tensor, bucket: Bucket, comms: ChainComms) -> Handle:
        axes = bucket.reduce_axes
        scale = mean_scale(axes, mesh_shape, mean_axes)
        if "pod" in axes and "data" in axes:
            if comms.pod is None:
                raise ValueError(
                    "the hierarchical reducers need the chain's PodComm "
                    "(GradSync builds it on a mesh with a pod axis)")
            # the pod/data stages at this rank's model coordinate, then a
            # psum over the remaining axes (a replicated leaf's "model")
            rest = tuple(a for a in axes if a not in ("pod", "data")
                         and mesh_shape[a] > 1)
            out = hierarchical_allreduce(buf, comms.pod, use_ring=use_ring)
            if rest:
                dep.collective(dist.all_reduce, comms.get(rest), out).wait()
            return Handle(dep.DONE, out, scale)
        return Handle(flat_allreduce(buf, comms.get(axes)), buf, scale)

    return reduce_hier


@register_reducer("hierarchical")
def _hier_factory(mesh_shape: dict[str, int], *,
                  mean_axes: tuple[str, ...] = ()) -> Reducer:
    """3-stage RS(data) → AR(pod) → AG(data) when both axes are present."""
    return _hier_impl(mesh_shape, mean_axes=mean_axes)


@register_reducer("hierarchical_ring")
def _hier_ring_factory(mesh_shape: dict[str, int], *,
                       mean_axes: tuple[str, ...] = ()) -> Reducer:
    """hierarchical with stages 1 and 3 on the intra-pod ring (the
    peer-memory ring kernels on CUDA, the plain ring on the CPU)."""
    return _hier_impl(mesh_shape, mean_axes=mean_axes, use_ring=True)


def _comp_impl(mesh_shape: dict[str, int], *,
               mean_axes: tuple[str, ...] = (),
               use_ring: bool = False) -> Reducer:
    flat = _flat_factory(mesh_shape, mean_axes=mean_axes)

    def reduce_comp(buf: torch.Tensor, bucket: Bucket, comms: ChainComms) -> Handle:
        g = group_size(bucket.reduce_axes, mesh_shape)
        if g == 1 or buf.shape[0] < 256 * g:
            return flat(buf, bucket, comms)
        out = compressed_allreduce(buf, bucket.reduce_axes, mesh_shape, comms,
                                   use_ring=use_ring)
        return Handle(dep.DONE, out,
                      mean_scale(bucket.reduce_axes, mesh_shape, mean_axes))

    return reduce_comp


@register_reducer("compressed")
def _comp_factory(mesh_shape: dict[str, int], *,
                  mean_axes: tuple[str, ...] = ()) -> Reducer:
    """int8 block-quantized wire format for large buffers."""
    return _comp_impl(mesh_shape, mean_axes=mean_axes)


@register_reducer("compressed_ring")
def _comp_ring_factory(mesh_shape: dict[str, int], *,
                       mean_axes: tuple[str, ...] = ()) -> Reducer:
    """compressed with the int8 gather phase on the ring all-gather."""
    return _comp_impl(mesh_shape, mean_axes=mean_axes, use_ring=True)


@register_reducer("ring")
def _ring_factory(mesh_shape: dict[str, int], *,
                  mean_axes: tuple[str, ...] = ()) -> Reducer:
    """Chunked bidirectional ring allreduce (ring RS → ring AG), each
    hop's combine on the ring-accumulate kernel."""

    def reduce_ring(buf: torch.Tensor, bucket: Bucket, comms: ChainComms) -> Handle:
        out = coll_ops.ring_allreduce(buf, bucket.reduce_axes, mesh_shape, comms)
        return Handle(dep.DONE, out,
                      mean_scale(bucket.reduce_axes, mesh_shape, mean_axes))

    return reduce_ring


def make_reducer(name: str, mesh_shape: dict[str, int], *,
                 mean_axes: tuple[str, ...] = ()) -> Reducer:
    """Build the per-bucket collective from the registered factory."""
    return registry.get_reducer(name)(mesh_shape, mean_axes=mean_axes)


# --------------------------------------------------------------- planners

def _chain(buckets: list[Bucket], chain_id: int, start_id: int,
           ops: list[CollectiveOp]) -> int:
    """Append one serialized chain (op i+1 waits on op i); returns next id."""
    prev: int | None = None
    oid = start_id
    for bucket in buckets:
        ops.append(CollectiveOp(
            op_id=oid, bucket=bucket, chain=chain_id,
            depends_on=(prev,) if prev is not None else ()))
        prev = oid
        oid += 1
    return oid


@register_strategy("funnel", single_chain=True)
def plan_funnel(plan: BucketPlan, *,
                skip_names: frozenset[str] = frozenset()) -> CommSchedule:
    """One chain through ALL buckets in creation order (paper §4.1)."""
    ops: list[CollectiveOp] = []
    _chain(live_buckets(plan, skip_names), 0, 0, ops)
    return CommSchedule(tuple(ops)).validate()


@register_strategy("concom")
def plan_concom(plan: BucketPlan, *,
                skip_names: frozenset[str] = frozenset()) -> CommSchedule:
    """Independent chain per channel → up to num_channels in flight (§4.2)."""
    ops: list[CollectiveOp] = []
    oid = 0
    for ch, buckets in sorted(live_channels(plan, skip_names).items()):
        oid = _chain(buckets, ch, oid, ops)
    return CommSchedule(tuple(ops)).validate()


@register_strategy("depcha", uses_in_scan=True, deferred_pull=True)
def plan_depcha(plan: BucketPlan, *,
                skip_names: frozenset[str] = frozenset()) -> CommSchedule:
    """In-scan leaves (``skip_names``) were reduced inside the backward
    scan; leftover buckets ride independent chains like concom (§4.3)."""
    return plan_concom(plan, skip_names=skip_names)


@register_strategy("priority")
def plan_priority(plan: BucketPlan, *,
                  skip_names: frozenset[str] = frozenset()) -> CommSchedule:
    """concom chains with each chain's buckets in REVERSE creation order:
    front-of-model gradients (needed first next step) finish first."""
    ops: list[CollectiveOp] = []
    oid = 0
    for ch, buckets in sorted(live_channels(plan, skip_names).items()):
        oid = _chain(list(reversed(buckets)), ch, oid, ops)
    return CommSchedule(tuple(ops)).validate()


@register_strategy("rsag", two_phase=True)
def plan_rsag(plan: BucketPlan, *,
              skip_names: frozenset[str] = frozenset()) -> CommSchedule:
    """Per-bucket reduce-scatter→all-gather pipelined over channels: RS
    ops chain serially per channel; each AG depends only on its own RS."""
    ops: list[CollectiveOp] = []
    oid = 0
    for ch, buckets in sorted(live_channels(plan, skip_names).items()):
        prev_rs: int | None = None
        for bucket in buckets:
            rs_id, ag_id = oid, oid + 1
            ops.append(CollectiveOp(
                op_id=rs_id, bucket=bucket, chain=ch, kind=REDUCE_SCATTER,
                depends_on=(prev_rs,) if prev_rs is not None else ()))
            ops.append(CollectiveOp(
                op_id=ag_id, bucket=bucket, chain=ch, kind=ALL_GATHER,
                depends_on=(rs_id,)))
            prev_rs = rs_id
            oid += 2
    return CommSchedule(tuple(ops)).validate()

"""Gradient bucketing: KVStore keys → communication buffers.

The paper allreduces one tensor per KVStore key from a dedicated
``comm_buf`` (Figs 6, 9, 11).  A *bucket* generalizes the comm buffer: a
contiguous 1-D staging buffer holding one or more gradient leaves of the
same reduction signature.  Bucket size is a schedule parameter (paper's
per-key granularity == ``bucket_bytes=0``); hashing buckets to channels
reproduces ConCom's key→communicator hash.

The port of ``repro/core/buckets.py``: the same grouping and fill rules,
so a plan built here equals the reference's field by field.  Leaf dtypes
are ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from repro_torch.parallel.sharding import missing_axes
from repro_torch.utils.trees import TreeDef, flatten_with_names


@dataclasses.dataclass(frozen=True)
class LeafInfo:
    name: str
    index: int          # position in the flat gradient list
    shape: tuple[int, ...]
    dtype: Any
    size: int           # elements


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One communication buffer: a set of leaves reduced by one collective."""

    leaves: tuple[LeafInfo, ...]
    reduce_axes: tuple[str, ...]   # mesh axes of the sum (the "communicator")
    channel: int                   # ConCom: which communicator chain
    bucket_id: int
    comm_dtype: Any = None         # per-bucket wire dtype (None = the plan's)

    @property
    def size(self) -> int:
        return sum(l.size for l in self.leaves)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(l.name for l in self.leaves)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]
    treedef: TreeDef
    num_leaves: int
    comm_dtype: Any

    @property
    def total_bytes(self) -> int:
        return sum(b.size for b in self.buckets) * self.comm_dtype.itemsize

    def channels(self) -> dict[int, list[Bucket]]:
        out: dict[int, list[Bucket]] = {}
        for b in self.buckets:
            out.setdefault(b.channel, []).append(b)
        return out


def make_bucket_plan(
    grads_like: Any,
    param_specs: Any,
    mesh,
    *,
    bucket_bytes: int = 4 * 1024 * 1024,
    num_channels: int = 1,
    comm_dtype=torch.float32,
    reverse: bool = True,
    exclude_axes: tuple[str, ...] = (),
) -> BucketPlan:
    """Build a bucket plan for a gradient tree.

    Args:
      grads_like: tree of tensors (any device, ``meta`` included) giving
        the gradient shapes and dtypes.
      param_specs: matching tree of param specs (tuples of axis names).
      mesh: the port's ``Mesh`` (axis names and sizes).
      bucket_bytes: max staging-buffer size; 0 → one bucket per leaf
        (the paper's per-key granularity).
      num_channels: ConCom communicator count; buckets are round-robin
        hashed to channels (paper: ``key % num_comms``).
      reverse: bucket in reverse key order — gradients become ready
        back-to-front during backprop, so early buckets fill first.
      exclude_axes: mesh axes some other mechanism reduces — dropped
        from reduce sets.
    """
    named, treedef = flatten_with_names(grads_like)
    specs_named, _ = flatten_with_names(param_specs)
    if len(specs_named) != len(named):
        raise ValueError(
            f"{len(named)} gradient leaves but {len(specs_named)} specs")
    itemsize = comm_dtype.itemsize

    infos: list[tuple[LeafInfo, tuple[str, ...]]] = []
    for i, ((name, leaf), (_, spec)) in enumerate(zip(named, specs_named)):
        axes = missing_axes(spec, mesh)
        if exclude_axes:
            axes = tuple(a for a in axes if a not in exclude_axes)
        if not axes:
            continue   # nothing to reduce — leaf passes through sync
        shape = tuple(leaf.shape)
        infos.append((LeafInfo(name=name, index=i, shape=shape,
                               dtype=leaf.dtype, size=math.prod(shape)),
                      axes))

    if reverse:
        infos = infos[::-1]

    # group by reduction signature, then fill size-capped buckets in order
    buckets: list[Bucket] = []
    by_axes: dict[tuple[str, ...], list[LeafInfo]] = {}
    for info, axes in infos:
        by_axes.setdefault(axes, []).append(info)

    bid = 0
    for axes, group in by_axes.items():
        cur: list[LeafInfo] = []
        cur_bytes = 0
        for info in group:
            leaf_bytes = info.size * itemsize
            if cur and bucket_bytes and cur_bytes + leaf_bytes > bucket_bytes:
                buckets.append(Bucket(tuple(cur), axes, bid % num_channels, bid))
                bid += 1
                cur, cur_bytes = [], 0
            cur.append(info)
            cur_bytes += leaf_bytes
            if bucket_bytes == 0:
                buckets.append(Bucket(tuple(cur), axes, bid % num_channels, bid))
                bid += 1
                cur, cur_bytes = [], 0
        if cur:
            buckets.append(Bucket(tuple(cur), axes, bid % num_channels, bid))
            bid += 1

    return BucketPlan(buckets=tuple(buckets), treedef=treedef,
                      num_leaves=len(named), comm_dtype=comm_dtype)


def pack(bucket: Bucket, flat_leaves: Sequence[torch.Tensor],
         comm_dtype) -> torch.Tensor:
    """CopyFromTo(g, send_buf): stage bucket leaves into one 1-D comm buffer."""
    parts = [flat_leaves[l.index].reshape(-1).to(comm_dtype)
             for l in bucket.leaves]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack(bucket: Bucket, buf: torch.Tensor,
           flat_out: list[torch.Tensor | None]) -> None:
    """CopyFromTo(recv_buf, g): split the reduced buffer back into leaves."""
    off = 0
    for l in bucket.leaves:
        flat_out[l.index] = buf[off:off + l.size].reshape(l.shape).to(l.dtype)
        off += l.size

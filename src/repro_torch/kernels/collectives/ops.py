"""Fused comm staging and the ring collectives: the public API
(``repro/kernels/collectives/ops.py``).

``fused_pack``/``fused_unpack`` stage one bucket in one pass each way:
on CUDA tensors through the hand-written kernels (``kernel.py``), on CPU
tensors through their plain versions (``ref.py``).  The device of the
tensors decides; a CUDA tensor never reaches the plain version here.
The reference's ``xla`` tier has no counterpart.

Buckets holding a dtype the kernels do not take (``staging_supported``
is False: integer or complex leaves) never come here — the emitter
stages them leafwise, as the reference does.

``ring_reduce_scatter``/``ring_all_gather``/``ring_allreduce`` run the
chunked, bidirectional rings of ``ref.py`` over a bucket's communicator.
Each hop's combine, both ring directions at once, is one launch of the
CUDA ``ring_accum_pairs_kernel`` on CUDA tensors and its plain version
``ref.ring_accum_pairs_ref`` (``torch.add`` a pair) on CPU tensors: the
two round alike, so no result differs.
(The reference runs its Pallas combine only when asked,
``use_accum_kernel``; here the device decides, as for staging.)  Rank
``r`` owns chunk ``r`` after the reduce-scatter, so they stand in for
``reduce_scatter_tensor``/``all_gather_into_tensor``: the ``ring``
reducer, rsag's two-phase ops and compressed_ring's gather phase.

``pod_ring_reduce_scatter``/``pod_ring_all_gather`` are the intra-pod
rings of ``hierarchical_ring`` (stages 1 and 3).  On CUDA tensors they
run the peer-memory kernels ``ring_reduce_scatter_kernel``/
``ring_all_gather_kernel`` over the pod's ``PeerRing``: each hop goes
straight into the neighbour's memory and is signalled in the stream,
with no host round trip.  On CPU tensors they run the plain rings of
``ref.py`` over the intra-pod gloo group.  The two are equal bit for bit.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.collectives import kernel, ref

_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def staging_supported(leaf_dtypes, comm_dtype) -> bool:
    """Fused staging handles float↔float casts; anything else (int grads,
    complex) goes down the leafwise path."""
    return all(d in _FLOATS for d in (*leaf_dtypes, comm_dtype))


def _device_of(tensors: Sequence[torch.Tensor]) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"bucket tensors span devices {sorted(map(str, devices))}")
    return devices.pop()


def fused_pack(bucket, flat_leaves: Sequence[torch.Tensor], comm_dtype, *,
               scale: float = 1.0, out: torch.Tensor | None = None) -> torch.Tensor:
    """CopyFromTo(g, comm_buf), fused: one staging pass over the bucket.

    ``bucket``: a ``repro_torch.core.buckets.Bucket``; ``flat_leaves``:
    the flat gradient list it indexes into.  ``scale`` is the optional
    loss-scale folded into the cast.  The buffer is new, or ``out`` (a
    contiguous 1-D ``comm_dtype`` tensor of the bucket's size).
    """
    leaves = [flat_leaves[l.index] for l in bucket.leaves]
    if _device_of(leaves).type == "cuda":
        return kernel.pack_bucket_kernel(leaves, comm_dtype, scale=scale, out=out)
    packed = ref.leafwise_pack(leaves, comm_dtype, scale=scale)
    if out is None:
        return packed
    if out.dtype != comm_dtype or out.shape != packed.shape or out.device != packed.device:
        raise ValueError(f"out must be a 1-D {comm_dtype} tensor of {packed.numel()} "
                         f"elements on {packed.device}; got {out.dtype}"
                         f"{tuple(out.shape)} on {out.device}")
    return out.copy_(packed)


def fused_unpack(bucket, buf: torch.Tensor, flat_out: list[torch.Tensor], *,
                 scale: float = 1.0) -> None:
    """CopyFromTo(recv_buf, g), fused: write the reduced buffer back into
    the bucket's leaves of ``flat_out`` (cast back + inverse loss-scale in
    the same pass).  The leaves are written in place, so each
    ``flat_out[l.index]`` must be a contiguous tensor of the leaf's shape
    and dtype on ``buf``'s device."""
    outs = [flat_out[l.index] for l in bucket.leaves]
    for l, t in zip(bucket.leaves, outs):
        if t.shape != l.shape or t.dtype != l.dtype:
            raise ValueError(
                f"leaf {l.name}: target is {tuple(t.shape)} {t.dtype}, the "
                f"plan says {l.shape} {l.dtype}")
    if buf.device.type == "cuda":      # the kernel checks every leaf's device
        kernel.unpack_bucket_kernel(buf, outs, scale=scale)
        return
    _device_of([buf, *outs])
    pieces = ref.leafwise_unpack(buf, [l.size for l in bucket.leaves],
                                 [l.dtype for l in bucket.leaves], scale=scale)
    for t, piece in zip(outs, pieces):
        t.view(-1).copy_(piece)


# ---------------------------------------------------------------- rings

def _ring_axes(axes: Sequence[str],
               mesh_shape: Mapping[str, int]) -> list[tuple[str, int]]:
    return [(a, int(mesh_shape[a])) for a in axes
            if int(mesh_shape.get(a, 1)) > 1]


def group_size(axes: Sequence[str], mesh_shape: Mapping[str, int]) -> int:
    g = 1
    for _, s in _ring_axes(axes, mesh_shape):
        g *= s
    return g


def _ring_size(axes: Sequence[str], mesh_shape: Mapping[str, int],
               group: dist.ProcessGroup) -> int:
    """The ring's size, checked against ``group``.  The reference
    decomposes a group over several axes of size > 1 axis by axis; that
    needs a communicator per axis, which comes with tensor parallelism."""
    ring = _ring_axes(axes, mesh_shape)
    if len(ring) > 1:
        raise NotImplementedError(
            f"a ring over several mesh axes {ring} needs a communicator per "
            f"axis: ROADMAP queue 1 item 9")
    g = ring[0][1] if ring else 1
    if g > 1 and dist.get_world_size(group) != g:
        raise ValueError(f"axes {tuple(axes)} make a ring of {g}, the "
                         f"communicator holds {dist.get_world_size(group)} ranks")
    return g


def _accum(device: torch.device):
    """The per-hop combine of every direction's pair for tensors on
    ``device``; on CUDA one launch that adds into the received buffers."""
    if device.type == "cuda":
        return kernel.ring_accum_pairs_kernel
    return ref.ring_accum_pairs_ref


def ring_reduce_scatter(buf: torch.Tensor, axes: tuple[str, ...],
                        mesh_shape: Mapping[str, int],
                        group: dist.ProcessGroup, *,
                        bidirectional: bool = True) -> torch.Tensor:
    """(n,) buffer, n divisible by the group size → (n/g,) shard."""
    if _ring_size(axes, mesh_shape, group) == 1:
        return buf
    return ref.ring_reduce_scatter_ref(buf, group, bidirectional=bidirectional,
                                       accum=_accum(buf.device))


def ring_all_gather(shard: torch.Tensor, axes: tuple[str, ...],
                    mesh_shape: Mapping[str, int],
                    group: dist.ProcessGroup, *,
                    bidirectional: bool = True) -> torch.Tensor:
    """(n/g,) owned shard → (n,) full buffer."""
    if _ring_size(axes, mesh_shape, group) == 1:
        return shard
    return ref.ring_all_gather_ref(shard, group, bidirectional=bidirectional)


def ring_allreduce(buf: torch.Tensor, axes: tuple[str, ...],
                   mesh_shape: Mapping[str, int], group: dist.ProcessGroup, *,
                   bidirectional: bool = True) -> torch.Tensor:
    """Chunked ring allreduce = ring RS → ring AG (pads internally)."""
    g = _ring_size(axes, mesh_shape, group)
    if g == 1:
        return buf
    n = buf.numel()
    pad = (-n) % g
    if pad:
        buf = F.pad(buf, (0, pad))
    shard = ring_reduce_scatter(buf, axes, mesh_shape, group,
                                bidirectional=bidirectional)
    full = ring_all_gather(shard, axes, mesh_shape, group,
                           bidirectional=bidirectional)
    return full[:n] if pad else full


def pod_ring_reduce_scatter(buf: torch.Tensor, group: dist.ProcessGroup,
                            ring: "kernel.PeerRing | None" = None) -> torch.Tensor:
    """Intra-pod bidirectional ring reduce-scatter of a (g·c,) buffer over
    ``group``: rank d of the pod gets chunk d of the sum.  CUDA tensors go
    through ``ring`` (the pod's ``PeerRing``), CPU tensors through the
    plain ring."""
    if dist.get_world_size(group) == 1:
        return buf
    if buf.device.type == "cuda":
        return kernel.ring_reduce_scatter_kernel(_need(ring), buf)
    return ref.ring_reduce_scatter_ref(buf, group)


def pod_ring_all_gather(shard: torch.Tensor, group: dist.ProcessGroup,
                        ring: "kernel.PeerRing | None" = None) -> torch.Tensor:
    """Intra-pod bidirectional ring all-gather of rank d's chunk d → (g·c,)."""
    if dist.get_world_size(group) == 1:
        return shard
    if shard.device.type == "cuda":
        return kernel.ring_all_gather_kernel(_need(ring), shard)
    return ref.ring_all_gather_ref(shard, group)


def _need(ring):
    if ring is None:
        raise ValueError(
            "the intra-pod ring of CUDA tensors runs on a PeerRing (GradSync builds "
            "one per chain for reducer='hierarchical_ring'); none was given")
    return ring

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
chunked, bidirectional rings of ``ref.py``, a ring an axis of the
bucket's reduce axes, each on that axis's communicator of the chain's
``ChainComms``.
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


def _ring_hops(axes: Sequence[str], mesh_shape: Mapping[str, int],
               comms) -> list[tuple[int, dist.ProcessGroup]]:
    """The rings a group over ``axes`` decomposes into, one an axis of
    size > 1 in the given order (the reference's decomposition), each
    with its size and its axis's communicator in ``comms`` (a chain's
    ``core.dependency.ChainComms``)."""
    out = []
    for a, g in _ring_axes(axes, mesh_shape):
        comm = comms.get((a,))
        if dist.get_world_size(comm) != g:
            raise ValueError(f"axis {a!r} makes a ring of {g}, the communicator "
                             f"holds {dist.get_world_size(comm)} ranks")
        out.append((g, comm))
    return out


def _accum(device: torch.device):
    """The per-hop combine of every direction's pair for tensors on
    ``device``; on CUDA one launch that adds into the received buffers."""
    if device.type == "cuda":
        return kernel.ring_accum_pairs_kernel
    return ref.ring_accum_pairs_ref


def ring_reduce_scatter(buf: torch.Tensor, axes: tuple[str, ...],
                        mesh_shape: Mapping[str, int], comms, *,
                        bidirectional: bool = True) -> torch.Tensor:
    """(n,) buffer, n divisible by the group size → (n/g,) shard.  A
    group over several axes runs a ring an axis, in order, each on the
    previous one's shard (so the rank at row-major index i of the group
    owns chunk i); every hop's combine is the ring-accumulate kernel."""
    for _, comm in _ring_hops(axes, mesh_shape, comms):
        buf = ref.ring_reduce_scatter_ref(buf, comm, bidirectional=bidirectional,
                                          accum=_accum(buf.device))
    return buf


def ring_all_gather(shard: torch.Tensor, axes: tuple[str, ...],
                    mesh_shape: Mapping[str, int], comms, *,
                    bidirectional: bool = True) -> torch.Tensor:
    """(n/g,) owned shard → (n,) full buffer: the rings of
    ``ring_reduce_scatter`` in the reverse order."""
    for _, comm in reversed(_ring_hops(axes, mesh_shape, comms)):
        shard = ref.ring_all_gather_ref(shard, comm, bidirectional=bidirectional)
    return shard


def ring_allreduce(buf: torch.Tensor, axes: tuple[str, ...],
                   mesh_shape: Mapping[str, int], comms, *,
                   bidirectional: bool = True) -> torch.Tensor:
    """Chunked ring allreduce = ring RS → ring AG (pads internally)."""
    g = 1
    for size, _ in _ring_hops(axes, mesh_shape, comms):
        g *= size
    if g == 1:
        return buf
    n = buf.numel()
    pad = (-n) % g
    if pad:
        buf = F.pad(buf, (0, pad))
    shard = ring_reduce_scatter(buf, axes, mesh_shape, comms,
                                bidirectional=bidirectional)
    full = ring_all_gather(shard, axes, mesh_shape, comms,
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

"""Hierarchical (pod-aware) allreduce — the port of
``repro/core/hierarchical.py``, the paper's three stages (§4.3):

    (1) reduce-scatter over the intra-pod communicator ("data"),
    (2) allreduce of the 1/D shard over the inter-pod one ("pod"),
    (3) all-gather over the intra-pod communicator.

Only 1/D of the gradient bytes cross the inter-pod tier, against all of
them for a flat allreduce over ("pod", "data").  ``use_ring`` runs
stages 1 and 3 on the intra-pod ring (``kernels/collectives/ops.py::
pod_ring_reduce_scatter/pod_ring_all_gather``): on CUDA tensors the
peer-memory ring kernels, on CPU tensors the plain rings over the
intra-pod gloo group.  Stage 2 is an ordinary collective.  Every
collective goes through ``core/dependency.py::collective``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import dependency as dep
from repro_torch.kernels.collectives import ops as coll_ops


def hierarchical_allreduce(buf: torch.Tensor, comm: dep.PodComm, *,
                           use_ring: bool = False) -> torch.Tensor:
    """Three-stage allreduce of a 1-D comm buffer over ``comm``'s pods.

    Pads to a multiple of the intra-pod size, reduces, unpads; returns a
    new tensor (``buf`` itself when the world is one rank).  The work is
    ordered on the current stream: on NCCL and on the peer ring the host
    does not wait for it."""
    intra = dist.get_world_size(comm.intra)
    n = buf.numel()
    pad = (-n) % intra
    if pad:
        buf = F.pad(buf, (0, pad))
    # (1) intra-pod reduce-scatter: rank d of a pod owns chunk d of the pod's sum
    if use_ring:
        shard = coll_ops.pod_ring_reduce_scatter(buf, comm.intra, comm.ring)
    elif intra == 1:
        shard = buf
    else:
        shard = torch.empty(buf.numel() // intra, dtype=buf.dtype, device=buf.device)
        dep.collective(dist.reduce_scatter_tensor, comm.intra, shard, buf).wait()
    # (2) inter-pod allreduce of the shard only (1/intra of the bytes)
    if dist.get_world_size(comm.inter) > 1:
        dep.collective(dist.all_reduce, comm.inter, shard).wait()
    # (3) intra-pod all-gather rebuilds the reduced buffer
    if use_ring:
        full = coll_ops.pod_ring_all_gather(shard, comm.intra, comm.ring)
    elif intra == 1:
        full = shard
    else:
        full = torch.empty(shard.numel() * intra, dtype=shard.dtype,
                           device=shard.device)
        dep.collective(dist.all_gather_into_tensor, comm.intra, full, shard).wait()
    return full[:n] if pad else full


def flat_allreduce(buf: torch.Tensor, group: dist.ProcessGroup):
    """Single-stage allreduce over every rank of ``group`` (the
    paper-faithful primitive), in place; returns the collective's work."""
    return dep.collective(dist.all_reduce, group, buf)

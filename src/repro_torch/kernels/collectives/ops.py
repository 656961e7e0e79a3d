"""Fused comm staging: the public API (``repro/kernels/collectives/ops.py``).

``fused_pack``/``fused_unpack`` stage one bucket in one pass each way:
on CUDA tensors through the hand-written kernels (``kernel.py``), on CPU
tensors through their plain versions (``ref.py``).  The device of the
tensors decides; a CUDA tensor never reaches the plain version here.
The reference's ``xla`` tier has no counterpart.

Buckets holding a dtype the kernels do not take (``staging_supported``
is False: integer or complex leaves) never come here — the emitter
stages them leafwise, as the reference does.
"""
from __future__ import annotations

from typing import Sequence

import torch

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
               scale: float = 1.0) -> torch.Tensor:
    """CopyFromTo(g, comm_buf), fused: one staging pass over the bucket.

    ``bucket``: a ``repro_torch.core.buckets.Bucket``; ``flat_leaves``:
    the flat gradient list it indexes into.  ``scale`` is the optional
    loss-scale folded into the cast.
    """
    leaves = [flat_leaves[l.index] for l in bucket.leaves]
    if _device_of(leaves).type == "cuda":
        return kernel.pack_bucket_kernel(leaves, comm_dtype, scale=scale)
    return ref.leafwise_pack(leaves, comm_dtype, scale=scale)


def fused_unpack(bucket, buf: torch.Tensor, flat_out: list[torch.Tensor], *,
                 scale: float = 1.0) -> None:
    """CopyFromTo(recv_buf, g), fused: write the reduced buffer back into
    the bucket's leaves of ``flat_out`` (cast back + inverse loss-scale in
    the same pass).  The leaves are written in place, so each
    ``flat_out[l.index]`` must be a contiguous tensor of the leaf's shape
    and dtype on ``buf``'s device."""
    outs = [flat_out[l.index] for l in bucket.leaves]
    for l, t in zip(bucket.leaves, outs):
        if tuple(t.shape) != l.shape or t.dtype != l.dtype:
            raise ValueError(
                f"leaf {l.name}: target is {tuple(t.shape)} {t.dtype}, the "
                f"plan says {l.shape} {l.dtype}")
    if _device_of([buf, *outs]).type == "cuda":
        kernel.unpack_bucket_kernel(buf, outs, scale=scale)
        return
    pieces = ref.leafwise_unpack(buf, [l.size for l in bucket.leaves],
                                 [l.dtype for l in bucket.leaves], scale=scale)
    for t, piece in zip(outs, pieces):
        t.view(-1).copy_(piece)

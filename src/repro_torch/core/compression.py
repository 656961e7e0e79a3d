"""Compressed gradient allreduce — the port of ``repro/core/compression.py``.

int8 block-quantized allreduce with error feedback, per block of 256
elements (scale = max|g|/127), in the reference's two-phase scheme:

  quantize the whole buffer → ``all_to_all_single`` of the int8 shards
  and of their scales (rank r receives every peer's shard r) → dequantize
  and sum the g shards locally, in peer order → requantize the reduced
  shard → all-gather the int8 shards and scales (``all_gather_into_tensor``,
  or the ring all-gather for ``use_ring``) → dequantize.

Wire bytes: 2 × size × 1 byte against 2 × size × 4 bytes in f32.  The
quantize and dequantize steps run through ``repro_torch.kernels.quantize``:
the hand-written CUDA kernels on the card, their plain versions on the
CPU, bit for bit alike and alike to the reference's jnp math compiled.
Phase 1 quantizes the bucket as it is, read as if zero-padded to a
multiple of 256 × g (``quantize_blocks(buf, pad_to=m)``): no padded copy
is made.  Phases 2 and 3 are one call a bucket,
``dequantize_sum_quantize_blocks`` (one launch on the card): the peer sum
is quantized where it is made and never reaches device memory, bit for
bit the quantize of what ``dequantize_sum_blocks`` computes.  With
``inter`` (the reference's ``inter_axes``, reached from the in-backward
sync of ``core/overlap.py`` on a pod mesh) the reduced shard is summed in
f32 over that group between the two phases, so phases 2 and 3 are then
the peer sum, the ``inter`` all-reduce and a quantize.  Every collective
goes through ``core/dependency.py::collective``.

Rounding: the peer sum adds dequantized shards, each product rounded
once before its add.  XLA's CPU build of the reference fuses the
dequantize into the sum as fused multiply-adds, so the two differ by
less than one quantization step in some elements
(``tests/test_torch_compression.py`` models both).

Deviation, in transport only: the reference's ``use_ring`` takes the ring
only for a one-axis ``axes``; here it takes it whenever one axis of the
group has a size above 1 (the data-parallel ("data", "model") buckets at
model = 1).  The gather moves int8 values and scales unchanged either
way, so the result is the same.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import dependency as dep
from repro_torch.kernels.collectives import ops as coll_ops
from repro_torch.kernels.quantize import (dequantize_blocks, dequantize_sum_blocks,
                                          dequantize_sum_quantize_blocks, quantize_blocks)

BLOCK = 256


def _pad_to(x: torch.Tensor, mult: int) -> tuple[torch.Tensor, int]:
    pad = (-x.shape[0]) % mult
    if pad:
        x = F.pad(x, (0, pad))
    return x, pad


# the reference's names: x (n,) f32 → (q int8 (n,), scales f32 (n/BLOCK,)), and back
quantize_blockwise = quantize_blocks
dequantize_blockwise = dequantize_blocks


def compressed_allreduce(buf: torch.Tensor, axes: tuple[str, ...],
                         mesh_shape: Mapping[str, int],
                         comms: dep.ChainComms, *,
                         use_ring: bool = False,
                         inter: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Quantized allreduce of ``buf`` over the ranks of ``axes`` (their
    communicator in ``comms``, a chain's ``ChainComms``), and then over
    ``inter`` (the other pods' ranks of the same data index) if given.
    Falls back to a flat sum when the buffer is too small to shard.  f32
    only: the reference computes in the comm dtype, the kernels take
    f32."""
    if buf.dtype != torch.float32:
        raise NotImplementedError(
            f"compressed allreduce of a {buf.dtype} comm buffer: the int8 "
            f"kernels take f32 (ROADMAP queue 1 item 7)")
    group = comms.get(axes)
    g = coll_ops.group_size(axes, mesh_shape)
    n = buf.shape[0]
    m = -(-n // (BLOCK * g)) * BLOCK * g           # the buffer padded to 256 · g
    if m < BLOCK * g:
        dep.collective(dist.all_reduce, group, buf).wait()
        return buf

    # phase 1: every rank quantizes its local gradient (read as zero-padded
    # to m), shards go to owners
    q, s = quantize_blockwise(buf, pad_to=m)
    q_recv = torch.empty_like(q)                   # (g · m/g,) int8
    s_recv = torch.empty_like(s)
    dep.collective(dist.all_to_all_single, group, q_recv, q).wait()
    dep.collective(dist.all_to_all_single, group, s_recv, s).wait()
    # phases 2 and 3: dequantize each peer's shard, sum them in peer order
    # and requantize the reduced shard, in one call; then all-gather
    if inter is None:
        q2, s2 = dequantize_sum_quantize_blocks(q_recv, s_recv, g)   # (m/g,) int8
    else:
        # hierarchical-compressed: the f32 shard crosses the pods, 1/g of the bytes
        red = dequantize_sum_blocks(q_recv, s_recv, g)
        dep.collective(dist.all_reduce, inter, red).wait()
        q2, s2 = quantize_blocks(red)
    if use_ring and len(coll_ops._ring_axes(axes, mesh_shape)) == 1:
        q_all = coll_ops.ring_all_gather(q2, axes, mesh_shape, comms)
        s_all = coll_ops.ring_all_gather(s2, axes, mesh_shape, comms)
    else:
        q_all = q2.new_empty(m)
        s_all = s2.new_empty(m // BLOCK)
        dep.collective(dist.all_gather_into_tensor, group, q_all, q2).wait()
        dep.collective(dist.all_gather_into_tensor, group, s_all, s2).wait()
    out = dequantize_blockwise(q_all, s_all)
    return out[:n] if m != n else out


def error_feedback_step(grad: torch.Tensor, residual: torch.Tensor, sync_fn
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """g' = sync(g + r); r' = (g + r) - dequant-roundtrip(g + r)."""
    corrected = grad + residual
    synced = sync_fn(corrected)
    q, s = quantize_blockwise(_pad_to(corrected, BLOCK)[0])
    approx = dequantize_blockwise(q, s)[: corrected.shape[0]]
    return synced, corrected - approx

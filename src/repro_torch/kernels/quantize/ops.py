"""int8 block quantize / dequantize on 1-D buffers: the public API
(``repro/kernels/quantize/ops.py``), in the comm-buffer layout the
compressed reducer uses.

On CUDA tensors each launches its hand-written kernel (``kernel.py``); on
CPU tensors it runs the plain version (``ref.py``).  The device of the
tensors decides; a CUDA tensor never reaches the plain version here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import kernel, ref
from repro_torch.kernels.quantize.kernel import BLOCK


def quantize_blocks(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """buf: (n,) f32, n % 256 == 0 → (q (n,) int8, scales (n/256,) f32)."""
    if buf.dim() != 1 or buf.numel() % BLOCK:
        raise ValueError(f"expected a 1-D buffer of a multiple of {BLOCK} "
                         f"elements, got {tuple(buf.shape)}")
    x = buf.reshape(-1, BLOCK)
    if x.device.type == "cuda":
        q, s = kernel.quantize_blocks_kernel(x)
    else:
        q, s = ref.quantize_ref(x)
    return q.reshape(-1), s


def dequantize_blocks(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q: (n,) int8, s: (n/256,) f32 → (n,) f32."""
    if q.device != s.device:
        raise ValueError(f"q is on {q.device}, scales on {s.device}")
    qb = q.reshape(-1, BLOCK)
    if qb.device.type == "cuda":
        x = kernel.dequantize_blocks_kernel(qb, s)
    else:
        x = ref.dequantize_ref(qb, s)
    return x.reshape(-1)


def dequantize_sum_blocks(q: torch.Tensor, s: torch.Tensor, g: int) -> torch.Tensor:
    """The compressed reducer's phase 2: q (n,) int8 and s (n/256,) f32,
    the shards of g peers back to back (n % (256·g) == 0) → (n/g,) f32,
    the peers' dequantized shards summed in peer order."""
    if q.device != s.device:
        raise ValueError(f"q is on {q.device}, scales on {s.device}")
    if q.dim() != 1 or q.numel() % (BLOCK * g):
        raise ValueError(f"expected a 1-D buffer of a multiple of {BLOCK} x {g} "
                         f"elements, got {tuple(q.shape)}")
    qg, sg = q.reshape(g, -1), s.reshape(g, -1)
    if q.device.type == "cuda":
        return kernel.dequantize_sum_blocks_kernel(qg, sg)
    return ref.dequantize_sum_ref(qg, sg)

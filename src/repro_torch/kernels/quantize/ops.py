"""int8 block quantize / dequantize on 1-D buffers: the public API
(``repro/kernels/quantize/ops.py``), in the comm-buffer layout the
compressed reducer uses.

On CUDA tensors each launches its hand-written kernel (``kernel.py``); on
CPU tensors it runs the plain version (``ref.py``).  The device of the
tensors decides; a CUDA tensor never reaches the plain version here.
The compressed reducer calls ``quantize_blocks(buf, pad_to=m)`` for
phase 1 (the unpadded bucket) and ``dequantize_sum_quantize_blocks`` for
phases 2 and 3 (one launch a bucket); ``dequantize_sum_blocks`` is
phase 2 alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import kernel, ref
from repro_torch.kernels.quantize.kernel import BLOCK


def quantize_blocks(buf: torch.Tensor, *, pad_to: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """buf: (n,) f32 → (q (m,) int8, scales (m/256,) f32), m = ``pad_to``
    (a multiple of 256, at least n), buf read as zero-padded to m; without
    ``pad_to``, m = n and n % 256 == 0.  The kernel reads buf as it is: no
    padded copy is made on the card, so a CUDA buf must be contiguous and
    16-byte aligned (the kernel refuses any other)."""
    m = buf.numel() if pad_to is None else pad_to
    if buf.dim() != 1 or m % BLOCK or m < buf.numel():
        raise ValueError(f"expected a 1-D buffer of a multiple of {BLOCK} "
                         f"elements, or of at most pad_to = {pad_to} (a multiple of "
                         f"{BLOCK}), got {tuple(buf.shape)}")
    if buf.device.type == "cuda":
        return kernel.quantize_blocks_kernel(buf, n_blocks=m // BLOCK)
    q, s = ref.quantize_ref(ref.zero_padded(buf, m).reshape(-1, BLOCK))
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


def dequantize_sum_quantize_blocks(q: torch.Tensor, s: torch.Tensor, g: int
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The compressed reducer's phases 2 and 3: q (n,) int8 and s (n/256,)
    f32, the shards of g peers back to back (n % (256·g) == 0) → (q2
    (n/g,) int8, s2 (n/(256·g),) f32), the quantize of the peers'
    dequantized shards summed in peer order."""
    if q.device != s.device:
        raise ValueError(f"q is on {q.device}, scales on {s.device}")
    if q.dim() != 1 or q.numel() % (BLOCK * g):
        raise ValueError(f"expected a 1-D buffer of a multiple of {BLOCK} x {g} "
                         f"elements, got {tuple(q.shape)}")
    qg, sg = q.reshape(g, -1), s.reshape(g, -1)
    if q.device.type == "cuda":
        return kernel.dequantize_sum_quantize_blocks_kernel(qg, sg)
    return ref.dequantize_sum_quantize_ref(qg, sg)

"""Plain PyTorch versions of the int8 block kernels
(``repro/kernels/quantize/ref.py``).

Per block of 256 f32 elements: scale = amax/127 (1 when amax = 0),
q = clip(round(x/scale), ±127) as int8; dequantize is q·scale.  The
peer sum dequantizes g peers' shards and adds them in peer order, each
product and each add rounded once (the compressed reducer's phase 2);
the sum-requantize quantizes that sum (phases 2 and 3).  The quantize of
an unpadded buffer, which the CUDA kernel reads as if zero-padded, is
``quantize_ref`` of the zero-padded buffer (``zero_padded``).

The reference writes ``amax / 127.0``, and compiled — the Pallas kernel,
and the compressed reducer inside the jitted train step — XLA rewrites a
division by a constant as a product with the constant's f32 reciprocal,
which differs from the division in the last bit for a few percent of
blocks.  The port keeps the compiled arithmetic: ``amax * INV_127``.
``x / scale`` is an IEEE division on both sides and ``torch.round``
rounds half to even, as ``jnp.round`` does, so q, the scales and the
dequantized values equal the compiled reference's bit for bit.  These
are what ``ops.quantize_blocks``/``dequantize_blocks``/
``dequantize_sum_blocks``/``dequantize_sum_quantize_blocks`` run for
tensors on the CPU and the oracle the CUDA kernels are held against on
the card.
"""
from __future__ import annotations

import torch

INV_127 = 0.007874015718698502   # 1/127 rounded to f32, exact as a Python float


def quantize_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n_blocks, 256) f32 → (int8 same shape, scales (n_blocks,) f32)."""
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q: (n_blocks, 256) int8, s: (n_blocks,) f32 → (n_blocks, 256) f32."""
    return q.to(torch.float32) * s[:, None]


def dequantize_sum_ref(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q: (g, k·256) int8, s: (g, k) f32, row p peer p's shard → (k·256,)
    f32: ``dequantize_ref`` of every shard, then the shards added in peer
    order."""
    deq = dequantize_ref(q.reshape(-1, 256), s.reshape(-1)).reshape(q.shape[0], -1)
    red = deq[0]
    for j in range(1, q.shape[0]):
        red = red + deq[j]
    return red


def dequantize_sum_quantize_ref(q: torch.Tensor, s: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (g, k·256) int8, s: (g, k) f32, row p peer p's shard → (q2
    (k·256,) int8, s2 (k,) f32): ``quantize_ref`` of ``dequantize_sum_ref``."""
    q2, s2 = quantize_ref(dequantize_sum_ref(q, s).view(-1, 256))
    return q2.reshape(-1), s2


def zero_padded(buf: torch.Tensor, m: int) -> torch.Tensor:
    """buf (n,) → (m,), m ≥ n: buf, then zeros (a new tensor when m > n)."""
    if m == buf.numel():
        return buf
    out = buf.new_zeros(m)
    out[:buf.numel()] = buf
    return out

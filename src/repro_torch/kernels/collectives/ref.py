"""Plain PyTorch versions of the staging kernels.

``leafwise_pack``/``leafwise_unpack`` are ``repro/kernels/collectives/
ref.py``'s per-leaf staging in torch: per-leaf ravel + cast (with the
optional loss-scale multiplied in f32 before the cast), one concatenate;
per-leaf slice + cast back.  They are what ``ops.fused_pack``/
``fused_unpack`` run for tensors on the CPU, the oracle the CUDA kernels
are held against on the card, and the path for buckets the kernels do
not take (non-float dtypes).
"""
from __future__ import annotations

from typing import Sequence

import torch


def leafwise_pack(leaves: Sequence[torch.Tensor], comm_dtype, *,
                  scale: float = 1.0) -> torch.Tensor:
    """Per-leaf cast + concatenate (the paper's CopyFromTo)."""
    parts = []
    for x in leaves:
        x = x.reshape(-1)
        if scale != 1.0:
            x = x.to(torch.float32) * scale
        parts.append(x.to(comm_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def leafwise_unpack(buf: torch.Tensor, sizes: Sequence[int], dtypes, *,
                    scale: float = 1.0) -> list[torch.Tensor]:
    """Per-leaf slice + cast back (1-D pieces, caller reshapes)."""
    out = []
    off = 0
    for n, dt in zip(sizes, dtypes):
        x = buf[off:off + n]
        if scale != 1.0:
            x = x.to(torch.float32) * scale
        out.append(x.to(dt))
        off += n
    return out

"""The RWKV-6 WKV chunk: the public API (``repro/kernels/rwkv6/ops.py``).

``wkv_chunk`` takes the reference's ``(B, C, H, N)`` layout;
``wkv_chunk_rows`` the kernel's flat ``(BH, C, N)`` one, which the model's
chunk loop already holds.  On CUDA tensors both launch the hand-written
kernel (``kernel.py``); on CPU tensors they run the plain version
(``ref.py``).  The device of the tensors decides; a CUDA tensor never
reaches the plain version here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import kernel, ref


def wkv_chunk_rows(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """r, k, v, logw: (BH, C, N), row bh = b·H + h; u: (H, N); state:
    (BH, N, N) → (y (BH, C, N) f32, new state (BH, N, N) f32)."""
    devices = {t.device for t in (r, k, v, logw, u, state)}
    if len(devices) != 1:
        raise ValueError(f"WKV inputs span devices {sorted(map(str, devices))}")
    if r.shape[0] % u.shape[0]:
        raise ValueError(f"{r.shape[0]} rows do not cycle over {u.shape[0]} heads")
    logw, u, state = logw.float(), u.float(), state.float()
    if r.device.type == "cuda":
        return kernel.wkv_chunk_kernel(r, k, v, logw, u, state)
    return ref.wkv_chunk_rows_ref(r, k, v, logw, u, state)


def wkv_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """One WKV chunk.  r, k, v, logw: (B, C, H, N); u: (H, N); state:
    (B, H, N, N) → (y (B, C, H, N) f32, new state (B, H, N, N) f32)."""
    B, C, H, N = r.shape

    def rows(t):   # a copy: at B 1 the reshape is a strided view
        return t.transpose(1, 2).reshape(B * H, C, N).contiguous()

    y, s1 = wkv_chunk_rows(rows(r), rows(k), rows(v), rows(logw), u,
                           state.reshape(B * H, N, N))
    return y.reshape(B, H, C, N).transpose(1, 2), s1.reshape(B, H, N, N)

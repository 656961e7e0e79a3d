"""The RWKV-6 WKV: the public API (``repro/kernels/rwkv6/ops.py``).

``wkv_sequence`` is a whole layer's WKV on the model's ``(B, S, H, N)``
layout, in chunks (what ``models/rwkv.py::wkv_chunked`` calls, once a
layer).  ``wkv_chunk`` is one chunk on the reference's ``(B, C, H, N)``
layout; ``wkv_chunk_rows`` one chunk on the TPU kernel's flat
``(BH, C, N)`` one.  On CUDA tensors each launches the hand-written
kernel (``kernel.py``: one launch a call); on CPU tensors each runs the
plain version (``ref.py``).  The device of the tensors decides; a CUDA
tensor never reaches the plain version here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import kernel, ref


def _one_device(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"WKV inputs span devices {sorted(map(str, devices))}")
    return devices.pop()


def wkv_sequence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, chunk: int,
                 out: torch.Tensor | None = None):
    """One layer's WKV in chunks of C = min(chunk, S).  r, k, v, logw:
    (B, S, H, N) (logw ≤ 0); u: (H, N); state: (B, H, N, N) → (y (B, S, H,
    N) in r's dtype, final state (B, H, N, N) f32).  The final state goes
    to ``out`` where given (an f32 tensor of the state's shape; it may be
    ``state`` itself), else to a new tensor."""
    device = _one_device(r, k, v, logw, u, state)
    logw, u, state = logw.float(), u.float(), state.float()
    if device.type == "cuda":
        return kernel.wkv_sequence_kernel(r, k, v, logw, u, state, chunk, out=out)
    return ref.wkv_sequence_ref(r, k, v, logw, u, state, chunk, out=out)


def wkv_chunk_rows(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """r, k, v, logw: (BH, C, N), row bh = b·H + h; u: (H, N); state:
    (BH, N, N) → (y (BH, C, N) f32, new state (BH, N, N) f32)."""
    device = _one_device(r, k, v, logw, u, state)
    if r.shape[0] % u.shape[0]:
        raise ValueError(f"{r.shape[0]} rows do not cycle over {u.shape[0]} heads")
    logw, u, state = logw.float(), u.float(), state.float()
    if device.type == "cuda":
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

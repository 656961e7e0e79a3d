"""Flash attention: the public API (``repro/kernels/flash_attention/ops.py``).

``flash_attention`` takes the GQA layout the model uses.  On CUDA tensors
it launches the hand-written kernel (``kernel.py``), which reads the kv
head of each q head in place; on CPU tensors it runs the plain version
(``ref.py``).  The device of the tensors decides; a CUDA tensor never
reaches the plain version here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) → (B, S, Hq, D)."""
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v span devices {sorted(map(str, devices))}")
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, causal=causal)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} q heads do not group over "
                         f"{k.shape[2]} kv heads")
    return ref.flash_attention_ref(q, k, v, causal=causal)

"""Flash attention: the public API (``repro/kernels/flash_attention/ops.py``).

``flash_attention`` takes the GQA layout the model uses.  On CUDA tensors
it launches the hand-written kernel (``kernel.py``), which reads the kv
head of each q head in place; on CPU tensors it runs the plain version
(``ref.py``).  The device of the tensors decides; a CUDA tensor never
reaches the plain version here.

Neither the Pallas kernel nor its port has a backward, so a call whose
inputs need a gradient is refused before any launch: the kernel's output
would carry no ``grad_fn`` and silently cut the attention gradient.
Training runs the chunked path (``models/attention.py``, ``use_flash``
off).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) → (B, S, Hq, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward: run it under torch.no_grad() or on "
            "inputs that need no gradient, and train with use_flash=False (the "
            "chunked attention)")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v span devices {sorted(map(str, devices))}")
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, causal=causal)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} q heads do not group over "
                         f"{k.shape[2]} kv heads")
    return ref.flash_attention_ref(q, k, v, causal=causal)

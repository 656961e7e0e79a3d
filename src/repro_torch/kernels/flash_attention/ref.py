"""Plain-torch oracle for the flash-attention kernel
(``repro/kernels/flash_attention/ref.py``): what ``ops.flash_attention``
runs on CPU tensors, and what ``chip_smoke.py`` holds the CUDA kernel
against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, D) → (BH, S, D); f32 math, dense softmax, masked
    scores set to −1e30."""
    _, S, D = q.shape
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    return o.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """``attention_ref`` on the GQA layout of ``ops.flash_attention``:
    q (B, S, Hq, D), k/v (B, S, Hkv, D) → (B, S, Hq, D), with the kv heads
    repeated to the q heads as the JAX package's ``ops.py`` does."""
    B, S, Hq, D = q.shape
    rep = Hq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    def heads_first(t):
        return t.transpose(1, 2).reshape(B * Hq, S, D)

    o = attention_ref(heads_first(q), heads_first(k), heads_first(v),
                      causal=causal)
    return o.reshape(B, Hq, S, D).transpose(1, 2)

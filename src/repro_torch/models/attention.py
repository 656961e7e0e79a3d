"""Attention (``repro/models/attention.py``): the chunked online-softmax
path, the flash-kernel dispatch, and single-token decode against a KV
cache.

Both paths here are plain torch, as the reference computes them outside
any Pallas kernel.  ``attention`` hands a causal, windowless,
full-length call to ``repro_torch.kernels.flash_attention`` when
``use_flash`` is set — exactly the reference's condition — and runs the
chunked path otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int], kv_len) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        m &= k_pos[None, :] < kv_len
    return m


def _scale(D: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32, device=device))


def attention(
    q: torch.Tensor,                 # (B, Sq, Hq, D)
    k: torch.Tensor,                 # (B, Sk, Hkv, D)
    v: torch.Tensor,                 # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    chunk: int = 1024,
    use_flash: bool = False,
) -> torch.Tensor:
    """Grouped-query attention with online softmax over KV chunks.

    ``q_offset``: absolute position of q[0].  ``kv_len``: number of valid
    kv positions.  Returns (B, Sq, Hq, D) in q's dtype.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    rep = Hq // Hkv

    if use_flash and causal and window is None and kv_len is None and Sq == Sk:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=True)

    qf = (q.float() * _scale(D, q.device)).reshape(B, Sq, Hkv, rep, D)
    q_pos = q_offset + torch.arange(Sq, dtype=torch.int32, device=q.device)

    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = min(kv_len if kv_len is not None else Sk, Sk)
    else:
        kv_valid = kv_len

    acc = torch.zeros((B, Sq, Hkv, rep, D), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, Sq, Hkv, rep), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, Sq, Hkv, rep), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk].float()
        vci = v[:, ci * chunk:(ci + 1) * chunk].float()
        k_pos = ci * chunk + torch.arange(chunk, dtype=torch.int32, device=q.device)
        s = torch.einsum("bqhrd,bchd->bqhrc", qf, kci)
        msk = _mask(q_pos, k_pos, causal, window, kv_valid)
        s = torch.where(msk[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhrc,bchd->bqhrd", p, vci)
        acc = acc * corr[..., None] + pv
        m_run = m_new
    l_safe = torch.where(l_run > 0, l_run, 1.0)
    out = acc / l_safe[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # (B, 1, Hq, D)
    k_cache: torch.Tensor,      # (B, Smax, Hkv, D)
    v_cache: torch.Tensor,
    kv_len,                     # valid cache length (incl. the new token):
    #                             an int (shared) or a (B,) tensor (the
    #                             paged path, every slot at its own position)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode: dense masked attention over the cache (the
    score row is (B, Hq, Smax) — small; no chunking needed)."""
    B, _, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    rep = Hq // Hkv
    qf = (q.float() * _scale(D, q.device)).reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bshd->bhrs", qf, k_cache.float())
    pos = torch.arange(Smax, dtype=torch.int32, device=q.device)
    if not isinstance(kv_len, torch.Tensor) or kv_len.dim() == 0:
        valid = pos < kv_len
        if window is not None:
            valid &= pos > (kv_len - 1) - window
        valid = valid[None, None, None, :]
    else:
        valid = pos[None, :] < kv_len[:, None]          # (B, Smax)
        if window is not None:
            valid &= pos[None, :] > (kv_len[:, None] - 1) - window
        valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrs,bshd->bhrd", p, v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)

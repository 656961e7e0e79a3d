"""Plain-torch versions of the RWKV-6 WKV
(``repro/kernels/rwkv6/kernel.py::_wkv_kernel`` and ``ref.py``, and the
scan of ``repro/models/rwkv.py::wkv_chunked``).

``wkv_chunk_ref`` is the chunk math of the TPU kernel, with its factored
exponentials (``r·exp(Lprev)`` times ``k·exp(−L)``, not
``exp(Lprev − L)``), on the TPU kernel's layout, in float64 rounded once
to f32; ``wkv_chunk_rows_ref`` takes the CUDA kernel's (u per head).
``wkv_sequence_ref`` is a whole layer's WKV on the model's
``(B, S, H, N)`` layout: the sequence zero-padded to whole chunks and
``wkv_chunk_rows_ref`` run over them in order, the state rounded to f32
between chunks, y in r's dtype.  These are what ``ops`` runs on CPU
tensors and what ``chip_smoke.py`` holds the CUDA kernel against on the
card.  ``wkv_ref`` is the step-by-step recurrence, a second oracle for
the tests.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG2E = 1.0 / math.log(2.0)


def wkv_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """r, k, v, logw: (BH, C, N); u: (BH, 1, N); state: (BH, N, N).
    Returns (y (BH, C, N) f32, new state (BH, N, N) f32).

    The math runs in float64 and is rounded once to f32, and each
    exponential is taken as ``exp2(x · log2 e)``.  Two reasons, both about
    the same result in every process:

    - The factored form cancels large terms: ``exp(−L)`` reaches several
      hundred within a chunk, so an error in one factor comes out about
      100× larger in ``y``.  In float64 the f32 result is correct to its
      last bits whatever order the products are summed in.
    - ``torch.exp`` on a CPU tensor is MKL's VML (``vsExp``/``vdExp``,
      called per 2048-element grain on every OpenMP thread).  In some
      processes the first such call runs one thread's grain at reduced
      accuracy (1.5e-4 relative in f32, 3.3e-9 in float64), and ``y``
      then moves by up to 4e-3 in f32.  ``torch.exp2`` is ATen's own
      vectorised code, the same in every process; the product with
      log2 e costs float64 nothing that shows in f32.
    """
    r, k, v, lw, u, s0 = (t.double() for t in (r, k, v, logw, u, state))

    def exp(x):
        return torch.exp2(x * _LOG2E)

    C = r.shape[1]
    L = torch.cumsum(lw, dim=1)
    Lprev = L - lw
    r_dec = r * exp(Lprev)
    y = r_dec @ s0                                        # inter-chunk read
    att = r_dec @ (k * exp(-L)).transpose(1, 2)           # intra-chunk scores
    mask = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    att = torch.where(mask, att, 0.0)
    diag = (r * (u * k)).sum(dim=2)                       # bonus
    y = y + att @ v
    y = y + diag[:, :, None] * v
    wc = L[:, C - 1]                                      # (BH, N)
    k_dec = k * exp(wc[:, None, :] - L)
    s1 = s0 * exp(wc)[:, :, None] + k_dec.transpose(1, 2) @ v
    return y.float(), s1.float()


def wkv_chunk_rows_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """``wkv_chunk_ref`` with u given per head, (H, N), as the CUDA kernel
    takes it: row bh = b·H + h reads u[h]."""
    BH, _, N = r.shape
    H = u.shape[0]
    return wkv_chunk_ref(r, k, v, logw, u[None].expand(BH // H, H, N).reshape(BH, 1, N),
                         state)


def wkv_sequence_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                     chunk: int, out: torch.Tensor | None = None,
                     states: torch.Tensor | None = None):
    """One layer's WKV in chunks of C = min(chunk, S).  r, k, v, logw:
    (B, S, H, N) (logw ≤ 0); u: (H, N); state: (B, H, N, N) [state[b, h,
    i, j] ~ k-dim i, v-dim j].  Returns (y (B, S, H, N) in r's dtype, the
    final state (B, H, N, N) f32, copied into ``out`` where given).
    ``states`` (T, B, H, N, N) f32, where given, gets the state each of the
    T chunks starts from."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        # zero-pad: k = 0 adds nothing to the state; logw = 0 (w = 1)
        # leaves the decay product unchanged — exact for the valid positions
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    T = (S + pad) // C

    def chunks(t):                     # (T, B, H, C, N): chunk i is (BH, C, N)
        out = torch.empty((T, B, H, C, N), dtype=torch.float32, device=t.device)
        return out.copy_(t.reshape(B, T, C, H, N).permute(1, 0, 3, 2, 4))

    rc, kc, vc, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    st = state.float().reshape(B * H, N, N)
    u = u.float()
    ys = []
    for i in range(T):
        if states is not None:
            states[i].copy_(st.view(B, H, N, N))
        y, st = wkv_chunk_rows_ref(
            rc[i].view(B * H, C, N), kc[i].view(B * H, C, N),
            vc[i].view(B * H, C, N), lw[i].view(B * H, C, N), u, st)
        ys.append(y.view(B, H, C, N))
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T * C, H, N)
    st = st.view(B, H, N, N)
    return y[:, :S].to(r.dtype), st if out is None else out.copy_(st)


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """Step-by-step recurrence.  r, k, v, logw: (BH, C, N); u: (BH, 1, N);
    state: (BH, N, N).  Returns (y (BH, C, N) f32, final state)."""
    r, k, v, lw = (t.float() for t in (r, k, v, logw))
    u = u.float()[:, 0]
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], lw[:, t]
        # y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
        kv = kt[:, :, None] * vt[:, None, :]
        ys.append(torch.einsum("bn,bnm->bm", rt, S + u[:, :, None] * kv))
        S = S * torch.exp(lwt)[:, :, None] + kv
    return torch.stack(ys, dim=1), S

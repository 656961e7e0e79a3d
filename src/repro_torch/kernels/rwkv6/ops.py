"""The RWKV-6 WKV: the public API (``repro/kernels/rwkv6/ops.py``).

``wkv_sequence`` is a whole layer's WKV on the model's ``(B, S, H, N)``
layout, in chunks (what ``models/rwkv.py::wkv_chunked`` calls, once a
layer).  ``wkv_chunk`` is one chunk on the reference's ``(B, C, H, N)``
layout; ``wkv_chunk_rows`` one chunk on the TPU kernel's flat
``(BH, C, N)`` one.  On CUDA tensors each launches the hand-written
kernel (``kernel.py``: one launch a call); on CPU tensors each runs the
plain version (``ref.py``).  The device of the tensors decides; a CUDA
tensor never reaches the plain version here.

Training: when autograd needs a gradient of an input, ``wkv_sequence``
runs as ``_WKVSequence``, whose forward is the same launch (or plain
version) writing the state each chunk starts from beside y, and whose
backward ports what the reference gets from XLA's autodiff of its
``wkv_chunked`` (``repro/models/rwkv.py:161-216``; the TPU kernel has no
backward and lies on no training path there).  The backward is plain
tensor code on the tensors' device (``wkv_sequence_backward``): every
chunk's body recomputed at once from the saved start states, the state's
cotangent carried back through the chunks as a short linear recurrence,
and one ``torch.autograd.grad`` of the batched body.  On the CPU it runs
in float64 with ``exp2(x · log2 e)``, as ``ref.py`` does and for its
reasons; on the card in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import kernel, ref

_LOG2E = 1.0 / math.log(2.0)


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
    ``state`` itself), else to a new tensor.  With autograd on and an
    input that needs a gradient, the call is differentiable (``out`` must
    then be None)."""
    device = _one_device(r, k, v, logw, u, state)
    logw, u, state = logw.float(), u.float(), state.float()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u, state)):
        if out is not None:
            raise ValueError("wkv_sequence: out= takes no inputs that need a gradient")
        if chunk < 1:
            raise ValueError(f"chunk {chunk} < 1")
        return _WKVSequence.apply(r, k, v, logw, u, state, chunk)
    if device.type == "cuda":
        return kernel.wkv_sequence_kernel(r, k, v, logw, u, state, chunk, out=out)
    return ref.wkv_sequence_ref(r, k, v, logw, u, state, chunk, out=out)


class _WKVSequence(torch.autograd.Function):
    """``wkv_sequence`` with a gradient: the kernel (the plain version on
    the CPU) writes y, the final state and the state each chunk starts
    from; the backward is ``wkv_sequence_backward``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, chunk):
        B, S, H, N = r.shape
        T = -(-S // min(chunk, S))
        states = torch.empty((T, B, H, N, N), dtype=torch.float32, device=r.device)
        if r.device.type == "cuda":
            y, s1 = kernel.wkv_sequence_kernel(r, k, v, logw, u, state, chunk, states=states)
        else:
            y, s1 = ref.wkv_sequence_ref(r, k, v, logw, u, state, chunk, states=states)
        ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.chunk = chunk
        return y, s1

    @staticmethod
    def backward(ctx, dy, ds1):
        r, k, v, logw, u, states = ctx.saved_tensors
        return (*wkv_sequence_backward(r, k, v, logw, u, states, dy, ds1, ctx.chunk), None)


def _exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x * _LOG2E)


def chunks_body(r, k, v, logw, u, s0):
    """Every chunk's WKV at once (the reference's scan body, batched):
    r, k, v, logw (..., H, C, N); u (H, N); s0 (..., H, N, N) the state
    each chunk starts from.  Returns (y (..., H, C, N), the state each
    chunk ends with, r·exp(Lprev) and exp(wc)).  The log-decay's running
    sum is a product with a triangle of ones (a cumsum on the card has no
    deterministic kernel)."""
    C = r.shape[-2]
    ones = torch.ones(C, C, dtype=torch.bool, device=r.device)
    L = ones.tril().to(r.dtype) @ logw                     # log ∏_{s<=t} w_s
    r_dec = r * _exp(L - logw)
    att = r_dec @ (k * _exp(-L)).transpose(-1, -2)
    att = torch.where(ones.tril(-1), att, 0.0)             # s < t only
    diag = (r * (u[:, None, :] * k)).sum(-1, keepdim=True)    # bonus
    y = r_dec @ s0 + att @ v + diag * v
    wc = L[..., -1:, :]
    ewc = _exp(wc)
    s1 = s0 * ewc.transpose(-1, -2) + (k * _exp(wc - L)).transpose(-1, -2) @ v
    return y, s1, r_dec, ewc


def wkv_sequence_backward(r, k, v, logw, u, states, dy, ds1, chunk: int):
    """The gradients of ``wkv_sequence`` (r, k, v, logw, u and the initial
    state) from the cotangents of y (B, S, H, N) and of the final state
    (B, H, N, N), given ``states`` (T, B, H, N, N), the state each chunk
    started from in the forward.  S is padded to whole chunks with
    zeros as the reference pads (``rwkv.py:169-179``); the padded rows'
    gradients are dropped.  In float64 on the CPU, f32 on the card."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    T = states.shape[0]
    pad = T * C - S
    dt = torch.float64 if r.device.type == "cpu" else torch.float32

    def chunked(t):                    # (B, S, H, N) -> (T, B, H, C, N)
        t = t.to(dt)
        if pad:
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, T, C, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lw, dyc = (chunked(t) for t in (r, k, v, logw, dy))
    s0 = states.to(dt)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (rc, kc, vc, lw, u.to(dt))]
        y, s1, r_dec, ewc = chunks_body(*leaves, s0)
    # the state's cotangent from the last chunk back: dS0 = r_decᵀ dy +
    # exp(wc) ⊙ dS1, and a chunk's dS1 is the next chunk's dS0
    a = r_dec.detach().transpose(-1, -2) @ dyc
    ewc = ewc.detach().transpose(-1, -2)
    d = ds1.to(dt)
    ds1s = torch.empty_like(a)
    for i in range(T - 1, -1, -1):
        ds1s[i] = d
        d = torch.addcmul(a[i], ewc[i], d)
    dr, dk, dv, dlw, du = torch.autograd.grad((y, s1), leaves, (dyc, ds1s))

    def unchunked(g, like):            # (T, B, H, C, N) -> (B, S, H, N)
        return g.permute(1, 0, 3, 2, 4).reshape(B, T * C, H, N)[:, :S].to(like.dtype)

    return (unchunked(dr, r), unchunked(dk, k), unchunked(dv, v), unchunked(dlw, logw),
            du.to(u.dtype), d.to(states.dtype))


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

"""Shared model building blocks (``repro/models/common.py``) at tp=1.

The reference writes these for execution inside ``shard_map`` with
explicit tensor-parallel collectives.  The port has no model axis yet,
so ``embed_lookup`` takes tp=1 only; ``col_parallel``, ``row_parallel``
and ``sharded_softmax_xent`` come with tensor parallelism and training
(ROADMAP queue 1 items 5 and 9).  The numerics are the reference's:
norms in f32 and cast back, RoPE products promoted to f32 before the
cast back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- numerics
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "silu": F.silu,
    "relu": F.relu,
    "relu2": lambda x: F.relu(x).square(),
}


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int → cos/sin (..., head_dim/2) f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2).  Half-split
    rotation; a bf16 ``x`` times the f32 angles is computed in f32 and
    cast back once."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# -------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               device: torch.device) -> torch.Tensor:
    """Normal(0, 1/in_dim) drawn in f32 from ``gen`` (a generator on
    ``device``) and cast to ``dtype``; on ``meta`` only the shape."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


# ------------------------------------------------------- vocab embedding
def embed_lookup(emb: torch.Tensor, ids: torch.Tensor, tp: int) -> torch.Tensor:
    """emb: (V, d); ids: (B, S) vocab ids → (B, S, d).  As the reference
    at tp=1: an id outside [0, V) looks up a zero row."""
    if tp != 1:
        raise NotImplementedError(
            "vocab-sharded embedding (tp > 1): ROADMAP queue 1 item 9")
    v = emb.shape[0]
    in_range = (ids >= 0) & (ids < v)
    out = emb[ids.clamp(0, v - 1)]
    return torch.where(in_range[..., None], out, torch.zeros((), dtype=emb.dtype,
                                                             device=emb.device))


# ------------------------------------------------------------ GQA helpers
@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """How q and kv heads distribute over the TP axis.  At tp=1 every
    head is local; the fields keep the reference's meaning for tp > 1."""

    n_heads: int          # possibly padded up to a multiple of tp
    kv_heads: int
    head_dim: int
    tp: int

    @property
    def q_local(self) -> int:
        return self.n_heads // self.tp

    @property
    def group(self) -> int:          # q heads per kv head
        return self.n_heads // self.kv_heads

    @property
    def kv_sharded(self) -> bool:
        return self.kv_heads >= self.tp

    @property
    def kv_local(self) -> int:
        if self.kv_sharded:
            return self.kv_heads // self.tp
        return max(self.q_local // self.group, 1)


def pad_heads(n_heads: int, tp: int) -> int:
    """Round up so heads shard evenly (starcoder2: 24 → 32 on tp=16)."""
    return int(-(-n_heads // tp) * tp)

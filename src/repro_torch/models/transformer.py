"""Decoder-only transformer LM (``repro/models/transformer.py``): the
dense serving path at tp=1.

Parameters are the reference's tree — the same nesting, leaf names and
stacked ``(n_layers, ...)`` block leaves — so weights carry over by name
(``utils/convert.py::params_from_numpy``).  Layers run as a Python loop
over the stack where the reference scans.

Ported: ``TransformerConfig`` (every field), ``init_params``,
``prefill`` (with ``last_pos``), ``decode_step`` (ring-buffer slot),
``decode_step_paged`` and ``make_cache``.  A config that needs MoE,
cross-attention, FSDP or tp > 1 raises ``NotImplementedError`` naming its
ROADMAP item; ``train_forward`` and ``backbone`` come with ROADMAP queue 1
item 5.

The reference's serve functions return new caches (JAX donates the old
ones).  Here ``decode_step`` and ``decode_step_paged`` write the new
token's k/v into the cache or pool tensors in place and return the same
tensors: no second cache is ever allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.dependency import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ACTIVATIONS,
    HeadLayout,
    apply_rope,
    dense_init,
    embed_lookup,
    pad_heads,
    rms_norm,
    rope_angles,
    swiglu,
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    act: str = "silu"
    gated: bool = True
    qk_norm: bool = False
    swa_window: Optional[int] = None
    rope_theta: float = 500_000.0
    moe: Any = None                   # MoECfg in the reference: not ported
    cross_attn_every: Optional[int] = None   # 1 cross layer per N self layers
    n_img_tokens: int = 0
    frame_embeds: bool = False        # musicgen stub conditioning input
    dtype: Any = torch.bfloat16
    tp: int = 1
    attn_chunk: int = 1024
    remat: str = "dots"
    scan_unroll: int = 1
    depcha_in_scan: bool = False      # emit DP psums inside backward scan
    dp_axes: tuple[str, ...] = ("data",)
    use_flash: bool = False
    chunk_unroll: bool = False        # unroll chunk scans (exact HLO cost)
    depcha_reducer: str = "flat"      # flat | hierarchical (in-scan sync)
    intra_size: int = 16              # intra-pod "data" size (hierarchical)
    fsdp: bool = False                # ZeRO-3 block weights (not ported)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def heads_padded(self) -> int:
        return pad_heads(self.n_heads, self.tp)

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, self.tp)

    @property
    def layout(self) -> HeadLayout:
        return HeadLayout(self.heads_padded, self.kv_heads, self.hd, self.tp)

    @property
    def n_cross(self) -> int:
        if not self.cross_attn_every:
            return 0
        return self.n_layers // (self.cross_attn_every + 1)

    @property
    def n_self(self) -> int:
        return self.n_layers - self.n_cross


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for what the port does not run yet, naming its ROADMAP item."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE FFN — ROADMAP queue 1 item 12")
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers — ROADMAP queue 1 item 12")
    if cfg.fsdp:
        raise NotImplementedError(f"{cfg.name}: FSDP — ROADMAP queue 1 item 8")
    if cfg.tp != 1:
        raise NotImplementedError(
            f"{cfg.name}: tp={cfg.tp} — tensor parallelism, ROADMAP queue 1 item 9")


# ------------------------------------------------------------------ params
def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """The reference's parameter tree (``transformer.py::init_params``),
    drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``
    (the draws differ from ``jax.random``'s; tests carry the reference's
    weights over instead).  On the ``meta`` device only shapes are made.
    CUDA unless the caller asks for the CPU; raises without a card."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_self
    Hq, Hkv = cfg.heads_padded, cfg.kv_heads
    ff, dt = cfg.d_ff, cfg.dtype

    def dense(shape, in_dim):
        return dense_init(gen, shape, in_dim, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    blocks = {
        "ln1": ones(L, d),
        "wq": dense((L, d, Hq * hd), d),
        "wk": dense((L, d, Hkv * hd), d),
        "wv": dense((L, d, Hkv * hd), d),
        "wo": dense((L, Hq * hd, d), Hq * hd),
        "ln2": ones(L, d),
    }
    if cfg.qk_norm:
        blocks["qnorm"] = ones(L, hd)
        blocks["knorm"] = ones(L, hd)
    if cfg.gated:
        blocks["wg"] = dense((L, d, ff), d)
        blocks["wu"] = dense((L, d, ff), d)
    else:
        blocks["wi"] = dense((L, d, ff), d)
    blocks["wdown"] = dense((L, ff, d), ff)
    return {
        "embed": dense((cfg.vocab_padded, d), d),
        "blocks": blocks,
        "ln_f": ones(d),
        "lm_head": dense((d, cfg.vocab_padded), d),
    }


def in_scan_param_names(params: dict) -> frozenset[str]:
    """Leaves whose gradient the reference sums inside the backward scan
    (depcha)."""
    from repro_torch.utils.trees import flatten_with_names

    return frozenset(n for n, _ in flatten_with_names(params)[0]
                     if n.startswith("blocks/") or n.startswith("cross_blocks/"))


def _layer(params: dict, li: int) -> dict:
    return {n: w[li] for n, w in params["blocks"].items()}


# ----------------------------------------------------------------- blocks
def _attn_qkv(p: dict, h: torch.Tensor, cfg: TransformerConfig):
    """Project to q, k, v heads: (B, S, Hq, hd), (B, S, Hkv, hd) × 2."""
    lay, hd = cfg.layout, cfg.hd
    q = (h @ p["wq"]).reshape(*h.shape[:2], lay.q_local, hd)
    k = (h @ p["wk"]).reshape(*h.shape[:2], lay.kv_local, hd)
    v = (h @ p["wv"]).reshape(*h.shape[:2], lay.kv_local, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    return q, k, v


def _ffn(p: dict, h: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.gated:
        a = swiglu(h @ p["wg"], h @ p["wu"])
    else:
        a = ACTIVATIONS[cfg.act](h @ p["wi"])
    return a @ p["wdown"]


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) → next-token logits (B, V)."""
    return (rms_norm(x, params["ln_f"]) @ params["lm_head"])[:, 0]


def _mlp_residual(p: dict, x: torch.Tensor, o: torch.Tensor,
                  cfg: TransformerConfig) -> torch.Tensor:
    x = x + o @ p["wo"]
    return x + _ffn(p, rms_norm(x, p["ln2"]), cfg)


# ------------------------------------------------------------------ serve
def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            last_pos: Optional[int] = None):
    """Full-sequence forward; returns (next_token_logits (B, V), kv_cache).

    Cache layout: dict of (n_self, B, S, kv_local, hd) stacked tensors.
    ``last_pos`` selects which position's logits to return (the
    continuous engine right-pads prompts to a bucket and reads the true
    last token; causality keeps every earlier position independent of the
    padding).  None returns the last position's.
    """
    check_supported(cfg)
    B, S = tokens.shape
    lay, hd = cfg.layout, cfg.hd
    x = embed_lookup(params["embed"], tokens, cfg.tp).to(cfg.dtype)
    cos, sin = rope_angles(torch.arange(S, device=tokens.device), hd, cfg.rope_theta)
    shape = (cfg.n_self, B, S, lay.kv_local, hd)
    cache = {"k": torch.empty(shape, dtype=cfg.dtype, device=tokens.device),
             "v": torch.empty(shape, dtype=cfg.dtype, device=tokens.device)}
    for li in range(cfg.n_self):
        p = _layer(params, li)
        q, k, v = _attn_qkv(p, rms_norm(x, p["ln1"]), cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attn_lib.attention(q, k, v, causal=True, window=cfg.swa_window,
                               chunk=cfg.attn_chunk, use_flash=cfg.use_flash)
        x = _mlp_residual(p, x, o.reshape(B, S, -1), cfg)
        cache["k"][li] = k
        cache["v"][li] = v
    sel = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    return _head(params, sel), cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos: int,
                cfg: TransformerConfig):
    """One decode step.  token: (B,) int; pos: absolute position (int).

    cache: dict k/v of (n_self, B, Smax, kv_local, hd).  When Smax <
    pos+1 the cache is a ring buffer (sliding-window archs: Smax ==
    window).  The new k/v are written into ``cache`` in place.  Returns
    (next_logits (B, V), cache).
    """
    check_supported(cfg)
    B = token.shape[0]
    smax = cache["k"].shape[2]
    slot = pos % smax
    kv_len = min(pos + 1, smax)
    win = cfg.swa_window if (cfg.swa_window and smax > cfg.swa_window) else None
    x = embed_lookup(params["embed"], token[:, None], cfg.tp).to(cfg.dtype)
    cos, sin = rope_angles(torch.tensor([pos], device=token.device), cfg.hd,
                           cfg.rope_theta)
    for li in range(cfg.n_self):
        p = _layer(params, li)
        q, k, v = _attn_qkv(p, rms_norm(x, p["ln1"]), cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        o = attn_lib.decode_attention(q, kc, vc, kv_len, window=win)
        x = _mlp_residual(p, x, o.reshape(B, 1, -1), cfg)
    return _head(params, x), cache


def decode_step_paged(params: dict, pool_k: torch.Tensor, pool_v: torch.Tensor,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      positions: torch.Tensor, cfg: TransformerConfig):
    """One decode step over a paged KV pool with per-slot positions.

    pool_k/pool_v: (n_self, num_blocks, block_size, kv_local, hd), the
    physical block pool.  block_tables: (W, max_blocks) int block ids per
    slot; tokens: (W,) the token each slot consumes; positions: (W,) its
    absolute position.  Logical position ``p`` of slot ``w`` lives at
    flat pool row ``table[w, p // bs] * bs + p % bs``.  The per-position
    math is ``decode_step``'s with a per-slot kv_len.  The new k/v rows
    are written into the pools in place.  Returns (logits (W, V), pool_k,
    pool_v).
    """
    check_supported(cfg)
    W = tokens.shape[0]
    bs = pool_k.shape[2]
    MB = block_tables.shape[1]
    x = embed_lookup(params["embed"], tokens[:, None], cfg.tp).to(cfg.dtype)
    cos, sin = rope_angles(positions[:, None], cfg.hd, cfg.rope_theta)
    tables = block_tables.long()
    pos = positions.long()
    # per-slot write row + gather map into the flat (num_blocks*bs) pool
    wr = tables.gather(1, (pos // bs)[:, None])[:, 0] * bs + pos % bs
    gat = ((tables * bs)[:, :, None]
           + torch.arange(bs, device=tables.device)[None, None, :]).reshape(W, MB * bs)
    kv_len = positions + 1
    win = (cfg.swa_window
           if (cfg.swa_window and MB * bs > cfg.swa_window) else None)
    for li in range(cfg.n_self):
        p = _layer(params, li)
        q, k, v = _attn_qkv(p, rms_norm(x, p["ln1"]), cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kf = pool_k[li].view(-1, *pool_k.shape[3:])
        vf = pool_v[li].view(-1, *pool_v.shape[3:])
        kf[wr] = k[:, 0]
        vf[wr] = v[:, 0]
        o = attn_lib.decode_attention(q, kf[gat], vf[gat], kv_len, window=win)
        x = _mlp_residual(p, x, o.reshape(W, 1, -1), cfg)
    return _head(params, x), pool_k, pool_v


def make_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Empty KV cache, on CUDA unless the caller asks for the CPU."""
    device = resolve_device(device)
    lay = cfg.layout
    shape = (cfg.n_self, batch, max_len, lay.kv_local, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

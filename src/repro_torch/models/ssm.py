"""Mamba-2 (SSD, arXiv:2405.21060) and the Zamba2 hybrid
(arXiv:2411.15242; ``repro/models/ssm.py``): a Mamba-2 backbone with a
*shared* transformer block applied after every ``attn_every`` layers, its
weights reused at each application; training and serving at any tp.

SSD recurrence per head (P = head dim, N = ssm state):
  h_t = a_t h_{t-1} + dt_t · x_t B_tᵀ        h: (P, N), a_t a scalar a head
  y_t = h_t C_t + D x_t
evaluated chunk-parallel in f32 (``ssd_chunked``): the intra-chunk term
M[t, s] = C_t·B_s · exp(Lc_t − Lc_s) · dt_s (s ≤ t) times x, and the
inter-chunk term exp(Lc_t) · C_t · S₀ from the state each chunk starts
from.  The reference scans the chunks with ``lax.scan``; the port computes
every chunk's local terms at once, batched over the chunks, and runs only
the state recurrence S₁ = exp(W_C) S₀ + U in order (a loop of autograd
ops over the chunks, not over the positions).  The running log-decay sum
Lc is a product with a triangle of ones (the card's ``cumsum`` has no
deterministic kernel, and training holds its losses bit-identical across
strategies); it is summed in float64, so that each difference
Lc_t − Lc_s is exact before its rounding to f32 (in f32 its error grows
with |Lc|).  The decay is exp(where(s ≤ t, Lc_t − Lc_s, −inf)): the
reference takes where(s ≤ t, exp(Lc_t − Lc_s), 0), the same values, but
above the diagonal its exponent is ≥ 0 and overflows once a chunk's
decay sum passes 88.7, and the gradient through the masked inf is
0·inf = NaN.
The reference has no Pallas kernel on this path, so neither has the port.

Parameters are the reference's tree — the same names, shapes, dtypes and
stacked ``(n_layers, ...)`` block leaves, ``shared_attn/*`` once — so
weights carry over by name (``utils/convert.py::params_from_numpy``).

Tensor parallelism (the reference's layout, ``param_rules``): the SSM
heads are sharded over "model".  The fused in-projection ``w_in`` (z | x |
B | C | dt) and the conv stay replicated; after the conv each rank slices
its z and x channels and its dt heads (B and C, one group, are not
sliced); ``A_log``, ``D``, ``dt_bias`` and ``ln_y`` take the head shard,
``w_out`` is row-parallel with a psum over "model".  The shared block is
the transformer's GQA layout (``HeadLayout``: kv heads sharded when
kv_heads ≥ tp, else sliced from the replicated wk/wv), with a psum after
``wo`` and after ``wdown``.  A replicated leaf then holds each model
rank's partial gradient, which the gradient sync sums over "model".

Training runs the groups of ``_groups(cfg)`` through
``core/overlap.py::run_layers`` from the stack unbound once, depcha's
``LayerSync`` indexed by the global layer number, and the shared block
after each group but the last.  The shared block runs under ``cfg.remat``
too (the reference does not checkpoint it): the same values, less memory
kept for the backward.  Its gradient accumulates over its applications
and goes through the post-backward buckets.

Serving: ``prefill`` keeps the last ``min(attn_window, S)`` k/v rows of
each attention site, ring-aligned so that token p lives at slot p %
window; ``decode_step`` writes the SSM state, the conv state and the new
k/v rows in place (slot pos % window) and attends to min(pos + 1, window)
rows.  At tp > 1 both take the rank's ``ModelAxis``; the decode state
holds the rank's SSM heads and kv heads, and the whole (replicated) conv
state (``decode_state_specs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dependency import resolve_device
from repro_torch.core.overlap import LayerSync, layer_rows, rematted, run_layers
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (NO_MODEL_AXIS, HeadLayout, ModelAxis, apply_rope,
                                       dense_init, embed_lookup, init_tree, model_psum,
                                       rms_norm, rope_angles, sharded_softmax_xent, swiglu)
from repro_torch.parallel.sharding import MODEL_AXIS, ShardingRules, reduce_axes_tree
from repro_torch.utils.trees import flatten_with_names


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int                      # shared-attn MLP width (zamba2)
    vocab: int
    ssm_state: int = 64
    head_p: int = 64               # channels per ssm head
    expand: int = 2
    d_conv: int = 4
    attn_every: int = 0            # 0 → pure mamba; zamba2: 6
    n_heads: int = 32              # shared attention block heads
    kv_heads: int = 32
    dtype: Any = torch.bfloat16
    tp: int = 1
    chunk: int = 64
    rope_theta: float = 10_000.0
    remat: str = "dots"
    depcha_in_scan: bool = False
    dp_axes: tuple[str, ...] = ("data",)
    depcha_reducer: str = "flat"
    intra_size: int = 16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.head_p

    @property
    def heads_local(self) -> int:
        return self.ssm_heads // self.tp if self.tp > 1 else self.ssm_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // self.tp) * self.tp

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def layout(self) -> HeadLayout:
        return HeadLayout(self.n_heads, self.kv_heads, self.hd, self.tp)


# ------------------------------------------------------------------ params
def init_params(cfg: SSMConfig, *, seed: int = 0,
                device: str | torch.device = "cuda", mesh=None,
                rank: int | None = None) -> dict:
    """The reference's parameter tree (``ssm.py::init_params``): dense
    leaves drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (other draws than ``jax.random``'s), the constant leaves as
    the reference sets them (``A_log`` and ``dt_bias`` 0 and ``D`` 1 in
    f32, the norms 1).  With a ``mesh`` (and this process's ``rank``) the
    global tree is drawn and only the rank's blocks are kept.  On the
    ``meta`` device only shapes are made.  CUDA unless the caller asks for
    the CPU; raises without a card."""
    return init_tree(_draw_params, param_specs, cfg, seed=seed, device=device, mesh=mesh,
                     rank=rank)


def _draw_params(cfg: SSMConfig, seed: int, device: torch.device) -> dict:
    """The global tree of ``init_params``, drawn in its order."""
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
    d, L, dt = cfg.d_model, cfg.n_layers, cfg.dtype
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    def dense(shape, in_dim):
        return dense_init(gen, shape, in_dim, dt, device)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    f32 = torch.float32
    blocks = {
        "ln": full((L, d), 1.0),
        # fused in-proj: z (di) | x (di) | B (N) | C (N) | dt (H)
        "w_in": dense((L, d, 2 * di + 2 * N + H), d),
        "conv_w": dense((L, cfg.d_conv, di + 2 * N), cfg.d_conv),
        "A_log": full((L, H), 0.0, f32),
        "D": full((L, H), 1.0, f32),
        "dt_bias": full((L, H), 0.0, f32),
        "ln_y": full((L, di), 1.0),
        "w_out": dense((L, di, d), di),
    }
    params = {
        "embed": dense((cfg.vocab_padded, d), d),
        "blocks": blocks,
        "ln_f": full((d,), 1.0),
        "lm_head": dense((d, cfg.vocab_padded), d),
    }
    if cfg.attn_every:
        hd = cfg.hd
        params["shared_attn"] = {
            "ln1": full((d,), 1.0),
            "wq": dense((d, cfg.n_heads * hd), d),
            "wk": dense((d, cfg.kv_heads * hd), d),
            "wv": dense((d, cfg.kv_heads * hd), d),
            "wo": dense((cfg.n_heads * hd, d), d),
            "ln2": full((d,), 1.0),
            "wg": dense((d, cfg.d_ff), d),
            "wu": dense((d, cfg.d_ff), d),
            "wdown": dense((cfg.d_ff, d), cfg.d_ff),
        }
    return params


# standard deviation of the seeded offset each constant leaf gets
CONSTANT_LEAF_OFFSETS = {"A_log": 0.5, "dt_bias": 0.5, "D": 0.5, "ln": 0.1, "ln_y": 0.1}


def perturb_constant_leaves(params: dict, *, seed: int = 1) -> dict:
    """Give the block leaves that ``init_params`` sets to a constant
    (``CONSTANT_LEAF_OFFSETS``) small normal offsets drawn from a
    generator seeded with ``seed``, in place.  At init every head has the
    same decay (``A_log`` and ``dt_bias`` 0) and skip (``D`` 1), so a wrong
    head shard of them would not show; a run from random weights that
    should exercise them perturbs first.  Returns ``params``."""
    blocks = params["blocks"]
    gen = torch.Generator(device=blocks["A_log"].device).manual_seed(seed)
    for name in sorted(CONSTANT_LEAF_OFFSETS):
        w = blocks[name]
        noise = torch.randn(w.shape, generator=gen, dtype=torch.float32, device=w.device)
        w.copy_((w.float() + CONSTANT_LEAF_OFFSETS[name] * noise).to(w.dtype))
    return params


def param_rules(cfg: SSMConfig) -> ShardingRules:
    """The reference's regex → spec table.  ``w_in`` fuses z|x|B|C|dt: its
    B/C/dt parts are replicated reads, so the fused weight stays
    replicated and each rank slices its z|x channels after the conv."""
    rules = [
        (r"embed", (MODEL_AXIS, None)),
        (r"lm_head", (None, MODEL_AXIS)),
        (r"/w_out$", (None, MODEL_AXIS, None)),
        (r"shared_attn/wq$", (None, MODEL_AXIS)),
        (r"shared_attn/wo$", (MODEL_AXIS, None)),
        (r"shared_attn/w[gu]$", (None, MODEL_AXIS)),
        (r"shared_attn/wdown$", (MODEL_AXIS, None)),
        (r"/(A_log|D|dt_bias)$", (None, MODEL_AXIS)),
        (r"/ln_y$", (None, MODEL_AXIS)),
    ]
    if cfg.attn_every and cfg.kv_heads >= cfg.tp:
        rules += [
            (r"shared_attn/wk$", (None, MODEL_AXIS)),
            (r"shared_attn/wv$", (None, MODEL_AXIS)),
        ]
    return ShardingRules(rules=tuple(rules))


def param_specs(params: dict, cfg: SSMConfig) -> dict:
    """The params' specs tree under ``param_rules(cfg)``."""
    return param_rules(cfg).tree_specs(params)


def in_scan_param_names(params: dict) -> frozenset[str]:
    """The stacked Mamba leaves.  The shared block's weights are reused at
    every site, so they are synced once, after the backward."""
    return frozenset(n for n, _ in flatten_with_names(params)[0]
                     if n.startswith("blocks/"))


def layer_sync(cfg: SSMConfig, params: dict, mesh,
               device: str | torch.device = "cuda") -> Optional[LayerSync]:
    """The in-backward sync of the ``blocks`` stack (the reference's
    ``scan_layers`` with ``reduce_axes_tree``'s axes), or None without
    ``depcha_in_scan``.  A layer holds bf16 leaves beside the f32
    ``A_log``, ``D`` and ``dt_bias``: 2 slots a layer at tp = 1, and 3 at
    tp > 1 (the replicated bf16 leaves over data × model, the sharded bf16
    leaves over data, the f32 leaves over data).  Collective: it creates
    communicators."""
    if not cfg.depcha_in_scan:
        return None
    mesh_axes = tuple(cfg.dp_axes) + ((MODEL_AXIS,) if cfg.tp > 1 else ())
    axes = reduce_axes_tree(param_rules(cfg), params["blocks"], "blocks/", mesh_axes)
    return LayerSync(params["blocks"], axes, mesh, prefix="blocks/",
                     reducer=cfg.depcha_reducer, intra_size=cfg.intra_size, device=device)


def _layer(params: dict, li: int) -> dict:
    return {n: w[li] for n, w in params["blocks"].items()}


def _groups(cfg: SSMConfig) -> list[int]:
    """Mamba-layer group sizes between shared-attn applications."""
    if not cfg.attn_every:
        return [cfg.n_layers]
    out, rem = [], cfg.n_layers
    while rem > 0:
        out.append(min(cfg.attn_every, rem))
        rem -= out[-1]
    return out


def n_attn_sites(cfg: SSMConfig) -> int:
    if not cfg.attn_every:
        return 0
    return max(len(_groups(cfg)) - 1, 0)


# ------------------------------------------------------------------ block
def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); state: (B, K−1, C)
    or None (zeros).  The K products are summed in the reference's order.
    Returns (silu(out), the new state: the last K−1 inputs)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(out), new_state


def ssd_chunked(xh: torch.Tensor, B_in: torch.Tensor, C_in: torch.Tensor,
                loga: torch.Tensor, dt: torch.Tensor, state: torch.Tensor, chunk: int):
    """Chunked SSD in f32.  xh: (B, S, H, P); B_in, C_in: (B, S, N); loga:
    (B, S, H) (≤ 0); dt: (B, S, H); state: (B, H, P, N).  Returns (y (B,
    S, H, P) f32, the final state f32).  The tail is zero-padded as the
    reference pads it (x = 0 and dt = 0 leave the state unchanged)."""
    Bb, S, H, Pd = xh.shape
    N = B_in.shape[-1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B_in, C_in = F.pad(B_in, (0, 0, 0, pad)), F.pad(C_in, (0, 0, 0, pad))
        loga, dt = F.pad(loga, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    T = (S + pad) // C
    f32 = torch.float32
    xc = xh.reshape(Bb, T, C, H, Pd).permute(1, 0, 3, 2, 4).to(f32)   # (T, B, H, C, P)
    bc = B_in.reshape(Bb, T, C, N).transpose(0, 1).to(f32)            # (T, B, C, N)
    cc = C_in.reshape(Bb, T, C, N).transpose(0, 1).to(f32)
    lg = loga.reshape(Bb, T, C, H).permute(1, 0, 3, 2).to(f32)       # (T, B, H, C)
    dc = dt.reshape(Bb, T, C, H).permute(1, 0, 3, 2).to(f32)

    ones = torch.ones(C, C, dtype=torch.bool, device=xh.device)
    # Lc[t] = Σ_{s≤t} loga_s, in float64: its differences Lc_t − Lc_s are
    # then exact before their rounding to f32 (in f32 they lose their low
    # bits once |Lc| is large)
    Lc64 = lg.double() @ ones.triu().double()
    Lc = Lc64.float()
    # intra-chunk: M[t, s] = (C_t·B_s) exp(Lc_t − Lc_s) dt_s for s ≤ t; the
    # exponent masked (−inf above the diagonal), not its result
    scores = cc @ bc.transpose(-1, -2)             # (T, B, C, C)
    exponent = (Lc64[..., :, None] - Lc64[..., None, :]).float()
    dec = torch.exp(torch.where(ones.tril(), exponent, float("-inf")))   # (T, B, H, C, C)
    M = scores[:, :, None] * dec * dc[..., None, :]
    y_intra = M @ xc                               # (T, B, H, C, P)
    # each chunk's own contribution to the state at its end:
    # U = Σ_s exp(W_C − Lc_s) dt_s x_s B_sᵀ, then S₁ = exp(W_C) S₀ + U in order
    WC = Lc[..., -1]                               # (T, B, H)
    w_s = dec[..., -1, :] * dc                     # (T, B, H, C)
    U = (w_s[..., None] * xc).transpose(-1, -2) @ bc[:, :, None]   # (T, B, H, P, N)
    decay = torch.exp(WC)[..., None, None]
    S0, starts = state.to(f32), []
    for i in range(T):
        starts.append(S0)
        S0 = S0 * decay[i] + U[i]
    starts = torch.stack(starts)                   # the state each chunk starts from
    # inter-chunk: exp(Lc_t) · C_t · S₀ᵀ, then the intra term added
    y = (cc[:, :, None] @ starts.transpose(-1, -2)) * torch.exp(Lc)[..., None]
    y = y + y_intra
    y = y.permute(1, 0, 3, 2, 4).reshape(Bb, T * C, H, Pd)
    return y[:, :S], S0


def mamba_block(p: dict, x: torch.Tensor, cfg: SSMConfig,
                state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                axis: ModelAxis = NO_MODEL_AXIS):
    """One Mamba-2 block on the residual stream, with the reference's
    casts.  state: (B, H_local, P, N) f32 or None (zeros); conv_state: (B,
    K−1, d_inner + 2N) or None.  At tp > 1 ``axis`` is the rank's
    ``ModelAxis``.  Returns (x out, new ssm state, new conv state)."""
    Bb, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    Hl, Pd = cfg.heads_local, cfg.head_p
    h = rms_norm(x, p["ln"])
    zxbcdt = h @ p["w_in"]                         # replicated (small N, H tails)
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [di, di, N, N, cfg.ssm_heads], dim=-1)
    conv_out, new_conv = _causal_conv(torch.cat([xs, Bc, Cc], dim=-1), p["conv_w"],
                                      conv_state)
    xs, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)
    if cfg.tp > 1:                                 # the rank's head shard
        dl = di // cfg.tp
        xs = xs.narrow(2, axis.index * dl, dl)
        z = z.narrow(2, axis.index * dl, dl)
        dt = dt.narrow(2, axis.index * Hl, Hl)
    xh = xs.reshape(Bb, S, Hl, Pd)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    loga = -torch.exp(p["A_log"])[None, None] * dt            # (B, S, Hl) ≤ 0
    if state is None:
        state = torch.zeros((Bb, Hl, Pd, N), dtype=torch.float32, device=x.device)
    y, new_state = ssd_chunked(xh, Bc, Cc, loga, dt, state, cfg.chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(Bb, S, -1)
    # gated rms groupnorm, one group a ssm head (heads never split across ranks)
    yz = y * F.silu(z.float())
    yg = yz.reshape(Bb, S, Hl, Pd)
    var = yg.square().mean(dim=-1, keepdim=True)
    yz = (yg * torch.rsqrt(var + 1e-6)).reshape(Bb, S, -1) * p["ln_y"].float()
    out = model_psum(yz.to(x.dtype) @ p["w_out"], axis)
    return x + out, new_state, new_conv


def shared_attn_block(p: dict, x: torch.Tensor, cfg: SSMConfig, rope,
                      kv_cache=None, pos: Optional[int] = None,
                      axis: ModelAxis = NO_MODEL_AXIS):
    """Zamba2's shared transformer block (GQA with RoPE, then a SwiGLU
    MLP).  Training and prefill (``kv_cache`` None): causal self-attention
    over x, returning its (k, v) for the caller to window.  Decode:
    ``kv_cache`` a (B, Smax, kv_local, hd) pair written in place at slot
    ``pos % Smax``, attended up to min(pos + 1, Smax) rows."""
    Bb, S, _ = x.shape
    lay, hd = cfg.layout, cfg.hd
    h = rms_norm(x, p["ln1"])
    q = (h @ p["wq"]).reshape(Bb, S, lay.q_local, hd)
    wk, wv = p["wk"], p["wv"]
    if not lay.kv_sharded and cfg.tp > 1:
        start = lay.kv_slice_start(axis.index) * hd
        wk = wk.narrow(-1, start, lay.kv_local * hd)
        wv = wv.narrow(-1, start, lay.kv_local * hd)
    k = (h @ wk).reshape(Bb, S, lay.kv_local, hd)
    v = (h @ wv).reshape(Bb, S, lay.kv_local, hd)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if kv_cache is None:
        o = attn_lib.attention(q, k, v, causal=True)
        new_cache = (k, v)
    else:
        kc, vc = kv_cache
        smax = kc.shape[1]
        slot = pos % smax
        kc[:, slot:slot + S] = k
        vc[:, slot:slot + S] = v
        o = attn_lib.decode_attention(q, kc, vc, min(pos + 1, smax))
        new_cache = (kc, vc)
    x = x + model_psum(o.reshape(Bb, S, -1) @ p["wo"], axis)
    h = rms_norm(x, p["ln2"])
    f = model_psum(swiglu(h @ p["wg"], h @ p["wu"]) @ p["wdown"], axis)
    return x + f, new_cache


# ------------------------------------------------------------------ train
def train_forward(params: dict, batch: dict, cfg: SSMConfig, *,
                  layer_sync: Optional[LayerSync] = None,
                  model_axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
    """Local-shard loss (the reference's ``train_forward``): the summed
    token cross-entropy over the GLOBAL token count, each Mamba block from
    a zero state, the shared block after each group of ``_groups(cfg)``
    but the last, every block under ``cfg.remat``; with ``layer_sync``
    each Mamba layer's gradient is reduced inside the backward (slot = its
    global layer number).  At tp > 1 ``params`` are the rank's shards and
    ``model_axis`` its ``ModelAxis``; each gradient then comes out tp × its
    per-shard value, as the transformer's does."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, cfg.tp, model_axis).to(cfg.dtype)
    rope = (rope_angles(torch.arange(S, device=tokens.device), cfg.hd, cfg.rope_theta)
            if cfg.attn_every else None)
    rows = layer_rows(params["blocks"])
    shared = rematted(lambda p, h: shared_attn_block(p, h, cfg, rope, axis=model_axis)[0],
                      cfg.remat)
    off = 0
    for g in _groups(cfg):
        x = run_layers(lambda p, h: mamba_block(p, h, cfg, axis=model_axis)[0], rows, x,
                       range(off, off + g), sync=layer_sync, remat=cfg.remat)
        off += g
        if cfg.attn_every and off < cfg.n_layers:
            x = shared(params["shared_attn"], x)
    per_tok = sharded_softmax_xent(rms_norm(x, params["ln_f"]) @ params["lm_head"],
                                   batch["labels"], cfg.tp, model_axis)
    return per_tok.sum() / batch["global_tokens"]


class SSM(nn.Module):
    """The parameter tree as an ``nn.Module``: ``params_tree()`` gives the
    reference's nesting (``embed``, ``blocks/<leaf>`` stacked over the
    layers, ``shared_attn/<leaf>`` when the config has the shared block,
    ``ln_f``, ``lm_head``); ``forward(batch)`` is the training loss."""

    def __init__(self, cfg: SSMConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.blocks = nn.ParameterDict({k: nn.Parameter(v)
                                        for k, v in params["blocks"].items()})
        self.shared_attn = None
        if "shared_attn" in params:
            self.shared_attn = nn.ParameterDict({k: nn.Parameter(v) for k, v in
                                                 params["shared_attn"].items()})
        self.ln_f = nn.Parameter(params["ln_f"])
        self.lm_head = nn.Parameter(params["lm_head"])

    def params_tree(self) -> dict:
        tree = {"embed": self.embed, "blocks": dict(self.blocks.items()),
                "ln_f": self.ln_f, "lm_head": self.lm_head}
        if self.shared_attn is not None:
            tree["shared_attn"] = dict(self.shared_attn.items())
        return tree

    def forward(self, batch: dict, layer_sync: Optional[LayerSync] = None,
                model_axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
        return train_forward(self.params_tree(), batch, self.cfg,
                             layer_sync=layer_sync, model_axis=model_axis)


# ------------------------------------------------------------------ serve
def make_state(cfg: SSMConfig, batch: int, attn_window: int,
               device: str | torch.device = "cuda") -> dict:
    """Empty decode state: the SSM state of the rank's ``heads_local``
    heads and the whole conv state a layer and, a shared attention site, a
    ring of ``attn_window`` rows of the rank's ``kv_local`` heads.  On
    CUDA unless the caller asks for the CPU."""
    device = resolve_device(device)
    Hl, Pd, N, L = cfg.heads_local, cfg.head_p, cfg.ssm_state, cfg.n_layers
    st = {
        "ssm": torch.zeros((L, batch, Hl, Pd, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch, cfg.d_conv - 1, cfg.d_inner + 2 * N),
                            dtype=cfg.dtype, device=device),
    }
    na = n_attn_sites(cfg)
    if na:
        shape = (na, batch, attn_window, cfg.layout.kv_local, cfg.hd)
        st["attn_k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        st["attn_v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return st


def decode_state_specs(cfg: SSMConfig, batch_entry) -> dict:
    """Which dim of each decode-state leaf is sharded over which axes (the
    reference's ``decode_state_specs``): the batch over ``batch_entry``,
    the SSM heads and the sites' kv heads over "model"; the conv state's
    channels replicated."""
    specs = {"ssm": (None, batch_entry, MODEL_AXIS, None, None),
             "conv": (None, batch_entry, None, None)}
    if n_attn_sites(cfg):
        specs["attn_k"] = specs["attn_v"] = (None, batch_entry, None, MODEL_AXIS, None)
    return specs


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) → next-token logits (B, V/tp)."""
    return (rms_norm(x, params["ln_f"]) @ params["lm_head"])[:, 0]


def _mamba_layers(params: dict, state: dict, x: torch.Tensor, cfg: SSMConfig,
                  layers: range, axis: ModelAxis) -> torch.Tensor:
    """``layers`` of the stack over x from the decode state, each layer's
    new SSM and conv state written into ``state`` in place."""
    for li in layers:
        x, ns, nc = mamba_block(_layer(params, li), x, cfg, state=state["ssm"][li],
                                conv_state=state["conv"][li], axis=axis)
        state["ssm"][li].copy_(ns)
        state["conv"][li].copy_(nc)
    return x


def prefill(params: dict, tokens: torch.Tensor, cfg: SSMConfig, attn_window: int = 0, *,
            model_axis: ModelAxis = NO_MODEL_AXIS):
    """Full-sequence forward.  ``attn_window`` (0: the prompt length) is
    the size of each attention site's ring; its last min(window, S) k/v
    rows are kept, ring-aligned when the window is full so that token p
    lives at slot p % window.  At tp > 1 ``params`` are the rank's shards
    and ``model_axis`` its ``ModelAxis``.  Returns (the last position's
    next-token logits of the rank's vocab shard (B, V/tp), decode state)."""
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens, cfg.tp, model_axis).to(cfg.dtype)
    rope = (rope_angles(torch.arange(S, device=tokens.device), cfg.hd, cfg.rope_theta)
            if cfg.attn_every else None)
    w = attn_window or S
    state = make_state(cfg, B, w, tokens.device)
    off = site = 0
    for g in _groups(cfg):
        x = _mamba_layers(params, state, x, cfg, range(off, off + g), model_axis)
        off += g
        if cfg.attn_every and off < cfg.n_layers:
            x, kv = shared_attn_block(params["shared_attn"], x, cfg, rope, axis=model_axis)
            keep = min(w, S)
            for name, t in zip(("attn_k", "attn_v"), kv):
                rows = t[:, S - keep:]
                if keep == w:                     # ring-align: token p at slot p % w
                    state[name][site].copy_(torch.roll(rows, S % w, dims=1))
                else:
                    state[name][site][:, :keep].copy_(rows)
            site += 1
    return _head(params, x[:, -1:]), state


def decode_step(params: dict, state: dict, token: torch.Tensor, pos: int, cfg: SSMConfig, *,
                model_axis: ModelAxis = NO_MODEL_AXIS):
    """One decode step at absolute position ``pos``.  token: (B,) int.
    The new SSM, conv and k/v state is written into ``state`` in place.
    ``model_axis`` as ``prefill``'s.  Returns (logits of the token just
    consumed (B, V/tp), state)."""
    x = embed_lookup(params["embed"], token[:, None], cfg.tp, model_axis).to(cfg.dtype)
    rope = (rope_angles(torch.tensor([pos], device=token.device), cfg.hd, cfg.rope_theta)
            if cfg.attn_every else None)
    off = site = 0
    for g in _groups(cfg):
        x = _mamba_layers(params, state, x, cfg, range(off, off + g), model_axis)
        off += g
        if cfg.attn_every and off < cfg.n_layers:
            x, _ = shared_attn_block(params["shared_attn"], x, cfg, rope,
                                     kv_cache=(state["attn_k"][site], state["attn_v"][site]),
                                     pos=pos, axis=model_axis)
            site += 1
    return _head(params, x), state

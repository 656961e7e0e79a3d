"""RWKV-6 "Finch" (arXiv:2404.05892; ``repro/models/rwkv.py``): the
attention-free LM with data-dependent per-channel decay: training and
serving at any tp.

The WKV recurrence is evaluated in chunked-parallel form (chunk C):
  S_t = diag(w_t) S_{t-1} + k_t v_t^T          (per head, S: (N, N))
  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
``wkv_chunked`` is one call of ``kernels/rwkv6/ops.py::wkv_sequence`` a
layer: on the card one launch of the hand-written CUDA kernel, which
reads r, k, v and logw in their (B, S, H, N) layout, runs every chunk in
order with the state on chip and writes y in r's dtype; on the CPU its
plain version, the chunks in order.  ``prefill`` and ``decode_step`` have
it write each layer's final state straight into the decode state.  In
training the call is differentiable: the same launch also writes the
state each chunk starts from, and the backward recomputes the chunks from
those (``ops._WKVSequence``).  (The reference scans the same chunk math in
jnp and differentiates it with XLA.)

Parameters are the reference's tree — the same names, shapes, dtypes and
stacked ``(n_layers, ...)`` block leaves — so weights carry over by name
(``utils/convert.py::params_from_numpy``).  Layers run as a Python loop
over the stack where the reference scans (``core/overlap.py::
scan_layers``, with ``cfg.remat`` and depcha's in-backward sync).

Tensor parallelism (the reference's layout, ``param_rules``): the heads
are sharded over "model" — wr, wk, wv, wg and ck column-parallel, wo and
cv row-parallel with a psum over model after each, w0, u and ln_x with
the head shard; the small ddlerp and LoRA leaves are replicated and the
decay's LoRA output is sliced to the rank's channels; the channel mix's
receptance (cr, column-parallel) is all-gathered over model
(``models/common.py::model_all_gather``, whose backward reduce-scatters).
Embedding and cross-entropy are vocab-sharded.  ``init_params`` with a
mesh and a rank draws the global tree and keeps the rank's blocks.

Ported: ``RWKVConfig``, ``init_params``, ``param_rules``/``param_specs``,
``in_scan_param_names``, the block (token shift, ddlerp, decay, time mix
with its per-head groupnorm, channel mix), ``train_forward``, the ``RWKV``
module, ``layer_sync``, ``make_state``, ``decode_state_specs``,
``prefill`` and ``decode_step``.  At tp > 1 the serve functions take the
rank's ``ModelAxis`` and the decode state holds the rank's heads of the
WKV state (the token shifts are the replicated residual stream).
``decode_step`` writes the new state into the state tensors in place and
returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dependency import resolve_device
from repro_torch.core.overlap import LayerSync, scan_layers
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models.common import (NO_MODEL_AXIS, ModelAxis, dense_init, embed_lookup,
                                       init_tree, model_all_gather, model_psum, rms_norm,
                                       sharded_softmax_xent)
from repro_torch.parallel.sharding import MODEL_AXIS, ShardingRules, reduce_axes_tree
from repro_torch.utils.trees import flatten_with_names


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_size: int = 64
    lora_w: int = 64
    lora_mix: int = 32
    dtype: Any = torch.bfloat16
    tp: int = 1
    chunk: int = 32
    remat: str = "dots"
    scan_unroll: int = 1
    depcha_in_scan: bool = False
    dp_axes: tuple[str, ...] = ("data",)
    chunk_unroll: bool = False
    depcha_reducer: str = "flat"
    intra_size: int = 16

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_size

    @property
    def heads_local(self) -> int:
        return self.n_heads // self.tp if self.tp > 1 else self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // self.tp) * self.tp


# ------------------------------------------------------------------ params
def init_params(cfg: RWKVConfig, *, seed: int = 0,
                device: str | torch.device = "cuda", mesh=None,
                rank: int | None = None) -> dict:
    """The reference's parameter tree (``rwkv.py::init_params``): dense
    leaves drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (other draws than ``jax.random``'s), the constant leaves as
    the reference sets them (``w0`` = −5 and ``u`` = 0 in f32, the mix
    coefficients and LoRA up-projections 0, the norms 1).  With a ``mesh``
    (and this process's ``rank``, by default the process group's) the
    global tree is drawn and only the rank's blocks are kept, as
    ``transformer.init_params`` does.  On the ``meta`` device only shapes
    are made.  CUDA unless the caller asks for the CPU; raises without a
    card."""
    return init_tree(_draw_params, param_specs, cfg, seed=seed, device=device, mesh=mesh,
                     rank=rank)


def _draw_params(cfg: RWKVConfig, seed: int, device: torch.device) -> dict:
    """The global tree of ``init_params``, drawn in its order."""
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed)
    d, L, dt = cfg.d_model, cfg.n_layers, cfg.dtype

    def dense(shape, in_dim):
        return dense_init(gen, shape, in_dim, dt, device)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    blocks = {
        "ln1": full((L, d), 1.0),
        "ln2": full((L, d), 1.0),
        # ddlerp mix coefficients (5 targets: r, k, v, w, g) + base
        "mu_x": full((L, d), 0.0),
        "mu_rkvwg": full((L, 5, d), 0.0),
        "lora_mix_a": dense((L, d, 5 * cfg.lora_mix), d),
        "lora_mix_b": full((L, 5, cfg.lora_mix, d), 0.0),
        # time-mix projections
        "wr": dense((L, d, d), d),
        "wk": dense((L, d, d), d),
        "wv": dense((L, d, d), d),
        "wg": dense((L, d, d), d),
        "wo": dense((L, d, d), d),
        # decay: w = exp(-exp(w0 + lora)); bonus u
        "w0": full((L, d), -5.0, torch.float32),
        "lora_w_a": dense((L, d, cfg.lora_w), d),
        "lora_w_b": full((L, cfg.lora_w, d), 0.0),
        "u": full((L, d), 0.0, torch.float32),
        "ln_x": full((L, d), 1.0),           # per-head groupnorm scale
        # channel-mix
        "mu_ck": full((L, d), 0.0),
        "mu_cr": full((L, d), 0.0),
        "ck": dense((L, d, cfg.d_ff), d),
        "cv": dense((L, cfg.d_ff, d), cfg.d_ff),
        "cr": dense((L, d, d), d),
    }
    return {
        "embed": dense((cfg.vocab_padded, d), d),
        "blocks": blocks,
        "ln_f": full((d,), 1.0),
        "lm_head": dense((d, cfg.vocab_padded), d),
    }


# standard deviation of the seeded offset each constant leaf gets
CONSTANT_LEAF_OFFSETS = {"mu_x": 0.1, "mu_rkvwg": 0.1, "lora_mix_b": 0.1,
                         "lora_w_b": 0.1, "u": 0.5, "w0": 0.5, "mu_ck": 0.1,
                         "mu_cr": 0.1}


def perturb_constant_leaves(params: dict, *, seed: int = 1) -> dict:
    """Give the block leaves that ``init_params`` sets to a constant
    (``CONSTANT_LEAF_OFFSETS``) small normal offsets drawn from a
    generator seeded with ``seed``, in place.  With random weights and
    these leaves at 0, the bonus u, the token-shift mixes and the LoRA
    modulations would drop out of every block; a run from random weights
    that should exercise them perturbs first.  Returns ``params``."""
    blocks = params["blocks"]
    gen = torch.Generator(device=blocks["u"].device).manual_seed(seed)
    for name in sorted(CONSTANT_LEAF_OFFSETS):
        w = blocks[name]
        noise = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                            device=w.device)
        w.copy_((w.float() + CONSTANT_LEAF_OFFSETS[name] * noise).to(w.dtype))
    return params


def param_rules(cfg: RWKVConfig) -> ShardingRules:
    """The reference's regex → spec table: the head-sharded leaves over
    "model", the rest replicated."""
    return ShardingRules(rules=(
        (r"embed", (MODEL_AXIS, None)),
        (r"lm_head", (None, MODEL_AXIS)),
        (r"/w[rkvg]$", (None, None, MODEL_AXIS)),
        (r"/wo$", (None, MODEL_AXIS, None)),
        (r"/ck$", (None, None, MODEL_AXIS)),
        (r"/cv$", (None, MODEL_AXIS, None)),
        (r"/cr$", (None, None, MODEL_AXIS)),
        # per-channel vectors sharded with the head shard
        (r"/(w0|u|ln_x)$", (None, MODEL_AXIS)),
    ))


def param_specs(params: dict, cfg: RWKVConfig) -> dict:
    """The params' specs tree under ``param_rules(cfg)``."""
    return param_rules(cfg).tree_specs(params)


def in_scan_param_names(params: dict) -> frozenset[str]:
    return frozenset(n for n, _ in flatten_with_names(params)[0]
                     if n.startswith("blocks/"))


def layer_sync(cfg: RWKVConfig, params: dict, mesh,
               device: str | torch.device = "cuda") -> Optional[LayerSync]:
    """The in-backward sync of the ``blocks`` stack (the reference's
    ``scan_layers`` with ``reduce_axes_tree``'s axes), or None without
    ``depcha_in_scan``.  A layer holds bf16 leaves beside the f32 ``w0``
    and ``u``, so it takes a slot a dtype (and at tp > 1 a slot for the
    replicated leaves, which reduce over "model" too).  Collective: it
    creates communicators."""
    if not cfg.depcha_in_scan:
        return None
    mesh_axes = tuple(cfg.dp_axes) + ((MODEL_AXIS,) if cfg.tp > 1 else ())
    axes = reduce_axes_tree(param_rules(cfg), params["blocks"], "blocks/", mesh_axes)
    return LayerSync(params["blocks"], axes, mesh, prefix="blocks/",
                     reducer=cfg.depcha_reducer, intra_size=cfg.intra_size, device=device)


def _layer(params: dict, li: int) -> dict:
    return {n: w[li] for n, w in params["blocks"].items()}


# ------------------------------------------------------------------ block
def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xx_t = x_{t-1}; the first position takes ``last`` (decode) or zeros."""
    if x.shape[1] == 1 and last is not None:
        return last[:, None, :]
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if last is not None:
        shifted[:, 0] = last
    return shifted


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Data-dependent interpolation → the 5 mixed inputs (r, k, v, w, g),
    (B, S, 5, d)."""
    dx = xx - x
    base = x + dx * p["mu_x"]
    lo = torch.tanh(base @ p["lora_mix_a"])              # (B, S, 5*lm)
    lo = lo.reshape(*lo.shape[:2], 5, -1)
    mod = torch.einsum("bstl,tld->bstd", lo, p["lora_mix_b"])
    mix = p["mu_rkvwg"][None, None] + mod                 # (B, S, 5, d)
    return x[:, :, None, :] + dx[:, :, None, :] * mix


def _decay(p: dict, xw: torch.Tensor, axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
    """log w_t ≤ 0: −exp(clip(w0 + lora_w(xw), −10, 8)), in f32, on the
    rank's channels (those of its ``w0`` shard: the replicated LoRA's
    output sliced at tp > 1)."""
    lo = torch.tanh(xw @ p["lora_w_a"]) @ p["lora_w_b"]   # (B, S, d)
    if axis.size > 1:
        d_local = p["w0"].shape[-1]
        lo = lo.narrow(-1, axis.index * d_local, d_local)
    return -torch.exp(torch.clamp(p["w0"][None, None].float() + lo.float(),
                                  -10.0, 8.0))


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                chunk: int, out: Optional[torch.Tensor] = None):
    """Chunked WKV.  r, k, v, logw: (B, S, H, N) (logw ≤ 0); u: (H, N);
    state: (B, H, N, N) [state[b, h, i, j] ~ k-dim i, v-dim j].  Returns
    (y (B, S, H, N) in r's dtype, final state f32, in ``out`` where given:
    it may be ``state`` itself)."""
    return wkv_ops.wkv_sequence(r, k, v, logw, u, state, chunk, out=out)


def _time_mix(p: dict, x: torch.Tensor, cfg: RWKVConfig, state: torch.Tensor,
              last_x: Optional[torch.Tensor], out: Optional[torch.Tensor] = None,
              axis: ModelAxis = NO_MODEL_AXIS):
    """Returns (out, new_state, new_last_x)."""
    B, S, _ = x.shape
    H, N = cfg.heads_local, cfg.head_size
    xx = _token_shift(x, last_x)
    mixed = _ddlerp(p, x, xx)
    xr, xk, xv, xw, xg = (mixed[:, :, i] for i in range(5))
    r = (xr @ p["wr"]).reshape(B, S, H, N)
    k = (xk @ p["wk"]).reshape(B, S, H, N)
    v = (xv @ p["wv"]).reshape(B, S, H, N)
    g = F.silu(xg @ p["wg"])
    logw = _decay(p, xw, axis).reshape(B, S, H, N)
    u = p["u"].reshape(H, N)
    y, new_state = wkv_chunked(r, k, v, logw, u, state, cfg.chunk, out=out)
    # per-head groupnorm
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + 64e-5)
    yn = (yn.reshape(B, S, -1) * p["ln_x"].float()).to(x.dtype)
    return model_psum((yn * g) @ p["wo"], axis), new_state, x[:, -1]


def _channel_mix(p: dict, x: torch.Tensor, last_x: Optional[torch.Tensor],
                 axis: ModelAxis = NO_MODEL_AXIS):
    xx = _token_shift(x, last_x)
    xk = x + (xx - x) * p["mu_ck"]
    xr = x + (xx - x) * p["mu_cr"]
    k = F.relu(xk @ p["ck"]).square()                     # column-parallel
    out = model_psum(k @ p["cv"], axis)                   # row-parallel
    r = model_all_gather(torch.sigmoid(xr @ p["cr"]), axis)
    return r * out, x[:, -1]


def block(p: dict, x: torch.Tensor, cfg: RWKVConfig,
          state: Optional[torch.Tensor] = None, lasts: Optional[dict] = None,
          out: Optional[torch.Tensor] = None, axis: ModelAxis = NO_MODEL_AXIS):
    """One RWKV block.  state: (B, H, N, N) or None (zeros); lasts: the
    decode token shifts {"tm", "cm"}; out: where the new state goes (it may
    be ``state``), else a new tensor; axis: the rank's ``ModelAxis`` at tp
    > 1.  Returns (x, new_state, new lasts)."""
    if state is None:
        state = torch.zeros((x.shape[0], cfg.heads_local, cfg.head_size,
                             cfg.head_size), dtype=torch.float32, device=x.device)
    l_tm = lasts["tm"] if lasts else None
    l_cm = lasts["cm"] if lasts else None
    a, new_state, new_ltm = _time_mix(p, rms_norm(x, p["ln1"]), cfg, state, l_tm, out, axis)
    x = x + a
    m, new_lcm = _channel_mix(p, rms_norm(x, p["ln2"]), l_cm, axis)
    return x + m, new_state, {"tm": new_ltm, "cm": new_lcm}


# ------------------------------------------------------------------ train
def train_forward(params: dict, batch: dict, cfg: RWKVConfig, *,
                  layer_sync: Optional[LayerSync] = None,
                  model_axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
    """Local-shard loss (the reference's ``train_forward``): the summed
    token cross-entropy over the GLOBAL token count, each block from a
    zero WKV state, under ``cfg.remat``; with ``layer_sync`` each layer's
    gradient is reduced inside the backward.  At tp > 1 ``params`` are the
    rank's shards and ``model_axis`` its ``ModelAxis``; each gradient then
    comes out tp × its per-shard value, as the transformer's does."""
    x = embed_lookup(params["embed"], batch["tokens"], cfg.tp, model_axis).to(cfg.dtype)
    x = scan_layers(lambda p, h: block(p, h, cfg, axis=model_axis)[0], params["blocks"], x,
                    sync=layer_sync, remat=cfg.remat)
    per_tok = sharded_softmax_xent(rms_norm(x, params["ln_f"]) @ params["lm_head"],
                                   batch["labels"], cfg.tp, model_axis)
    return per_tok.sum() / batch["global_tokens"]


class RWKV(nn.Module):
    """The parameter tree as an ``nn.Module``: ``params_tree()`` gives the
    reference's nesting (``embed``, ``blocks/<leaf>`` stacked over the
    layers, ``ln_f``, ``lm_head``); ``forward(batch)`` is the training
    loss over it."""

    def __init__(self, cfg: RWKVConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.blocks = nn.ParameterDict({k: nn.Parameter(v)
                                        for k, v in params["blocks"].items()})
        self.ln_f = nn.Parameter(params["ln_f"])
        self.lm_head = nn.Parameter(params["lm_head"])

    def params_tree(self) -> dict:
        return {"embed": self.embed, "blocks": dict(self.blocks.items()),
                "ln_f": self.ln_f, "lm_head": self.lm_head}

    def forward(self, batch: dict, layer_sync: Optional[LayerSync] = None,
                model_axis: ModelAxis = NO_MODEL_AXIS) -> torch.Tensor:
        return train_forward(self.params_tree(), batch, self.cfg,
                             layer_sync=layer_sync, model_axis=model_axis)


# ------------------------------------------------------------------ serve
def make_state(cfg: RWKVConfig, batch: int,
               device: str | torch.device = "cuda") -> dict:
    """Empty decode state: the WKV state of the rank's ``heads_local``
    heads, and the token shifts at full ``d_model``; on CUDA unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    H, N, L = cfg.heads_local, cfg.head_size, cfg.n_layers
    return {
        "wkv": torch.zeros((L, batch, H, N, N), dtype=torch.float32, device=device),
        "tm": torch.zeros((L, batch, cfg.d_model), dtype=cfg.dtype, device=device),
        "cm": torch.zeros((L, batch, cfg.d_model), dtype=cfg.dtype, device=device),
    }


def decode_state_specs(cfg: RWKVConfig, batch_entry) -> dict:
    """Which dim of each decode-state leaf is sharded over which axes (the
    reference's ``decode_state_specs``): the batch over ``batch_entry``,
    the WKV state's heads over "model"; the token shifts replicated."""
    return {"wkv": (None, batch_entry, MODEL_AXIS, None, None),
            "tm": (None, batch_entry, None),
            "cm": (None, batch_entry, None)}


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) → next-token logits (B, V/tp)."""
    return (rms_norm(x, params["ln_f"]) @ params["lm_head"])[:, 0]


def prefill(params: dict, tokens: torch.Tensor, cfg: RWKVConfig, *,
            model_axis: ModelAxis = NO_MODEL_AXIS):
    """Full-sequence forward; returns (the last position's next-token
    logits of the rank's vocab shard (B, V/tp), decode state).  At tp > 1
    ``params`` are the rank's shards and ``model_axis`` its ``ModelAxis``."""
    x = embed_lookup(params["embed"], tokens, cfg.tp, model_axis).to(cfg.dtype)
    state = make_state(cfg, tokens.shape[0], tokens.device)
    for li in range(cfg.n_layers):   # each layer's WKV from its zero state, in place
        st = state["wkv"][li]
        x, _, lasts = block(_layer(params, li), x, cfg, state=st, out=st, axis=model_axis)
        state["tm"][li] = lasts["tm"]
        state["cm"][li] = lasts["cm"]
    return _head(params, x[:, -1:]), state


def decode_step(params: dict, state: dict, token: torch.Tensor, pos: int,
                cfg: RWKVConfig, *, model_axis: ModelAxis = NO_MODEL_AXIS):
    """One decode step.  token: (B,) int; ``pos`` is not read (the state
    carries the position).  The new state is written into ``state`` in
    place.  ``model_axis`` as ``prefill``'s.  Returns (logits of the
    token just consumed (B, V/tp), state)."""
    x = embed_lookup(params["embed"], token[:, None], cfg.tp, model_axis).to(cfg.dtype)
    for li in range(cfg.n_layers):
        st = state["wkv"][li]
        x, _, lasts = block(_layer(params, li), x, cfg, state=st, out=st,
                            lasts={"tm": state["tm"][li], "cm": state["cm"][li]},
                            axis=model_axis)
        state["tm"][li] = lasts["tm"]
        state["cm"][li] = lasts["cm"]
    return _head(params, x), state

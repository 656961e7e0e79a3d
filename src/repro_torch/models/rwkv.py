"""RWKV-6 "Finch" (arXiv:2404.05892; ``repro/models/rwkv.py``): the
attention-free LM with data-dependent per-channel decay, serving at tp=1.

The WKV recurrence is evaluated in chunked-parallel form (chunk C):
  S_t = diag(w_t) S_{t-1} + k_t v_t^T          (per head, S: (N, N))
  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
``wkv_chunked`` is one call of ``kernels/rwkv6/ops.py::wkv_sequence`` a
layer: on the card one launch of the hand-written CUDA kernel, which
reads r, k, v and logw in their (B, S, H, N) layout, runs every chunk in
order with the state on chip and writes y in r's dtype; on the CPU its
plain version, the chunks in order.  ``prefill`` and ``decode_step`` have
it write each layer's final state straight into the decode state.  (The
reference scans the same chunk math in jnp.)

Parameters are the reference's tree — the same names, shapes, dtypes and
stacked ``(n_layers, ...)`` block leaves — so weights carry over by name
(``utils/convert.py::params_from_numpy``).  Layers run as a Python loop
over the stack where the reference scans.

Ported: ``RWKVConfig``, ``init_params``, ``in_scan_param_names``, the
block (token shift, ddlerp, decay, time mix with its per-head groupnorm,
channel mix), ``make_state``, ``prefill`` and ``decode_step``.  A config
with tp > 1 raises; ``train_forward``, ``param_rules`` and
``decode_state_specs`` come with training and tensor parallelism (ROADMAP
queue 1 items 5, 9 and 12).  ``decode_step`` writes the new state into
the state tensors in place and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.dependency import resolve_device
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models.common import dense_init, embed_lookup, rms_norm


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


def check_supported(cfg: RWKVConfig) -> None:
    if cfg.tp != 1:
        raise NotImplementedError(
            f"{cfg.name}: tp={cfg.tp} — rwkv's tensor parallelism comes with its "
            f"training, ROADMAP queue 1 item 12")


# ------------------------------------------------------------------ params
def init_params(cfg: RWKVConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """The reference's parameter tree (``rwkv.py::init_params``): dense
    leaves drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (other draws than ``jax.random``'s), the constant leaves as
    the reference sets them (``w0`` = −5 and ``u`` = 0 in f32, the mix
    coefficients and LoRA up-projections 0, the norms 1).  On the
    ``meta`` device only shapes are made.  CUDA unless the caller asks for
    the CPU; raises without a card."""
    check_supported(cfg)
    device = resolve_device(device)
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


def in_scan_param_names(params: dict) -> frozenset[str]:
    from repro_torch.utils.trees import flatten_with_names

    return frozenset(n for n, _ in flatten_with_names(params)[0]
                     if n.startswith("blocks/"))


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


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """log w_t ≤ 0: −exp(clip(w0 + lora_w(xw), −10, 8)), in f32."""
    lo = torch.tanh(xw @ p["lora_w_a"]) @ p["lora_w_b"]   # (B, S, d)
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
              last_x: Optional[torch.Tensor], out: Optional[torch.Tensor] = None):
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
    logw = _decay(p, xw).reshape(B, S, H, N)
    u = p["u"].reshape(H, N)
    y, new_state = wkv_chunked(r, k, v, logw, u, state, cfg.chunk, out=out)
    # per-head groupnorm
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + 64e-5)
    yn = (yn.reshape(B, S, -1) * p["ln_x"].float()).to(x.dtype)
    return (yn * g) @ p["wo"], new_state, x[:, -1]


def _channel_mix(p: dict, x: torch.Tensor, last_x: Optional[torch.Tensor]):
    xx = _token_shift(x, last_x)
    xk = x + (xx - x) * p["mu_ck"]
    xr = x + (xx - x) * p["mu_cr"]
    k = F.relu(xk @ p["ck"]).square()
    return torch.sigmoid(xr @ p["cr"]) * (k @ p["cv"]), x[:, -1]


def block(p: dict, x: torch.Tensor, cfg: RWKVConfig,
          state: Optional[torch.Tensor] = None, lasts: Optional[dict] = None,
          out: Optional[torch.Tensor] = None):
    """One RWKV block.  state: (B, H, N, N) or None (zeros); lasts: the
    decode token shifts {"tm", "cm"}; out: where the new state goes (it may
    be ``state``), else a new tensor.  Returns (x, new_state, new lasts)."""
    if state is None:
        state = torch.zeros((x.shape[0], cfg.heads_local, cfg.head_size,
                             cfg.head_size), dtype=torch.float32, device=x.device)
    l_tm = lasts["tm"] if lasts else None
    l_cm = lasts["cm"] if lasts else None
    a, new_state, new_ltm = _time_mix(p, rms_norm(x, p["ln1"]), cfg, state, l_tm, out)
    x = x + a
    m, new_lcm = _channel_mix(p, rms_norm(x, p["ln2"]), l_cm)
    return x + m, new_state, {"tm": new_ltm, "cm": new_lcm}


# ------------------------------------------------------------------ serve
def make_state(cfg: RWKVConfig, batch: int,
               device: str | torch.device = "cuda") -> dict:
    """Empty decode state, on CUDA unless the caller asks for the CPU."""
    device = resolve_device(device)
    H, N, L = cfg.heads_local, cfg.head_size, cfg.n_layers
    return {
        "wkv": torch.zeros((L, batch, H, N, N), dtype=torch.float32, device=device),
        "tm": torch.zeros((L, batch, cfg.d_model), dtype=cfg.dtype, device=device),
        "cm": torch.zeros((L, batch, cfg.d_model), dtype=cfg.dtype, device=device),
    }


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) → next-token logits (B, V)."""
    return (rms_norm(x, params["ln_f"]) @ params["lm_head"])[:, 0]


def prefill(params: dict, tokens: torch.Tensor, cfg: RWKVConfig):
    """Full-sequence forward; returns (the last position's next-token
    logits (B, V), decode state)."""
    check_supported(cfg)
    x = embed_lookup(params["embed"], tokens, cfg.tp).to(cfg.dtype)
    state = make_state(cfg, tokens.shape[0], tokens.device)
    for li in range(cfg.n_layers):   # each layer's WKV from its zero state, in place
        st = state["wkv"][li]
        x, _, lasts = block(_layer(params, li), x, cfg, state=st, out=st)
        state["tm"][li] = lasts["tm"]
        state["cm"][li] = lasts["cm"]
    return _head(params, x[:, -1:]), state


def decode_step(params: dict, state: dict, token: torch.Tensor, pos: int,
                cfg: RWKVConfig):
    """One decode step.  token: (B,) int; ``pos`` is not read (the state
    carries the position).  The new state is written into ``state`` in
    place.  Returns (logits of the token just consumed (B, V), state)."""
    check_supported(cfg)
    x = embed_lookup(params["embed"], token[:, None], cfg.tp).to(cfg.dtype)
    for li in range(cfg.n_layers):
        st = state["wkv"][li]
        x, _, lasts = block(_layer(params, li), x, cfg, state=st, out=st,
                            lasts={"tm": state["tm"][li], "cm": state["cm"][li]})
        state["tm"][li] = lasts["tm"]
        state["cm"][li] = lasts["cm"]
    return _head(params, x), state

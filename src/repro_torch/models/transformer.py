"""Decoder-only transformer LM (``repro/models/transformer.py``): the
training and serving paths (dense or MoE FFN, gated cross-attention), at
any tp, FSDP or not.

Parameters are the reference's tree — the same nesting, leaf names and
stacked ``(n_layers, ...)`` block leaves — so weights carry over by name
(``utils/convert.py::params_from_numpy``).  Layers run as a Python loop
over the stack where the reference scans (``core/overlap.py::
layer_rows`` and ``run_layers``: each stack unbound once a forward).

Ported: ``TransformerConfig`` (every field), ``init_params``,
``param_rules`` (with ``_FSDP_DIM``) and ``param_specs``,
``fsdp_gather``, ``self_block``, ``cross_block``, ``backbone``,
``train_forward`` (with ``frame_embeds``, ``img_embeds``, the MoE aux
loss, and depcha's in-backward sync through a ``LayerSync``),
``pipeline_train_forward`` (pipeline stages, DESIGN.md §15),
``prefill`` and ``decode_step`` (with ``img_embeds``; ``prefill`` with
``last_pos``, ``decode_step`` with a ring-buffer slot),
``decode_step_paged``, ``make_cache``, ``decode_state_specs`` and the
``Transformer`` module.  The serve functions run on the rank's shards
with its ``ModelAxis`` and ``FsdpAxes``, as ``train_forward`` does, and
return the logits of the rank's vocab shard.

Cross-attention (``cross_attn_every``, llama-3.2-vision): the params hold
a second stack, ``cross_blocks`` (``n_cross`` layers: the self block's
leaves, a dense FFN, ``lnkv`` and a ``gate_attn`` scalar a layer, zero at
init as in the reference).  The layers run in the reference's order
(``_layer_order``): for each group ``cross_attn_every`` self blocks, then
one cross block, then the self blocks that remain.  A cross block attends
from the text to the image embeddings (B, n_img, d), non-causal, through
the chunked path (flash takes causal self-attention only, as the
reference's condition has it), adds ``tanh(gate_attn)`` × its output,
then its FFN.  Under depcha each stack has its ``LayerSync``
(``core/overlap.py::StackSyncs``, one set of communicators), as the
reference wraps each cross block in ``sync_in_backward``.  The KV cache
holds the self blocks only; a cross block projects the image K/V again
at every call, as the reference's does.  Paged decode refuses a config
with cross blocks, as the reference asserts.

MoE (``cfg.moe``, ``models/moe.py``): the blocks hold ``router`` (f32),
``w_gate``/``w_up``/``w_down`` (the experts, sharded over "model" on the
expert dim) and, with shared experts, ``ws_g``/``ws_u``/``ws_down`` in
place of the dense FFN; each block adds its aux loss to a carry beside
``x``, and ``train_forward`` adds the sum × (B·S / global tokens) /
n_layers.  Serving runs the same FFN and drops the aux.

FSDP (``cfg.fsdp``, ZeRO-3 storage): the leaves of ``_FSDP_DIM`` are
stored sharded over the dp axes too; ``fsdp_gather`` all-gathers one
layer's shards at the top of ``self_block``, inside the in-backward
sync's wrapper and the remat (so the gather runs again in the
recompute), and its backward reduce-scatters the gradient to the shard:
the dp sum, so no gradient sync sees those leaves.

Tensor parallelism: each rank holds its shards of the "model"-sharded
leaves (``param_rules``; ``init_params`` with a mesh and a rank draws
the global tree and keeps the rank's blocks) and runs the reference's
local-shard forward: q and the FFN's gate/up column-parallel, wo and
wdown row-parallel with a psum over model after each, the vocab-sharded
embedding and cross-entropy (``models/common.py``, on the ``ModelAxis``
the caller passes).  When kv_heads < tp the replicated wk and wv are
sliced at the rank's ``kv_slice_start``.

The reference's serve functions return new caches (JAX donates the old
ones).  Here ``decode_step`` and ``decode_step_paged`` write the new
token's k/v into the cache or pool tensors in place and return the same
tensors: no second cache is ever allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core.dependency import resolve_device
from repro_torch.core.overlap import LayerSync, StackSyncs, layer_rows, run_layers
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ACTIVATIONS,
    NO_FSDP,
    NO_MODEL_AXIS,
    FsdpAxes,
    HeadLayout,
    ModelAxis,
    apply_rope,
    dense_init,
    embed_lookup,
    fsdp_all_gather,
    init_tree,
    pad_heads,
    model_psum,
    rms_norm,
    rope_angles,
    sharded_softmax_xent,
    swiglu,
)
from repro_torch.models.moe import MoECfg, moe_ffn
from repro_torch.parallel.pipeline import NO_STAGE_AXIS, StageAxis, pipeline_wave_loss
from repro_torch.parallel.sharding import MODEL_AXIS, ShardingRules, reduce_axes_tree


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
    moe: Optional[MoECfg] = None
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
    fsdp: bool = False                # ZeRO-3: block weights stored sharded
                                      # over the dp axes too, gathered a layer

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


# ------------------------------------------------------------------ params
def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device: str | torch.device = "cuda", mesh=None,
                rank: int | None = None) -> dict:
    """The reference's parameter tree (``transformer.py::init_params``),
    drawn from a ``torch.Generator`` on ``device`` seeded with ``seed``
    (the draws differ from ``jax.random``'s; tests carry the reference's
    weights over instead).  With a ``mesh`` (and this process's ``rank``,
    by default the process group's) the global tree is drawn and only
    the rank's blocks are kept (``parallel/sharding.py::shard_tree``), so
    a leaf replicated over "model" is equal on every model rank and the
    shards of any tp put together are the tp=1 tree of the same seed.  On
    the ``meta`` device only shapes are made.  CUDA unless the caller
    asks for the CPU; raises without a card."""
    return init_tree(_draw_params, param_specs, cfg, seed=seed, device=device, mesh=mesh,
                     rank=rank)


def _draw_params(cfg: TransformerConfig, seed: int, device: torch.device) -> dict:
    """The global tree of ``init_params``, drawn in its order."""
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

    def blk(L: int, cross: bool) -> dict:
        """A stack of L blocks (the reference's ``blk``); a cross block
        adds ``lnkv`` and the zero ``gate_attn`` and has a dense FFN."""
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
        if cross:
            blocks["lnkv"] = ones(L, d)
            blocks["gate_attn"] = torch.zeros((L,), dtype=dt, device=device)
        if cfg.moe is not None and not cross:
            m = cfg.moe
            blocks["router"] = dense_init(gen, (L, d, m.num_experts), d, torch.float32,
                                          device)
            blocks["w_gate"] = dense((L, m.num_experts, d, m.d_expert), d)
            blocks["w_up"] = dense((L, m.num_experts, d, m.d_expert), d)
            blocks["w_down"] = dense((L, m.num_experts, m.d_expert, d), m.d_expert)
            if m.shared_experts:
                ds = m.d_expert * m.shared_experts
                blocks["ws_g"] = dense((L, d, ds), d)
                blocks["ws_u"] = dense((L, d, ds), d)
                blocks["ws_down"] = dense((L, ds, d), ds)
        else:
            if cfg.gated:
                blocks["wg"] = dense((L, d, ff), d)
                blocks["wu"] = dense((L, d, ff), d)
            else:
                blocks["wi"] = dense((L, d, ff), d)
            blocks["wdown"] = dense((L, ff, d), ff)
        return blocks

    params = {
        "embed": dense((cfg.vocab_padded, d), d),
        "blocks": blk(L, cross=False),
        "ln_f": ones(d),
        "lm_head": dense((d, cfg.vocab_padded), d),
    }
    if cfg.n_cross:
        params["cross_blocks"] = blk(cfg.n_cross, cross=True)
    return params


# FSDP storage: the big per-layer matrices get the dp axes on a second
# dim, the one that keeps the head/expert structure whole (the reference's
# table); ``fsdp_gather`` gathers them a layer
_FSDP_DIM = {
    "wq": 1, "wo": 2, "wi": 1, "wg": 1, "wu": 1, "wdown": 2,
    "w_gate": 3, "w_up": 3, "w_down": 2, "ws_g": 1, "ws_u": 1,
    "ws_down": 2,
}


def param_rules(cfg: TransformerConfig) -> ShardingRules:
    """The reference's regex → spec table: which dim of each leaf is
    sharded over "model" (and over the DP axes under FSDP)."""
    dp = tuple(cfg.dp_axes)
    dp_entry = dp if len(dp) > 1 else dp[0]

    def spec(rank: int, model_dim: int, name: str) -> tuple:
        entries = [None] * rank
        entries[model_dim] = MODEL_AXIS
        if cfg.fsdp and name in _FSDP_DIM:
            entries[_FSDP_DIM[name]] = dp_entry
        return tuple(entries)

    rules = [
        (r"embed", (MODEL_AXIS, None)),
        (r"lm_head", (None, MODEL_AXIS)),
        (r"/wq$", spec(3, 2, "wq")),
        (r"/wo$", spec(3, 1, "wo")),
        (r"/wi$", spec(3, 2, "wi")),
        (r"/wg$", spec(3, 2, "wg")),
        (r"/wu$", spec(3, 2, "wu")),
        (r"/wdown$", spec(3, 1, "wdown")),
        (r"/w_gate$", spec(4, 1, "w_gate")),
        (r"/w_up$", spec(4, 1, "w_up")),
        (r"/w_down$", spec(4, 1, "w_down")),
        (r"/ws_g$", spec(3, 2, "ws_g")),
        (r"/ws_u$", spec(3, 2, "ws_u")),
        (r"/ws_down$", spec(3, 1, "ws_down")),
    ]
    if cfg.layout.kv_sharded:
        rules += [(r"/wk$", (None, None, MODEL_AXIS)),
                  (r"/wv$", (None, None, MODEL_AXIS))]
    # else: wk/wv replicated, sliced per device (HeadLayout)
    return ShardingRules(rules=tuple(rules))


def param_specs(params: dict, cfg: TransformerConfig) -> dict:
    """The params' specs tree under ``param_rules(cfg)``."""
    return param_rules(cfg).tree_specs(params)


def fsdp_gather(p: dict, cfg: TransformerConfig, fsdp: FsdpAxes = NO_FSDP) -> dict:
    """One layer's params with each FSDP-sharded leaf all-gathered over
    the dp axes (the per-layer tensor has lost the stacking dim, hence
    ``_FSDP_DIM[name] - 1``); its backward reduce-scatters the gradient
    back to the shard.  The params as they are without ``cfg.fsdp``."""
    if not cfg.fsdp:
        return p
    out = dict(p)
    for name, dim in _FSDP_DIM.items():
        if name in out:
            out[name] = fsdp_all_gather(out[name], dim - 1, fsdp)
    return out


def in_scan_param_names(params: dict) -> frozenset[str]:
    """Leaves whose gradient the reference sums inside the backward scan
    (depcha)."""
    from repro_torch.utils.trees import flatten_with_names

    return frozenset(n for n, _ in flatten_with_names(params)[0]
                     if n.startswith("blocks/") or n.startswith("cross_blocks/"))


def _layer(params: dict, li: int, stack: str = "blocks") -> dict:
    return {n: w[li] for n, w in params[stack].items()}


def _layer_order(cfg: TransformerConfig) -> list[tuple[str, int]]:
    """The blocks in the reference's order, as (stack, index): for each of
    the ``n_cross`` groups ``cross_attn_every`` self blocks, then one
    cross block; then the self blocks that remain."""
    if not cfg.n_cross:
        return [("blocks", li) for li in range(cfg.n_self)]
    per = cfg.cross_attn_every
    order = []
    for g in range(cfg.n_cross):
        order += [("blocks", li) for li in range(g * per, (g + 1) * per)]
        order.append(("cross_blocks", g))
    return order + [("blocks", li) for li in range(cfg.n_cross * per, cfg.n_self)]


def _depcha_axes(cfg: TransformerConfig, stacked: dict, prefix: str):
    """Per-leaf gradient-reduction axes for the in-backward sync: the DP
    axes (plus "model" for leaves replicated over it at tp > 1)."""
    if not cfg.depcha_in_scan:
        return ()
    mesh_axes = tuple(cfg.dp_axes) + ((MODEL_AXIS,) if cfg.tp > 1 else ())
    return reduce_axes_tree(param_rules(cfg), stacked, prefix, mesh_axes)


def layer_sync(cfg: TransformerConfig, params: dict, mesh,
               device: str | torch.device = "cuda") -> LayerSync | StackSyncs | None:
    """The in-backward sync of the ``blocks`` stack (the reference's
    ``_stack_scan`` with ``depcha_axes``), or None without
    ``depcha_in_scan``.  With cross blocks, a ``StackSyncs`` of it and the
    ``cross_blocks`` stack's (the reference's ``sync_in_backward`` around
    each cross block), which shares its communicators.  Collective: it
    creates communicators."""
    axes = _depcha_axes(cfg, params["blocks"], "blocks/")
    if not axes:
        return None
    kw = dict(reducer=cfg.depcha_reducer, intra_size=cfg.intra_size, device=device)
    sync = LayerSync(params["blocks"], axes, mesh, prefix="blocks/", **kw)
    if not cfg.n_cross:
        return sync
    cross = LayerSync(params["cross_blocks"],
                      _depcha_axes(cfg, params["cross_blocks"], "cross_blocks/"), mesh,
                      prefix="cross_blocks/", share=sync, **kw)
    return StackSyncs((sync, cross))


# ----------------------------------------------------------------- blocks
def _kv(p: dict, h: torch.Tensor, cfg: TransformerConfig, axis: ModelAxis):
    """The rank's k, v heads of h: (B, S, kv_local, hd) × 2.  With kv_heads
    < tp the replicated wk, wv are sliced to the kv head(s) the rank's q
    heads read."""
    lay, hd = cfg.layout, cfg.hd
    wk, wv = p["wk"], p["wv"]
    if not lay.kv_sharded and cfg.tp > 1:
        start = lay.kv_slice_start(axis.index) * hd
        wk = wk.narrow(-1, start, lay.kv_local * hd)
        wv = wv.narrow(-1, start, lay.kv_local * hd)
    return ((h @ wk).reshape(*h.shape[:2], lay.kv_local, hd),
            (h @ wv).reshape(*h.shape[:2], lay.kv_local, hd))


def _attn_qkv(p: dict, h: torch.Tensor, cfg: TransformerConfig,
              axis: ModelAxis = NO_MODEL_AXIS):
    """Project to the rank's q, k, v heads: (B, S, q_local, hd),
    (B, S, kv_local, hd) × 2."""
    q = (h @ p["wq"]).reshape(*h.shape[:2], cfg.layout.q_local, cfg.hd)
    k, v = _kv(p, h, cfg, axis)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    return q, k, v


def _ffn(p: dict, h: torch.Tensor, cfg: TransformerConfig,
         axis: ModelAxis = NO_MODEL_AXIS) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN of h (B, S, d) and its aux loss (MoE; None when dense)."""
    if cfg.moe is not None:
        B, S, d = h.shape
        out, aux = moe_ffn(p, h.reshape(B * S, d), cfg.moe, axis)
        return out.reshape(B, S, d), aux
    if cfg.gated:
        a = swiglu(h @ p["wg"], h @ p["wu"])
    else:
        a = ACTIVATIONS[cfg.act](h @ p["wi"])
    return model_psum(a @ p["wdown"], axis), None


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) → next-token logits (B, V)."""
    return (rms_norm(x, params["ln_f"]) @ params["lm_head"])[:, 0]


def _mlp_residual(p: dict, x: torch.Tensor, o: torch.Tensor,
                  cfg: TransformerConfig, axis: ModelAxis = NO_MODEL_AXIS):
    """x + attention out o's projection, then + the FFN: (x out, aux)."""
    x = x + model_psum(o @ p["wo"], axis)
    f, aux = _ffn(p, rms_norm(x, p["ln2"]), cfg, axis)
    return x + f, aux


def self_block(p: dict, x: torch.Tensor, cfg: TransformerConfig, rope,
               axis: ModelAxis = NO_MODEL_AXIS, fsdp: FsdpAxes = NO_FSDP):
    """One decoder block over the whole sequence; rope = (cos, sin).
    Returns (x out, aux, k, v): the MoE aux loss (None when dense), k
    after RoPE (prefill caches k and v)."""
    p = fsdp_gather(p, cfg, fsdp)
    cos, sin = rope
    q, k, v = _attn_qkv(p, rms_norm(x, p["ln1"]), cfg, axis)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attn_lib.attention(q, k, v, causal=True, window=cfg.swa_window,
                           chunk=cfg.attn_chunk, use_flash=cfg.use_flash)
    x, aux = _mlp_residual(p, x, o.reshape(*x.shape[:2], -1), cfg, axis)
    return x, aux, k, v


def cross_block(p: dict, x: torch.Tensor, cfg: TransformerConfig, img: torch.Tensor,
                axis: ModelAxis = NO_MODEL_AXIS, fsdp: FsdpAxes = NO_FSDP) -> torch.Tensor:
    """One gated cross-attention block (llama-3.2-vision, the reference's
    ``cross_block``): the text x (B, S, d) attends to the image
    embeddings img (B, n_img, d), non-causal, through the chunked path;
    x + tanh(gate_attn) × the projected output, then the FFN."""
    p = fsdp_gather(p, cfg, fsdp)
    h = rms_norm(x, p["ln1"])
    q = (h @ p["wq"]).reshape(*x.shape[:2], cfg.layout.q_local, cfg.hd)
    k, v = _kv(p, rms_norm(img, p["lnkv"]), cfg, axis)
    o = attn_lib.attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    o = model_psum(o.reshape(*x.shape[:2], -1) @ p["wo"], axis)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * o
    f, _ = _ffn(p, rms_norm(x, p["ln2"]), cfg, axis)
    return x + f


def backbone(params: dict, x: torch.Tensor, cfg: TransformerConfig, rope, *,
             img: Optional[torch.Tensor] = None,
             sync: LayerSync | StackSyncs | None = None,
             axis: ModelAxis = NO_MODEL_AXIS, fsdp: FsdpAxes = NO_FSDP):
    """Every block in ``_layer_order``, x: (B, S, d) → (B, S, d), each
    under ``cfg.remat`` (a cross block too: the same values, less memory
    than the reference keeps); with ``sync`` each layer's gradient is
    reduced inside the backward.  ``img``: the image embeddings of the
    cross blocks.  With MoE returns (x, the blocks' aux losses summed,
    f32), the carry the reference scans."""
    if cfg.moe is None:
        fns = {"blocks": lambda p, h: self_block(p, h, cfg, rope, axis, fsdp)[0]}
        carry = x
    else:
        def body(p, carry):
            h, aux = carry
            h, a, _, _ = self_block(p, h, cfg, rope, axis, fsdp)
            return h, aux + a

        fns = {"blocks": body}
        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
    rows = {"blocks": layer_rows(params["blocks"])}
    syncs = {"blocks": sync}
    if cfg.n_cross:
        if img is None:
            raise ValueError(f"{cfg.name}: the cross blocks need img_embeds")
        fns["cross_blocks"] = lambda p, h: cross_block(p, h, cfg, img, axis, fsdp)
        rows["cross_blocks"] = layer_rows(params["cross_blocks"])
        syncs = {k: sync.of(k + "/") if sync is not None else None for k in rows}
    for stack, li in _layer_order(cfg):
        carry = run_layers(fns[stack], rows[stack], carry, (li,), sync=syncs[stack],
                           remat=cfg.remat)
    return carry


# ------------------------------------------------------------------ train
def train_forward(params: dict, batch: dict, cfg: TransformerConfig, *,
                  layer_sync: LayerSync | StackSyncs | None = None,
                  model_axis: ModelAxis = NO_MODEL_AXIS,
                  fsdp: FsdpAxes = NO_FSDP) -> torch.Tensor:
    """Local-shard loss: the summed token cross-entropy over the GLOBAL
    token count (``batch["global_tokens"]``), so a sum of the gradients
    over the data-parallel ranks is the global mean.  ``frame_embeds``
    (musicgen's stub conditioning, (B, S, d)) is added to the token
    embeddings when the config asks for it and the batch has it; the
    cross blocks read ``batch["img_embeds"]`` (B, n_img, d).

    At tp > 1 ``params`` are the rank's shards and ``model_axis`` the
    rank's ``ModelAxis``; the loss is then the same on every rank of a
    model group, and (the reference's psum transpose) each gradient comes
    out tp × its per-shard value.

    With ``cfg.fsdp`` ``params`` hold the rank's dp shards of the
    ``_FSDP_DIM`` leaves and ``fsdp`` is the rank's ``FsdpAxes``; those
    leaves' gradients come out as the dp sum of the shard's.  With MoE
    the blocks' aux losses are added, × (B·S / global tokens) / n_layers:
    each rank's share of their mean over the dp ranks."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens, cfg.tp, model_axis).to(cfg.dtype)
    if cfg.frame_embeds and "frame_embeds" in batch:
        x = x + batch["frame_embeds"].to(cfg.dtype)
    rope = rope_angles(torch.arange(S, device=tokens.device), cfg.hd, cfg.rope_theta)
    img = batch.get("img_embeds")
    if img is not None:
        img = img.to(cfg.dtype)
    h = backbone(params, x, cfg, rope, img=img, sync=layer_sync, axis=model_axis,
                 fsdp=fsdp)
    if cfg.moe is not None:
        h, aux = h
    per_tok = sharded_softmax_xent(rms_norm(h, params["ln_f"]) @ params["lm_head"],
                                   batch["labels"], cfg.tp, model_axis)
    loss = per_tok.sum() / batch["global_tokens"]
    if cfg.moe is not None:
        loss = loss + aux * ((B * S) / batch["global_tokens"]) / cfg.n_layers
    return loss


def pipeline_train_forward(params: dict, mbs: dict, cfg: TransformerConfig, *,
                           stage_axis: StageAxis = NO_STAGE_AXIS,
                           model_axis: ModelAxis = NO_MODEL_AXIS,
                           fsdp: FsdpAxes = NO_FSDP) -> torch.Tensor:
    """The staged wave-pipeline loss (DESIGN.md §15, the reference's
    ``pipeline_train_forward``): the sum over the microbatches of the
    local-shard loss, nonzero on the last stage only.

    ``mbs`` is the batch split into M microbatches with a leading M dim
    (``global_tokens`` of shape (M,), each 1/M of the batch's, as the
    accumulation path splits it).  ``params`` hold this stage's slice of
    the stacked blocks (dim 0 sharded over "stage").  Stage 0 embeds
    the injected microbatch, every stage runs its layer slice through
    ``self_block`` under ``cfg.remat``, the carry (activation, MoE aux)
    hops to the next stage (``parallel/pipeline.py``), and the last
    stage runs ``ln_f``, the head and ``sharded_softmax_xent``, folding
    the aux in as ``train_forward`` does.  The caller sums the result
    over the stage axis outside the backward.  Cross-attention is
    refused, as in the reference."""
    if cfg.n_cross:
        raise ValueError("pipeline stages do not support cross-attention layers")
    tokens = mbs["tokens"]
    M, B, S = tokens.shape
    rope = rope_angles(torch.arange(S, device=tokens.device), cfg.hd, cfg.rope_theta)
    gtok = mbs["global_tokens"]
    moe = cfg.moe is not None
    rows = layer_rows(params["blocks"])

    def inject(m: int) -> tuple:
        x = embed_lookup(params["embed"], tokens[m], cfg.tp, model_axis).to(cfg.dtype)
        if cfg.frame_embeds and "frame_embeds" in mbs:
            x = x + mbs["frame_embeds"][m].to(cfg.dtype)
        if moe:
            return x, torch.zeros((), dtype=torch.float32, device=x.device)
        return (x,)

    def body(p, carry):
        h, a, _, _ = self_block(p, carry[0], cfg, rope, model_axis, fsdp)
        return (h, carry[1] + a) if moe else (h,)

    def stage(carry: tuple) -> tuple:
        return run_layers(body, rows, carry, range(len(rows)), remat=cfg.remat)

    def head_loss(carry: tuple, m: int) -> torch.Tensor:
        per_tok = sharded_softmax_xent(rms_norm(carry[0], params["ln_f"]) @ params["lm_head"],
                                       mbs["labels"][m], cfg.tp, model_axis)
        loss = per_tok.sum() / gtok[m]
        if moe:
            loss = loss + carry[1] * ((B * S) / gtok[m]) / cfg.n_layers
        return loss

    like = [torch.empty((B, S, cfg.d_model), dtype=cfg.dtype, device=tokens.device)]
    if moe:
        like.append(torch.empty((), dtype=torch.float32, device=tokens.device))
    return pipeline_wave_loss(inject, stage, head_loss, M, axis=stage_axis,
                              carry_like=like).sum()


class Transformer(nn.Module):
    """The parameter tree as an ``nn.Module``: ``params_tree()`` gives the
    reference's nesting (``embed``, ``blocks/<leaf>`` stacked over the
    layers, ``cross_blocks/<leaf>`` with cross-attention, ``ln_f``,
    ``lm_head``); ``forward(batch)`` is the training loss over it."""

    def __init__(self, cfg: TransformerConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.blocks = nn.ParameterDict({k: nn.Parameter(v)
                                        for k, v in params["blocks"].items()})
        self.cross_blocks = None
        if "cross_blocks" in params:
            self.cross_blocks = nn.ParameterDict({k: nn.Parameter(v) for k, v in
                                                  params["cross_blocks"].items()})
        self.ln_f = nn.Parameter(params["ln_f"])
        self.lm_head = nn.Parameter(params["lm_head"])

    def params_tree(self) -> dict:
        tree = {"embed": self.embed, "blocks": dict(self.blocks.items()),
                "ln_f": self.ln_f, "lm_head": self.lm_head}
        if self.cross_blocks is not None:
            tree["cross_blocks"] = dict(self.cross_blocks.items())
        return tree

    def forward(self, batch: dict, layer_sync: LayerSync | StackSyncs | None = None,
                model_axis: ModelAxis = NO_MODEL_AXIS,
                fsdp: FsdpAxes = NO_FSDP) -> torch.Tensor:
        return train_forward(self.params_tree(), batch, self.cfg,
                             layer_sync=layer_sync, model_axis=model_axis, fsdp=fsdp)


# ------------------------------------------------------------------ serve
def _image(cfg: TransformerConfig, img_embeds: Optional[torch.Tensor]):
    """The serve functions' image embeddings in the model's dtype (None
    without cross blocks); a config with cross blocks needs them."""
    if not cfg.n_cross:
        return None
    if img_embeds is None:
        raise ValueError(f"{cfg.name}: the cross blocks need img_embeds")
    return img_embeds.to(cfg.dtype)


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            img_embeds: Optional[torch.Tensor] = None, last_pos: Optional[int] = None,
            model_axis: ModelAxis = NO_MODEL_AXIS, fsdp: FsdpAxes = NO_FSDP):
    """Full-sequence forward; returns (next_token_logits (B, V/tp), kv_cache):
    the logits of the rank's vocab shard.

    Cache layout: dict of (n_self, B, S, kv_local, hd) stacked tensors:
    the self blocks' (a cross block reads the image, which it projects
    anew each call).  ``img_embeds`` (B, n_img, d): the cross blocks'
    image embeddings.  ``last_pos`` selects which position's logits to
    return (the continuous engine right-pads prompts to a bucket and
    reads the true last token; causality keeps every earlier position
    independent of the padding).  None returns the last position's.
    At tp > 1 ``params`` are the rank's shards and ``model_axis`` its
    ``ModelAxis``; with ``cfg.fsdp`` ``fsdp`` is its ``FsdpAxes``, and each
    layer's dp shards are gathered before the layer runs.
    """
    img = _image(cfg, img_embeds)
    B, S = tokens.shape
    lay, hd = cfg.layout, cfg.hd
    x = embed_lookup(params["embed"], tokens, cfg.tp, model_axis).to(cfg.dtype)
    cos, sin = rope_angles(torch.arange(S, device=tokens.device), hd, cfg.rope_theta)
    shape = (cfg.n_self, B, S, lay.kv_local, hd)
    cache = {"k": torch.empty(shape, dtype=cfg.dtype, device=tokens.device),
             "v": torch.empty(shape, dtype=cfg.dtype, device=tokens.device)}
    for stack, li in _layer_order(cfg):
        if stack == "cross_blocks":
            x = cross_block(_layer(params, li, stack), x, cfg, img, model_axis, fsdp)
            continue
        x, _, k, v = self_block(_layer(params, li), x, cfg, (cos, sin), model_axis, fsdp)
        cache["k"][li] = k
        cache["v"][li] = v
    sel = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
    return _head(params, sel), cache


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos: int,
                cfg: TransformerConfig, *, img_embeds: Optional[torch.Tensor] = None,
                model_axis: ModelAxis = NO_MODEL_AXIS, fsdp: FsdpAxes = NO_FSDP):
    """One decode step.  token: (B,) int; pos: absolute position (int).

    cache: dict k/v of (n_self, B, Smax, kv_local, hd).  When Smax <
    pos+1 the cache is a ring buffer (sliding-window archs: Smax ==
    window).  The new k/v are written into ``cache`` in place.
    ``img_embeds`` (B, n_img, d): the cross blocks' image embeddings.
    ``model_axis`` and ``fsdp`` as ``prefill``'s.  Returns (next_logits
    (B, V/tp), cache).
    """
    img = _image(cfg, img_embeds)
    B = token.shape[0]
    smax = cache["k"].shape[2]
    slot = pos % smax
    kv_len = min(pos + 1, smax)
    win = cfg.swa_window if (cfg.swa_window and smax > cfg.swa_window) else None
    x = embed_lookup(params["embed"], token[:, None], cfg.tp, model_axis).to(cfg.dtype)
    cos, sin = rope_angles(torch.tensor([pos], device=token.device), cfg.hd,
                           cfg.rope_theta)
    for stack, li in _layer_order(cfg):
        if stack == "cross_blocks":
            x = cross_block(_layer(params, li, stack), x, cfg, img, model_axis, fsdp)
            continue
        p = fsdp_gather(_layer(params, li), cfg, fsdp)
        q, k, v = _attn_qkv(p, rms_norm(x, p["ln1"]), cfg, model_axis)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        o = attn_lib.decode_attention(q, kc, vc, kv_len, window=win)
        x = _mlp_residual(p, x, o.reshape(B, 1, -1), cfg, model_axis)[0]
    return _head(params, x), cache


def decode_step_paged(params: dict, pool_k: torch.Tensor, pool_v: torch.Tensor,
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      positions: torch.Tensor, cfg: TransformerConfig, *,
                      model_axis: ModelAxis = NO_MODEL_AXIS, fsdp: FsdpAxes = NO_FSDP):
    """One decode step over a paged KV pool with per-slot positions.

    pool_k/pool_v: (n_self, num_blocks, block_size, kv_local, hd), the
    physical block pool.  block_tables: (W, max_blocks) int block ids per
    slot; tokens: (W,) the token each slot consumes; positions: (W,) its
    absolute position.  Logical position ``p`` of slot ``w`` lives at
    flat pool row ``table[w, p // bs] * bs + p % bs``.  The per-position
    math is ``decode_step``'s with a per-slot kv_len.  The new k/v rows
    are written into the pools in place.  ``model_axis`` and ``fsdp`` as
    ``prefill``'s.  Returns (logits (W, V/tp), pool_k, pool_v).
    """
    if cfg.n_cross:
        raise ValueError(f"{cfg.name}: paged decode serves decoder-only archs, not "
                         f"cross-attention (the reference asserts the same)")
    W = tokens.shape[0]
    bs = pool_k.shape[2]
    MB = block_tables.shape[1]
    x = embed_lookup(params["embed"], tokens[:, None], cfg.tp, model_axis).to(cfg.dtype)
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
        p = fsdp_gather(_layer(params, li), cfg, fsdp)
        q, k, v = _attn_qkv(p, rms_norm(x, p["ln1"]), cfg, model_axis)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kf = pool_k[li].view(-1, *pool_k.shape[3:])
        vf = pool_v[li].view(-1, *pool_v.shape[3:])
        kf[wr] = k[:, 0]
        vf[wr] = v[:, 0]
        o = attn_lib.decode_attention(q, kf[gat], vf[gat], kv_len, window=win)
        x = _mlp_residual(p, x, o.reshape(W, 1, -1), cfg, model_axis)[0]
    return _head(params, x), pool_k, pool_v


def make_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> dict:
    """Empty KV cache of the rank's ``kv_local`` heads, on CUDA unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    lay = cfg.layout
    shape = (cfg.n_self, batch, max_len, lay.kv_local, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_state_specs(cfg: TransformerConfig, batch_entry) -> dict:
    """Which dim of each cache leaf is sharded over which axes (the
    reference's ``decode_state_specs``, in ``param_specs``' tuple form):
    the batch over ``batch_entry`` (the dp axes), the kv heads over
    "model".  With kv_heads < tp each rank holds the slice its q heads
    read, so the global dim is tp × kv_local with per-rank content."""
    s = (None, batch_entry, None, MODEL_AXIS, None)
    return {"k": s, "v": s}

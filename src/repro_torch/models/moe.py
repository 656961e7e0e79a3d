"""Mixture-of-Experts FFN with expert parallelism over the "model" axis
(``repro/models/moe.py``).

Activations are replicated over the model group inside a block, so the
dispatch needs no collective: every rank routes all its local tokens,
keeps the slots bound for its own experts (``axis.index · e_local`` on),
runs them, and one ``model_psum`` combines the ranks' contributions (one
more follows the shared experts).  Tokens go to slots by a sort over the
chosen expert ids, not through a (T, E, C) one-hot.

The reference's ops and their counterparts here: ``jnp.argsort`` is
stable, so ``torch.argsort(..., stable=True)``; ``searchsorted(...,
side="left")`` is ``right=False``; ``.at[slot].add(..., mode="drop")``
writes each kept slot once and drops the rest at the index ``e_local·C``,
here a gather into the slots through the inverse map (each slot's
entry), whose backward is a gather too (``_Route``); ``out.at[tok].add``
sums each token's K weighted rows, here in the order the reference's
scatter meets them (the sorted order: by expert id), as a sequential sum
over a (T, K, d) view.  No step scatters: no atomics, and none of
autograd's sort-based index accumulation.  ``jax.lax.top_k`` puts the lower
index first on ties; ``torch.topk`` promises no order, which matters only
where two router probabilities of a token are equal.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import (ACTIVATIONS, NO_MODEL_AXIS, ModelAxis, model_psum,
                                       swiglu)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int
    shared_experts: int = 0      # dense experts always active (kimi-k2: 1)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def capacity(tokens: int, cfg: MoECfg) -> int:
    """Slots an expert takes from ``tokens`` local tokens."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(c, 4)


class _Route(torch.autograd.Function):
    """Rows moved through a one-to-one map: ``out[i] = src[idx[i]]`` where
    ``valid[i]``, else 0, each row of ``src`` read at most once; the
    backward moves the cotangent back through the inverse map
    (``inv_idx``, ``inv_valid``).  A gather each way: no scatter, so no
    atomics and no sort-based accumulation."""

    @staticmethod
    def forward(ctx, src, idx, valid, inv_idx, inv_valid):
        ctx.save_for_backward(inv_idx, inv_valid)
        return _take(src, idx, valid)

    @staticmethod
    def backward(ctx, g):
        inv_idx, inv_valid = ctx.saved_tensors
        return _take(g, inv_idx, inv_valid), None, None, None, None


def _take(src: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], src[idx], torch.zeros((), dtype=src.dtype,
                                                             device=src.device))


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoECfg,
            axis: ModelAxis = NO_MODEL_AXIS) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) local tokens, replicated over the model group → (out (T,
    d), the load-balance aux loss, an f32 scalar).  ``p`` holds the
    rank's ``e_local`` experts (``w_gate``, ``w_up``, ``w_down``), the
    f32 ``router`` and, with shared experts, their column/row-parallel
    ``ws_g``, ``ws_u``, ``ws_down``."""
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    e_local = E // axis.size
    C = capacity(T, cfg)
    n_slots = e_local * C
    dev = x.device

    # ---- route (replicated) ----
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)       # (T, E)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)               # (T, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balance aux loss (Switch-style): E · Σ_e f_e · P_e; f_e counts
    # the routed ids (no gradient), P_e the mean router probability
    me = probs.mean(dim=0)
    flat_e = expert_ids.reshape(-1)                                      # (T·K,)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(T * K, dtype=torch.float32, device=dev)) / (T * K)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    # ---- sort-based slot assignment (the reference's), over the routed
    # entries in expert order: entry p's place in its expert, kept if < C
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos_in_e = torch.arange(T * K, device=dev) - first
    local_e = sorted_e - axis.index * e_local
    mine = (pos_in_e < C) & (local_e >= 0) & (local_e < e_local)
    slot = torch.where(mine, local_e * C + pos_in_e, n_slots)
    # the entries token-major, each token's K by expert id (the order the
    # reference's combine adds them in): q = t·K + j
    by_tok = torch.argsort(order // K, stable=True)
    slot_q = slot[by_tok].clamp(max=n_slots - 1)
    mine_q = mine[by_tok]
    # and each slot's entry: slot (e, c) holds expert e's c-th entry
    experts = torch.arange(e_local, device=dev) + axis.index * e_local
    e_first = torch.searchsorted(sorted_e, experts, right=False)
    e_count = torch.searchsorted(sorted_e, experts, right=True) - e_first
    c = torch.arange(C, device=dev)
    q_of_slot = torch.argsort(by_tok)[
        (e_first[:, None] + c).reshape(-1).clamp(max=T * K - 1)]
    slot_valid = (c < e_count[:, None]).reshape(-1)

    # ---- dispatch: each kept entry's token row into its slot ----
    xq = x.unsqueeze(1).expand(T, K, d).reshape(T * K, d)
    h = _Route.apply(xq, q_of_slot, slot_valid, slot_q, mine_q).view(e_local, C, d)

    # ---- expert FFN (e_local, C, d) ----
    if "w_up" in p:   # gated (SwiGLU) experts
        a = swiglu(torch.einsum("ecd,edf->ecf", h, p["w_gate"].to(x.dtype)),
                   torch.einsum("ecd,edf->ecf", h, p["w_up"].to(x.dtype)))
    else:
        a = ACTIVATIONS["gelu"](torch.einsum("ecd,edf->ecf", h, p["w_gate"].to(x.dtype)))
    y = torch.einsum("ecf,efd->ecd", a, p["w_down"].to(x.dtype)).reshape(n_slots, d)

    # ---- combine: each token's K slots gate-weighted and summed in order
    gates = gate_vals.reshape(-1)[order[by_tok]]
    yq = _Route.apply(y, slot_q, mine_q, q_of_slot, slot_valid)
    contrib = (yq * gates[:, None].to(yq.dtype)).view(T, K, d)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    out = model_psum(out, axis)                       # sum over the expert shards

    # ---- shared (always-on) experts, column/row parallel like a dense MLP ----
    if cfg.shared_experts and "ws_g" in p:
        a = swiglu(x @ p["ws_g"].to(x.dtype), x @ p["ws_u"].to(x.dtype))
        out = out + model_psum(a @ p["ws_down"].to(x.dtype), axis)
    return out, aux

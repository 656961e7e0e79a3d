"""kimi-k2-1t-a32b [moe] — 61L d=7168 64H (GQA kv=8) per-expert ff=2048,
vocab=163840, MoE 384 experts top-8 + 1 shared expert
[arXiv:2501.kimi2; unverified] (``repro/configs/kimi_k2_1t_a32b.py``).

About 1.03e12 parameters: the port runs it at its smoke size only, and
its full config as ``meta`` tensors (shapes, no memory).
"""
import torch

from repro_torch.configs.base import ArchSpec, FULL_ATTN_NOTE, lm_shapes
from repro_torch.models.moe import MoECfg
from repro_torch.models.transformer import TransformerConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="kimi-k2-1t-a32b",
        n_layers=61, d_model=7168, n_heads=64, kv_heads=8,
        d_ff=2048, vocab=163840, head_dim=112,
        rope_theta=50_000.0,
        moe=MoECfg(num_experts=384, top_k=8, d_expert=2048, shared_experts=1),
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="kimi-k2-smoke",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=32,
        vocab=97, head_dim=16,
        moe=MoECfg(num_experts=8, top_k=2, d_expert=32, shared_experts=1,
                   capacity_factor=2.0),
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="kimi-k2-1t-a32b",
    family="transformer",
    source="arXiv:2501.kimi2",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=False, long_note=FULL_ATTN_NOTE),
)

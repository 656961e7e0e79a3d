"""granite-moe-1b-a400m [moe] — 24L d=1024 16H (GQA kv=8) per-expert
ff=512, vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
(``repro/configs/granite_moe_1b_a400m.py``).  The port runs it at tp=1,
the whole model on one card (the reference's default tp=16 pads the
vocab to 49168).
"""
import torch

from repro_torch.configs.base import ArchSpec, FULL_ATTN_NOTE, lm_shapes
from repro_torch.models.moe import MoECfg
from repro_torch.models.transformer import TransformerConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, kv_heads=8,
        d_ff=512, vocab=49155, head_dim=64,
        rope_theta=10_000.0,
        moe=MoECfg(num_experts=32, top_k=8, d_expert=512),
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="granite-moe-smoke",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=64,
        vocab=97, head_dim=16,
        moe=MoECfg(num_experts=8, top_k=2, d_expert=32, capacity_factor=2.0),
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="granite-moe-1b-a400m",
    family="transformer",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=False, long_note=FULL_ATTN_NOTE),
)

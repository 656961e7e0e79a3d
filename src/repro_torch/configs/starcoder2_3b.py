"""starcoder2-3b [dense] — 30L d=3072 24H (GQA kv=2) ff=12288 vocab=49152,
RoPE, non-gated GELU FFN [arXiv:2402.19173; hf]
(``repro/configs/starcoder2_3b.py``).  The port runs it at tp=1, where
the 24 heads need no padding.
"""
import torch

from repro_torch.configs.base import ArchSpec, FULL_ATTN_NOTE, lm_shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="starcoder2-3b",
        n_layers=30, d_model=3072, n_heads=24, kv_heads=2,
        d_ff=12288, vocab=49152, head_dim=128,
        act="gelu", gated=False, rope_theta=999_999.0,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="starcoder2-smoke",
        n_layers=2, d_model=48, n_heads=3, kv_heads=1, d_ff=96,
        vocab=97, head_dim=16, act="gelu", gated=False,
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="starcoder2-3b",
    family="transformer",
    source="arXiv:2402.19173",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=False, long_note=FULL_ATTN_NOTE),
)

"""qwen3-1.7b [dense] — 28L d=2048 16H (GQA kv=8) ff=6144 vocab=151936,
qk-norm (per-head RMSNorm on q and k), head_dim=128
[hf:Qwen/Qwen3-8B; hf] (``repro/configs/qwen3_1_7b.py``).  The port runs
it at tp=1, the whole model on one card.
"""
import torch

from repro_torch.configs.base import ArchSpec, FULL_ATTN_NOTE, lm_shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="qwen3-1.7b",
        n_layers=28, d_model=2048, n_heads=16, kv_heads=8,
        d_ff=6144, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="qwen3-smoke",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=97, head_dim=16, qk_norm=True,
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="qwen3-1.7b",
    family="transformer",
    source="hf:Qwen/Qwen3-8B",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=False, long_note=FULL_ATTN_NOTE),
)

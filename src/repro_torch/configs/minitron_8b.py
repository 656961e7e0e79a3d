"""minitron-8b [dense] — 32L d=4096 32H (GQA kv=8) ff=16384 vocab=256000,
pruned nemotron: squared-ReLU non-gated FFN [arXiv:2407.14679; hf]
(``repro/configs/minitron_8b.py``).  The port runs it at tp=1.
"""
import torch

from repro_torch.configs.base import ArchSpec, FULL_ATTN_NOTE, lm_shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="minitron-8b",
        n_layers=32, d_model=4096, n_heads=32, kv_heads=8,
        d_ff=16384, vocab=256000, head_dim=128,
        act="relu2", gated=False, rope_theta=10_000.0,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="minitron-smoke",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=257, head_dim=16, act="relu2", gated=False,
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="minitron-8b",
    family="transformer",
    source="arXiv:2407.14679",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=False, long_note=FULL_ATTN_NOTE),
)

"""musicgen-large [audio] — 48L d=2048 32H (kv=32, i.e. MHA) ff=8192
vocab=2048, decoder-only over EnCodec tokens [arXiv:2306.05284; hf]
(``repro/configs/musicgen_large.py``).  The port runs it at tp=1.

The modality frontend is a stub: ``frame_embeds`` (B, S, d), precomputed
conditioning embeddings added to the token embeddings (training and
prefill; decode conditions on the tokens alone, as in the reference).
"""
import torch

from repro_torch.configs.base import ArchSpec, FULL_ATTN_NOTE, lm_shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="musicgen-large",
        n_layers=48, d_model=2048, n_heads=32, kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64,
        act="gelu", gated=False, frame_embeds=True,
        rope_theta=10_000.0,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="musicgen-smoke",
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=97, head_dim=16, act="gelu", gated=False, frame_embeds=True,
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="musicgen-large",
    family="transformer",
    source="arXiv:2306.05284",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=False, long_note=FULL_ATTN_NOTE),
    extra_inputs=(
        ("frame_embeds", lambda cfg, S: (S, cfg.d_model), torch.bfloat16),
    ),
)

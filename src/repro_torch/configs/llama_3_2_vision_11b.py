"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) ff=14336
vocab=128256, cross-attn image layers (8 of 40, gated) with a stub vision
frontend: ``img_embeds`` (B, 576, d) precomputed patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
(``repro/configs/llama_3_2_vision_11b.py``).  The port trains it at any
tp and serves it at any tp through ``prefill``/``decode_step``; the
engines take no images (as the reference's).
"""
import torch

from repro_torch.configs.base import ArchSpec, FULL_ATTN_NOTE, lm_shapes
from repro_torch.models.transformer import TransformerConfig

N_IMG = 576


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="llama-3.2-vision-11b",
        n_layers=40, d_model=4096, n_heads=32, kv_heads=8,
        d_ff=14336, vocab=128256, head_dim=128,
        rope_theta=500_000.0,
        cross_attn_every=4, n_img_tokens=N_IMG,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="llama-3.2-vision-smoke",
        n_layers=5, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=97, head_dim=16, cross_attn_every=4, n_img_tokens=8,
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="llama-3.2-vision-11b",
    family="transformer",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=False, long_note=FULL_ATTN_NOTE),
    extra_inputs=(
        ("img_embeds", lambda cfg, S: (N_IMG, cfg.d_model), torch.bfloat16),
    ),
    layer_pair=(5, 10, 5),   # one group = 4 self + 1 cross
)

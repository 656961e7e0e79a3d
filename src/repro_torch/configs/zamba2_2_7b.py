"""zamba2-2.7b [hybrid] — 54L d=2560 Mamba-2 backbone (d_inner=5120,
head_p=64 → 80 ssm heads, ssm_state=64) + shared attention block
(32H kv=32, hd=80, ff=10240) applied every 6 mamba layers with reused
weights [arXiv:2411.15242; hf] (``repro/configs/zamba2_2_7b.py``).
Hybrid state ⇒ long_500k runs (ssm state O(1); the shared-attention
sites use a 4096-slot ring KV cache).  The port trains and
serves it at any tp.
"""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.ssm import SSMConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="zamba2-2.7b",
        n_layers=54, d_model=2560, d_ff=10240, vocab=32000,
        ssm_state=64, head_p=64, expand=2, d_conv=4,
        attn_every=6, n_heads=32, kv_heads=32,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return SSMConfig(**kw)


def make_smoke():
    return SSMConfig(
        name="zamba2-smoke",
        n_layers=4, d_model=64, d_ff=128, vocab=97,
        ssm_state=16, head_p=16, attn_every=2, n_heads=4, kv_heads=4,
        chunk=16, tp=1, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="zamba2-2.7b",
    family="ssm",
    source="arXiv:2411.15242",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=True,
                     long_note="mamba2 O(1) state; shared-attn ring cache"),
    layer_pair=(6, 12, 6),   # one group = 6 mamba + 1 shared-attn site
)

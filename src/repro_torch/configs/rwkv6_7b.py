"""rwkv6-7b [ssm] — Finch: 32L d=4096 (attn-free) ff=14336 vocab=65536,
data-dependent per-channel decay [arXiv:2404.05892; hf]
(``repro/configs/rwkv6_7b.py``).  O(1) state ⇒ long_500k decode runs
natively.  The port trains and serves it at any tp.
"""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.rwkv import RWKVConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="rwkv6-7b",
        n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
        head_size=64, lora_w=64, lora_mix=32,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return RWKVConfig(**kw)


def make_smoke():
    return RWKVConfig(
        name="rwkv6-smoke",
        n_layers=2, d_model=64, d_ff=128, vocab=97,
        head_size=16, lora_w=8, lora_mix=4, chunk=16,
        tp=1, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="rwkv6-7b",
    family="rwkv",
    source="arXiv:2404.05892",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=True, long_note="O(1) recurrent state"),
)

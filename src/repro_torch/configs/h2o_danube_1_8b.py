"""h2o-danube-1.8b [dense] — 24L d=2560 32H (GQA kv=8) ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention (window 4096)
[arXiv:2401.16818; hf] (``repro/configs/h2o_danube_1_8b.py``).  The port
runs it at tp=1.
"""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

WINDOW = 4096


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="h2o-danube-1.8b",
        n_layers=24, d_model=2560, n_heads=32, kv_heads=8,
        d_ff=6912, vocab=32000, head_dim=80,
        swa_window=WINDOW, rope_theta=10_000.0,
        tp=tp, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return TransformerConfig(**kw)


def make_smoke():
    return TransformerConfig(
        name="h2o-danube-smoke",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=97, head_dim=16, swa_window=16,
        tp=1, attn_chunk=32, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="h2o-danube-1.8b",
    family="transformer",
    source="arXiv:2401.16818",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=lm_shapes(long_ok=True,
                     long_note="SWA ring cache bounded at window=4096"),
)

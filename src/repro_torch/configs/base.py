"""Config machinery (``repro/configs/base.py``): one ArchSpec per
architecture, with the shapes it is run at."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models.registry import family_of


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    applicable: bool = True
    note: str = ""


def lm_shapes(long_ok: bool, long_note: str = "") -> tuple[ShapeSpec, ...]:
    """The reference's standard LM shape grid."""
    return (
        ShapeSpec("train_4k", "train", 4096, 256),
        ShapeSpec("prefill_32k", "prefill", 32768, 32),
        ShapeSpec("decode_32k", "decode", 32768, 128),
        ShapeSpec("long_500k", "decode", 524288, 1,
                  applicable=long_ok, note=long_note),
    )


FULL_ATTN_NOTE = ("pure full attention: 512k decode KV cache is "
                  "O(seq x layers) with no sub-quadratic structure in the "
                  "assigned config — skipped per assignment rules "
                  "(DESIGN.md §6)")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    source: str                                   # citation tag
    make_config: Callable[..., Any]               # (tp, dp_axes, **overrides)
    make_smoke: Callable[[], Any]                 # tiny, tp=1
    shapes: tuple[ShapeSpec, ...]


def param_structs(cfg) -> Any:
    """The parameter tree on the ``meta`` device: shapes, no memory."""
    return family_of(cfg).init(cfg, device="meta")

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

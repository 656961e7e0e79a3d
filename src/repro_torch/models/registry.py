"""Uniform model-family API (``repro/models/registry.py``): each family
exposes the same hooks so the launchers and loops are family-agnostic.
Ported so far: ``resnet`` (training) and ``transformer`` (serving at
tp=1).  A hook a family does not have yet is None."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models import resnet as resnet_lib
from repro_torch.models import transformer as tf_lib


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable[..., Any]              # (cfg, *, seed, device) -> params tree
    in_scan_names: Callable[[Any], frozenset[str]]
    module: Optional[Callable[..., torch.nn.Module]] = None  # (cfg, params tree) -> module
    param_specs: Optional[Callable[[Any], Any]] = None      # params tree -> specs tree
    train_forward: Optional[Callable[..., torch.Tensor]] = None
    # serving hooks: (params, tokens, cfg, *, last_pos) -> (logits, cache)
    prefill: Optional[Callable[..., Any]] = None
    # (params, cache, token, pos, cfg) -> (logits, cache), cache in place
    decode_step: Optional[Callable[..., Any]] = None
    # (cfg, batch, max_len, device) -> empty cache
    make_decode_state: Optional[Callable[..., Any]] = None
    # paged (block-table) decode for the continuous-batching engine
    decode_paged: Optional[Callable[..., Any]] = None


def _tf_make_state(cfg, batch, max_len, device="cuda"):
    # sliding-window archs: ring cache bounded at the window size
    if getattr(cfg, "swa_window", None):
        max_len = min(max_len, cfg.swa_window)
    return tf_lib.make_cache(cfg, batch, max_len, device)


FAMILIES: dict[str, ModelAPI] = {
    "transformer": ModelAPI(
        family="transformer",
        init=tf_lib.init_params,
        in_scan_names=tf_lib.in_scan_param_names,
        prefill=tf_lib.prefill,
        decode_step=tf_lib.decode_step,
        make_decode_state=_tf_make_state,
        decode_paged=tf_lib.decode_step_paged,
    ),
    "resnet": ModelAPI(
        family="resnet",
        init=resnet_lib.init_params,
        in_scan_names=resnet_lib.in_scan_param_names,
        module=resnet_lib.ResNet,
        param_specs=resnet_lib.param_specs,
        train_forward=resnet_lib.train_forward,
    ),
}


def family_of(cfg) -> ModelAPI:
    if isinstance(cfg, tf_lib.TransformerConfig):
        return FAMILIES["transformer"]
    if isinstance(cfg, resnet_lib.ResNetConfig):
        return FAMILIES["resnet"]
    raise TypeError(f"no ported model family for config type {type(cfg)}")

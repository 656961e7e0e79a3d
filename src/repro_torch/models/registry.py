"""Uniform model-family API (``repro/models/registry.py``): each family
exposes the same hooks so the launchers and loops are family-agnostic.
Ported so far: ``resnet`` and ``inception`` (training), ``transformer``
(training and serving at tp=1) and ``rwkv`` (serving at tp=1).  A hook a family does
not have yet is None."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models import resnet as resnet_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import transformer as tf_lib


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable[..., Any]              # (cfg, *, seed, device) -> params tree
    in_scan_names: Callable[[Any], frozenset[str]]
    module: Optional[Callable[..., torch.nn.Module]] = None  # (cfg, params tree) -> module
    param_specs: Optional[Callable[[Any, Any], Any]] = None  # (params tree, cfg) -> specs tree
    train_forward: Optional[Callable[..., torch.Tensor]] = None
    # (cfg, params tree, mesh, device) -> core.overlap.LayerSync | None: the
    # in-backward sync of the leaves ``in_scan_names`` gives (depcha)
    layer_sync: Optional[Callable[..., Any]] = None
    # serving hooks: (params, tokens, cfg, *, last_pos) -> (logits, cache)
    prefill: Optional[Callable[..., Any]] = None
    # (params, cache, token, pos, cfg) -> (logits, cache), cache in place
    decode_step: Optional[Callable[..., Any]] = None
    # (cfg, batch, max_len, device) -> empty cache
    make_decode_state: Optional[Callable[..., Any]] = None
    # paged (block-table) decode for the continuous-batching engine
    decode_paged: Optional[Callable[..., Any]] = None
    # cache leaves laid out (L, B, S, ...) that the static batcher grows
    # from the prompt length to max_len; recurrent state is not listed
    seq_cache_leaves: tuple[str, ...] = ()


def _tf_make_state(cfg, batch, max_len, device="cuda"):
    # sliding-window archs: ring cache bounded at the window size
    if getattr(cfg, "swa_window", None):
        max_len = min(max_len, cfg.swa_window)
    return tf_lib.make_cache(cfg, batch, max_len, device)


def _rwkv_make_state(cfg, batch, max_len, device="cuda"):
    return rwkv_lib.make_state(cfg, batch, device)


FAMILIES: dict[str, ModelAPI] = {
    "transformer": ModelAPI(
        family="transformer",
        init=tf_lib.init_params,
        in_scan_names=tf_lib.in_scan_param_names,
        module=tf_lib.Transformer,
        param_specs=tf_lib.param_specs,
        train_forward=tf_lib.train_forward,
        layer_sync=tf_lib.layer_sync,
        prefill=tf_lib.prefill,
        decode_step=tf_lib.decode_step,
        make_decode_state=_tf_make_state,
        decode_paged=tf_lib.decode_step_paged,
        seq_cache_leaves=("k", "v"),
    ),
    "rwkv": ModelAPI(
        family="rwkv",
        init=rwkv_lib.init_params,
        in_scan_names=rwkv_lib.in_scan_param_names,
        prefill=rwkv_lib.prefill,
        decode_step=rwkv_lib.decode_step,
        make_decode_state=_rwkv_make_state,
    ),
    "resnet": ModelAPI(
        family="resnet",
        init=resnet_lib.init_params,
        in_scan_names=resnet_lib.in_scan_param_names,
        module=resnet_lib.ResNet,
        param_specs=resnet_lib.param_specs,
        train_forward=resnet_lib.train_forward,
    ),
    "inception": ModelAPI(
        family="inception",
        init=resnet_lib.init_inception,
        in_scan_names=resnet_lib.in_scan_param_names,
        module=resnet_lib.Inception,
        param_specs=resnet_lib.param_specs,
        train_forward=resnet_lib.inception_train_forward,
    ),
}


def family_of(cfg) -> ModelAPI:
    if isinstance(cfg, tf_lib.TransformerConfig):
        return FAMILIES["transformer"]
    if isinstance(cfg, rwkv_lib.RWKVConfig):
        return FAMILIES["rwkv"]
    if isinstance(cfg, resnet_lib.ResNetConfig):
        return FAMILIES["resnet"]
    if isinstance(cfg, resnet_lib.InceptionConfig):
        return FAMILIES["inception"]
    raise TypeError(f"no ported model family for config type {type(cfg)}")

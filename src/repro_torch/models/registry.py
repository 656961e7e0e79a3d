"""Uniform model-family API (``repro/models/registry.py``): each family
exposes the same hooks so the launcher and train loop are
family-agnostic.  Only ``resnet`` is ported so far."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import resnet as resnet_lib


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    family: str
    init: Callable[..., Any]              # (cfg, *, seed, device) -> params tree
    module: Callable[..., torch.nn.Module]  # (cfg, params tree) -> module
    param_specs: Callable[[Any], Any]     # params tree -> specs tree
    in_scan_names: Callable[[Any], frozenset[str]]
    train_forward: Callable[..., torch.Tensor]


FAMILIES: dict[str, ModelAPI] = {
    "resnet": ModelAPI(
        family="resnet",
        init=resnet_lib.init_params,
        module=resnet_lib.ResNet,
        param_specs=resnet_lib.param_specs,
        in_scan_names=resnet_lib.in_scan_param_names,
        train_forward=resnet_lib.train_forward,
    ),
}


def family_of(cfg) -> ModelAPI:
    if isinstance(cfg, resnet_lib.ResNetConfig):
        return FAMILIES["resnet"]
    raise TypeError(f"no ported model family for config type {type(cfg)}")

"""Architecture registry (``repro/configs``): the archs ported so far.

``--arch <id>`` resolves through ``get_arch``.
"""
from repro_torch.configs.base import (
    FULL_ATTN_NOTE,
    ArchSpec,
    ShapeSpec,
    lm_shapes,
    param_structs,
)
from repro_torch.configs.h2o_danube_1_8b import ARCH as _danube
from repro_torch.configs.inception_bn_imagenet import ARCH as _inception
from repro_torch.configs.minitron_8b import ARCH as _minitron
from repro_torch.configs.musicgen_large import ARCH as _musicgen
from repro_torch.configs.qwen3_1_7b import ARCH as _qwen3
from repro_torch.configs.resnet50_cifar import ARCH as _resnet
from repro_torch.configs.rwkv6_7b import ARCH as _rwkv6
from repro_torch.configs.starcoder2_3b import ARCH as _starcoder2

ARCHS = {a.arch_id: a for a in (_qwen3, _resnet, _inception, _rwkv6, _minitron,
                                _danube, _starcoder2, _musicgen)}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; ported so far: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "FULL_ATTN_NOTE", "ArchSpec", "ShapeSpec", "get_arch",
           "lm_shapes", "param_structs"]

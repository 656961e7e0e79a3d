"""Architecture registry (``repro/configs``): the archs ported so far.

``--arch <id>`` resolves through ``get_arch``.
"""
from repro_torch.configs.base import ArchSpec, ShapeSpec, param_structs
from repro_torch.configs.resnet50_cifar import ARCH as _resnet

ARCHS = {a.arch_id: a for a in (_resnet,)}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; ported so far: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "ShapeSpec", "get_arch", "param_structs"]

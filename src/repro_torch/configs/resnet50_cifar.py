"""resnet50-cifar — the paper's own CIFAR model (He et al., §5.1).
Pure data-parallel (one worker per device), BatchNorm local per worker —
the setting of paper Figs 13/16 (``repro/configs/resnet50_cifar.py``).
"""

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.resnet import ResNetConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="resnet50-cifar",
        stages=(3, 4, 6, 3), widths=(256, 512, 1024, 2048),
        num_classes=10, img_size=32,
        tp=1, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return ResNetConfig(**kw)


def make_smoke():
    return ResNetConfig(
        name="resnet50-smoke",
        stages=(1, 1), widths=(32, 64), stem_width=16,
        num_classes=10, img_size=16, tp=1)


ARCH = ArchSpec(
    arch_id="resnet50-cifar",
    family="resnet",
    source="arXiv:1512.03385 (paper §5.1)",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=(
        ShapeSpec("train_cifar", "train", 0, 256),
    ),
)

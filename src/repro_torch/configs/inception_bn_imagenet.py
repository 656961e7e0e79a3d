"""inception-bn-imagenet — the paper's Inception-BN ImageNet-1K model
(§5.2, Fig 14), compact mixed-branch variant.  Pure data-parallel
(``repro/configs/inception_bn_imagenet.py``).
"""

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.resnet import InceptionConfig


def make_config(tp: int = 1, dp_axes=("data",), **over):
    kw = dict(
        name="inception-bn-imagenet",
        num_classes=1000, img_size=224, width_mult=1.0,
        tp=1, dp_axes=tuple(dp_axes),
    )
    kw.update(over)
    return InceptionConfig(**kw)


def make_smoke():
    return InceptionConfig(
        name="inception-smoke",
        num_classes=10, img_size=32, width_mult=0.25, tp=1)


ARCH = ArchSpec(
    arch_id="inception-bn-imagenet",
    family="inception",
    source="paper §5.2 (Inception-BN)",
    make_config=make_config,
    make_smoke=make_smoke,
    shapes=(
        ShapeSpec("train_imagenet", "train", 0, 256),
    ),
)

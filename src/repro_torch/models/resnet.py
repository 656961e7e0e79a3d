"""The paper's ResNet-50 (He et al. 2015) for the CIFAR reproduction — the
port of ``repro/models/resnet.py`` (ResNet only; Inception-BN comes in a
later slice).

Pure data-parallel: params replicated, gradients summed over the DP
axes by the strategy under test, the paper's setting.  BatchNorm always
uses the batch's own statistics (local to the worker, no running
stats), with the biased variance, as the reference does.

Layouts stay the reference's at every public function, so gradients,
bucket plans and comm buffers compare exactly: images ``(B, H, W, 3)``,
conv weights ``(kh, kw, cin, cout)`` (HWIO), ``head`` ``(cin, classes)``.
``forward`` permutes to NCHW inside.  Convolutions pad like XLA's
"SAME": for a 3×3 stride-2 conv on an even input that is (0, 1), not
(1, 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dependency import resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    stages: tuple[int, ...] = (3, 4, 6, 3)      # ResNet-50
    widths: tuple[int, ...] = (256, 512, 1024, 2048)
    stem_width: int = 64
    num_classes: int = 10
    img_size: int = 32
    dtype: Any = torch.float32
    tp: int = 1                                  # unused (DP-only); kept for API
    dp_axes: tuple[str, ...] = ("data",)
    depcha_in_scan: bool = False                 # convnets: no layer scan


def init_params(cfg: ResNetConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """The reference's parameter tree, drawn from a CPU ``torch.Generator``
    seeded with ``seed`` (so every device gets the same weights) and then
    moved to ``device``: CUDA unless the caller asks for the CPU.  On the
    ``meta`` device only shapes are made."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.dtype

    def dense(shape, in_dim):
        if device.type == "meta":
            return torch.empty(shape, dtype=dt, device=device)
        w = torch.randn(shape, generator=gen, dtype=torch.float32) / math.sqrt(in_dim)
        return w.to(dtype=dt, device=device)

    def conv(k, cin, cout):
        return dense((k, k, cin, cout), k * k * cin)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    params: dict[str, Any] = {"stem": {
        "conv": conv(3, 3, cfg.stem_width),
        "bn_s": ones(cfg.stem_width), "bn_b": zeros(cfg.stem_width)}}
    cin = cfg.stem_width
    for si, (n, w) in enumerate(zip(cfg.stages, cfg.widths)):
        blocks = []
        for _ in range(n):
            mid = w // 4
            blk = {
                "c1": conv(1, cin, mid), "bn1s": ones(mid), "bn1b": zeros(mid),
                "c2": conv(3, mid, mid), "bn2s": ones(mid), "bn2b": zeros(mid),
                "c3": conv(1, mid, w), "bn3s": ones(w), "bn3b": zeros(w),
            }
            if cin != w:
                blk["proj"] = conv(1, cin, w)
            blocks.append(blk)
            cin = w
        params[f"stage{si}"] = blocks
    params["head"] = dense((cin, cfg.num_classes), cin)
    return params


def param_specs(params: dict) -> dict:
    """Every leaf replicated (DP only): the spec ``()``."""
    from repro_torch.utils.trees import tree_map_with_names

    return tree_map_with_names(lambda _n, _l: (), params)


def in_scan_param_names(params) -> frozenset[str]:
    return frozenset()


def _bn(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batch-statistics BatchNorm over (N, H, W) of an NCHW tensor."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + 1e-5) * s[None, :, None, None]
            + b[None, :, None, None])


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding (low, high) along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: NCHW, w: HWIO → NCHW, padded like ``lax.conv_general_dilated``
    with "SAME"."""
    ph = _same_pads(x.shape[2], w.shape[0], stride)
    pw = _same_pads(x.shape[3], w.shape[1], stride)
    wt = w.permute(3, 2, 0, 1)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, wt, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), wt, stride=stride)


def _bottleneck(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(_bn(conv2d_same(x, p["c1"]), p["bn1s"], p["bn1b"]))
    h = F.relu(_bn(conv2d_same(h, p["c2"], stride), p["bn2s"], p["bn2b"]))
    h = _bn(conv2d_same(h, p["c3"]), p["bn3s"], p["bn3b"])
    sc = x
    if "proj" in p:
        sc = conv2d_same(x, p["proj"], stride)
    elif stride != 1:
        sc = x[:, :, ::stride, ::stride]
    return F.relu(h + sc)


def forward(params: dict, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """images: (B, H, W, 3) → logits (B, classes)."""
    stem = params["stem"]
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(conv2d_same(x, stem["conv"]), stem["bn_s"], stem["bn_b"]))
    for si, n in enumerate(cfg.stages):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _bottleneck(params[f"stage{si}"][bi], x, stride)
    x = x.mean(dim=(2, 3))
    return x @ params["head"]


def train_forward(params: dict, batch: dict, cfg: ResNetConfig) -> torch.Tensor:
    """Summed NLL over the local batch divided by the GLOBAL batch size,
    so a sum-allreduce of the gradients is their mean."""
    logits = forward(params, batch["images"], cfg).to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, batch["labels"].long()[:, None])[:, 0]
    return nll.sum() / batch["global_tokens"]


class ResNet(nn.Module):
    """The parameter tree as an ``nn.Module``.  ``params_tree()`` gives
    the reference's nested dict/list layout (so ``flatten_with_names``
    yields the reference's leaf names); ``forward(images)`` is the
    functional ``forward`` over it."""

    def __init__(self, cfg: ResNetConfig, params: dict):
        super().__init__()
        self.cfg = cfg

        def pdict(d: dict) -> nn.ParameterDict:
            return nn.ParameterDict({k: nn.Parameter(v) for k, v in d.items()})

        self.stem = pdict(params["stem"])
        for si in range(len(cfg.stages)):
            setattr(self, f"stage{si}",
                    nn.ModuleList([pdict(b) for b in params[f"stage{si}"]]))
        self.head = nn.Parameter(params["head"])

    def params_tree(self) -> dict:
        tree: dict[str, Any] = {"stem": dict(self.stem.items()),
                                "head": self.head}
        for si in range(len(self.cfg.stages)):
            tree[f"stage{si}"] = [dict(b.items())
                                  for b in getattr(self, f"stage{si}")]
        return tree

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.params_tree(), images, self.cfg)

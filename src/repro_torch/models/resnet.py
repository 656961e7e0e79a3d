"""The paper's evaluation models — the port of ``repro/models/resnet.py``:
ResNet-50 (He et al. 2015) for the CIFAR reproduction (paper §5.1) and
the compact Inception-BN-style net for ImageNet (§5.2, Fig 14).

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


def _initializers(dt, device: torch.device, seed: int):
    """(dense, conv) drawers over one CPU ``torch.Generator`` seeded with
    ``seed`` (so every device gets the same weights), each result moved to
    ``device``; on the ``meta`` device only shapes are made."""
    gen = torch.Generator().manual_seed(seed)

    def dense(shape, in_dim):
        if device.type == "meta":
            return torch.empty(shape, dtype=dt, device=device)
        w = torch.randn(shape, generator=gen, dtype=torch.float32) / math.sqrt(in_dim)
        return w.to(dtype=dt, device=device)

    def conv(k, cin, cout):
        return dense((k, k, cin, cout), k * k * cin)

    return dense, conv


def init_params(cfg: ResNetConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """The reference's parameter tree, drawn from a CPU ``torch.Generator``
    seeded with ``seed`` (so every device gets the same weights) and then
    moved to ``device``: CUDA unless the caller asks for the CPU.  On the
    ``meta`` device only shapes are made."""
    device = resolve_device(device)
    dt = cfg.dtype
    dense, conv = _initializers(dt, device, seed)

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


def param_specs(params: dict, cfg: ResNetConfig | None = None) -> dict:
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


def _global_nll(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Summed NLL over the local batch divided by the GLOBAL batch size,
    so a sum-allreduce of the gradients is their mean."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(1, batch["labels"].long()[:, None])[:, 0]
    return nll.sum() / batch["global_tokens"]


def train_forward(params: dict, batch: dict, cfg: ResNetConfig) -> torch.Tensor:
    """The loss of ``forward`` over the batch (``_global_nll``)."""
    return _global_nll(forward(params, batch["images"], cfg), batch)


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


# ------------------------------------------------------- Inception-BN-ish
@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    name: str
    num_classes: int = 1000
    img_size: int = 224
    width_mult: float = 1.0
    dtype: Any = torch.float32
    tp: int = 1
    dp_axes: tuple[str, ...] = ("data",)
    depcha_in_scan: bool = False


MIX_WIDTHS = (64, 128, 128, 256, 256, 512)   # each mixed block's nominal width


def init_inception(cfg: InceptionConfig, *, seed: int = 0,
                   device: str | torch.device = "cuda") -> dict:
    """A compact Inception-BN-style net: stem + 6 mixed blocks of four
    branches (1×1; 1×1 → 3×3; 1×1 → 3×3 → 3×3; a 1×1 "pool" branch), one
    BatchNorm over the concatenated branches.  Drawn as ``init_params``
    draws, in the reference's order (stem, the blocks, head)."""
    device = resolve_device(device)
    dt = cfg.dtype
    dense, conv = _initializers(dt, device, seed)

    def w(c):
        return int(c * cfg.width_mult)

    params: dict[str, Any] = {
        "stem": conv(3, 3, w(64)),
        "stem_bn_s": torch.ones(w(64), dtype=dt, device=device),
        "stem_bn_b": torch.zeros(w(64), dtype=dt, device=device),
    }
    cin = w(64)
    for bi, cout in enumerate(MIX_WIDTHS):
        c = w(cout)
        cat = c // 4 + c // 2 + c // 8 + c // 8
        params[f"mix{bi}"] = {
            "b1": conv(1, cin, c // 4),
            "b3a": conv(1, cin, c // 4),
            "b3b": conv(3, c // 4, c // 2),
            "b5a": conv(1, cin, c // 8),
            "b5b": conv(3, c // 8, c // 8),
            "b5c": conv(3, c // 8, c // 8),
            "bp": conv(1, cin, c // 8),
            "bn_s": torch.ones(cat, dtype=dt, device=device),
            "bn_b": torch.zeros(cat, dtype=dt, device=device),
        }
        cin = cat
    params["head"] = dense((cin, cfg.num_classes), cin)
    return params


def inception_forward(params: dict, images: torch.Tensor,
                      cfg: InceptionConfig) -> torch.Tensor:
    """images: (B, H, W, 3) → logits (B, classes).  The even blocks
    downsample (stride 2 on every branch's last conv)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(conv2d_same(x, params["stem"], 2),
                   params["stem_bn_s"], params["stem_bn_b"]))
    for bi in range(len(MIX_WIDTHS)):
        p = params[f"mix{bi}"]
        stride = 2 if bi % 2 == 0 else 1
        b1 = conv2d_same(x, p["b1"], stride)
        b3 = conv2d_same(F.relu(conv2d_same(x, p["b3a"])), p["b3b"], stride)
        b5 = F.relu(conv2d_same(x, p["b5a"]))
        b5 = F.relu(conv2d_same(b5, p["b5b"]))
        b5 = conv2d_same(b5, p["b5c"], stride)
        bp = conv2d_same(x, p["bp"], stride)
        x = F.relu(_bn(torch.cat([b1, b3, b5, bp], dim=1), p["bn_s"], p["bn_b"]))
    x = x.mean(dim=(2, 3))
    return x @ params["head"]


def inception_train_forward(params: dict, batch: dict,
                            cfg: InceptionConfig) -> torch.Tensor:
    """The loss of ``inception_forward`` over the batch (``_global_nll``)."""
    return _global_nll(inception_forward(params, batch["images"], cfg), batch)


class Inception(nn.Module):
    """The Inception tree as an ``nn.Module``, as ``ResNet``: the reference's
    leaf names through ``params_tree()``, ``forward(images)`` the
    functional ``inception_forward``."""

    def __init__(self, cfg: InceptionConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for k in ("stem", "stem_bn_s", "stem_bn_b", "head"):
            setattr(self, k, nn.Parameter(params[k]))
        for bi in range(len(MIX_WIDTHS)):
            setattr(self, f"mix{bi}", nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in params[f"mix{bi}"].items()}))

    def params_tree(self) -> dict:
        tree: dict[str, Any] = {k: getattr(self, k) for k in
                                ("stem", "stem_bn_s", "stem_bn_b", "head")}
        for bi in range(len(MIX_WIDTHS)):
            tree[f"mix{bi}"] = dict(getattr(self, f"mix{bi}").items())
        return tree

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return inception_forward(self.params_tree(), images, self.cfg)

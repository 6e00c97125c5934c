"""PP-LCNetV3 backbone — exact deploy (re-parameterized) topology.

Counterpart of ``oar_ocr_tpu/models/lcnetv3.py`` (same structure, widths
and parameter names as PaddleOCR's ``rec_lcnetv3.py`` deploy export).
NCHW inside. Det runs it at scale 0.75 (``detector.py:72``), rec at 0.95
(``recognizer.py:106``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvBNLayer, SEModule, hswish

NET_CONFIG_DET = {
    "blocks2": [(3, 16, 32, (1, 1), False)],
    "blocks3": [(3, 32, 64, (2, 2), False), (3, 64, 64, (1, 1), False)],
    "blocks4": [(3, 64, 128, (2, 2), False), (3, 128, 128, (1, 1), False)],
    "blocks5": [(3, 128, 256, (2, 2), False), (5, 256, 256, (1, 1), False),
                (5, 256, 256, (1, 1), False), (5, 256, 256, (1, 1), False),
                (5, 256, 256, (1, 1), False)],
    "blocks6": [(5, 256, 512, (2, 2), True), (5, 512, 512, (1, 1), True),
                (5, 512, 512, (1, 1), False), (5, 512, 512, (1, 1), False)],
}
NET_CONFIG_REC = {
    "blocks2": [(3, 16, 32, (1, 1), False)],
    "blocks3": [(3, 32, 64, (1, 1), False), (3, 64, 64, (1, 1), False)],
    "blocks4": [(3, 64, 128, (2, 1), False), (3, 128, 128, (1, 1), False)],
    "blocks5": [(3, 128, 256, (1, 2), False), (5, 256, 256, (1, 1), False),
                (5, 256, 256, (1, 1), False), (5, 256, 256, (1, 1), False),
                (5, 256, 256, (1, 1), False)],
    "blocks6": [(5, 256, 512, (2, 1), True), (5, 512, 512, (1, 1), True),
                (5, 512, 512, (2, 1), False), (5, 512, 512, (1, 1), False)],
}
DET_MV_C = (16, 24, 56, 480)


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class LearnableAffineBlock(nn.Module):
    """y = scale·x + bias with scalar parameters (LAB)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.bias


class ActLAB(nn.Module):
    """hardswish then an affine block (``rec_lcnetv3`` ``Act``)."""

    def __init__(self):
        super().__init__()
        self.lab = LearnableAffineBlock()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lab(hswish(x))


class LearnableRepLayer(nn.Module):
    """Deploy form: ``reparam_conv`` (with bias) → lab → hardswish +
    ``act.lab`` unless the stride is (2, 2)."""

    def __init__(self, in_c: int, out_c: int, k: int,
                 stride: Tuple[int, int] = (1, 1), groups: int = 1):
        super().__init__()
        self.reparam_conv = nn.Conv2d(in_c, out_c, k, stride,
                                      padding=k // 2, groups=groups)
        self.lab = LearnableAffineBlock()
        self.has_act = tuple(stride) != (2, 2)
        if self.has_act:
            self.act = ActLAB()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.lab(self.reparam_conv(x))
        return self.act(x) if self.has_act else x


class LCNetV3Block(nn.Module):
    """dw LearnableRepLayer → (SE) → pw LearnableRepLayer."""

    def __init__(self, in_c: int, out_c: int, k: int,
                 stride: Tuple[int, int], use_se: bool):
        super().__init__()
        self.dw_conv = LearnableRepLayer(in_c, in_c, k, stride, groups=in_c)
        self.use_se = use_se
        if use_se:
            self.se = SEModule(in_c)
        self.pw_conv = LearnableRepLayer(in_c, out_c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dw_conv(x)
        if self.use_se:
            x = self.se(x)
        return self.pw_conv(x)


class PPLCNetV3(nn.Module):
    """``mode="det"``: the four projected pyramid features (strides
    4/8/16/32); ``mode="rec"``: (N, C, 1, W/8) after the (3, 2) average
    pool. NCHW in and out."""

    def __init__(self, scale: float = 0.95, mode: str = "rec"):
        super().__init__()
        if mode not in ("det", "rec"):
            raise ValueError(f"unknown PPLCNetV3 mode {mode!r}")
        self.mode = mode
        cfg = NET_CONFIG_DET if mode == "det" else NET_CONFIG_REC
        ch = lambda c: make_divisible(c * scale)  # noqa: E731
        self.conv1 = ConvBNLayer(3, ch(16), 3, 2)
        for stage, blocks in cfg.items():
            setattr(self, stage, nn.Sequential(*[
                LCNetV3Block(ch(in_c), ch(out_c), k, stride, se)
                for (k, in_c, out_c, stride, se) in blocks]))
        if mode == "det":
            self.layer_list = nn.ModuleList([
                nn.Conv2d(ch(cfg[f"blocks{i}"][-1][2]),
                          int(DET_MV_C[i - 3] * scale), 1)
                for i in range(3, 7)])
            self.out_channels = [int(c * scale) for c in DET_MV_C]
        else:
            self.out_channels = ch(512)

    def forward(self, x: torch.Tensor):
        x = self.blocks2(self.conv1(x))
        feats: List[torch.Tensor] = []
        for stage in ("blocks3", "blocks4", "blocks5", "blocks6"):
            x = getattr(self, stage)(x)
            feats.append(x)
        if self.mode == "det":
            return [proj(f) for proj, f in zip(self.layer_list, feats)]
        return F.avg_pool2d(x, (3, 2))

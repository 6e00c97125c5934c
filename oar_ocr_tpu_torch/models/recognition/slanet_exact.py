"""PP-LCNet v1 building blocks at the official tensor names.

Counterpart of two parts of
``oar_ocr_tpu/models/recognition/slanet_exact.py``: the PP-LCNet v1
blocks (:56-110: ``hardswish``, ``PPLCNET_V1_CONFIG``, ``PPLCNetConvBN``
and ``DepthwiseSeparable``), which the PP-LCNet v1 classifiers
(``models/classification/pp_lcnet_exact.py``) and PicoDet's backbone are
made of, and the CSP-PAN pieces (:134-214: ``CSPConvBN``, ``DPModule``,
``DarknetBottleneck``, ``CSPLayer`` and ``_upsample_nearest``), which
PicoDet's neck is made of (``models/detection/picodet_exact.py``).
SLANet itself (its ``CSPPAN`` and ``SLAHead``) comes with the tables.
NCHW inside; attribute names are the Paddle attribute paths, so
``runtime/weights.params_from_jax`` maps the JAX parameters onto them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FrozenBatchNorm2d, SEModule, conv_bn


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x·clip(x + 3, 0, 6)/6."""
    return F.hardswish(x)


# (kernel, in_c, out_c, stride, use_se) — PaddleClas PP-LCNet NET_CONFIG.
PPLCNET_V1_CONFIG = {
    "blocks2": [(3, 16, 32, 1, False)],
    "blocks3": [(3, 32, 64, 2, False), (3, 64, 64, 1, False)],
    "blocks4": [(3, 64, 128, 2, False), (3, 128, 128, 1, False)],
    "blocks5": [(3, 128, 256, 2, False), (5, 256, 256, 1, False),
                (5, 256, 256, 1, False), (5, 256, 256, 1, False),
                (5, 256, 256, 1, False), (5, 256, 256, 1, False)],
    "blocks6": [(5, 256, 512, 2, True), (5, 512, 512, 1, True)],
}


class PPLCNetConvBN(nn.Module):
    """conv (no bias, symmetric k//2 padding) + bn (+hardswish) with the
    PP-LCNet attribute names."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride,
                              padding=kernel // 2, groups=groups, bias=False)
        self.bn = FrozenBatchNorm2d(out_c)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn(x, self.conv, self.bn)
        return hardswish(x) if self.act else x


class DepthwiseSeparable(nn.Module):
    """dw_conv → (se) → pw_conv (PaddleClas pp_lcnet DepthwiseSeparable);
    the SE block is PP-LCNet's (float32 mean, hardsigmoid(0.2, 0.5))."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int,
                 use_se: bool):
        super().__init__()
        self.dw_conv = PPLCNetConvBN(in_c, in_c, kernel, stride,
                                     groups=in_c)
        self.use_se = use_se
        if use_se:
            self.se = SEModule(in_c)
        self.pw_conv = PPLCNetConvBN(in_c, out_c, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dw_conv(x)
        if self.use_se:
            x = self.se(x)
        return self.pw_conv(x)


# ----------------------------- CSP-PAN pieces -----------------------------


class CSPConvBN(nn.Module):
    """csp_pan ConvBNLayer: conv (no bias, k//2 padding) + bn + hardswish
    (``slanet_exact.py:134-154``)."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride,
                              padding=kernel // 2, groups=groups, bias=False)
        self.bn = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hardswish(conv_bn(x, self.conv, self.bn))


class DPModule(nn.Module):
    """Depthwise-pointwise pair: dwconv/bn1 → pwconv/bn2, hardswish after
    each bn (csp_pan DPModule, ``slanet_exact.py:157-180``); the depthwise
    convolution keeps the channel count, so the input has ``features``
    channels."""

    def __init__(self, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.dwconv = nn.Conv2d(features, features, kernel, stride,
                                padding=kernel // 2, groups=features,
                                bias=False)
        self.bn1 = FrozenBatchNorm2d(features)
        self.pwconv = nn.Conv2d(features, features, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = hardswish(conv_bn(x, self.dwconv, self.bn1))
        return hardswish(conv_bn(x, self.pwconv, self.bn2))


class DarknetBottleneck(nn.Module):
    """conv1 (1×1) → conv2 (DPModule k) + identity (csp_pan,
    ``slanet_exact.py:183-194``)."""

    def __init__(self, features: int, kernel: int = 5):
        super().__init__()
        self.conv1 = CSPConvBN(features, features, 1)
        self.conv2 = DPModule(features, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.conv1(x))


class CSPLayer(nn.Module):
    """main/short 1×1 split, bottleneck chain, 1×1 fuse of
    [main ‖ short] (csp_pan, ``slanet_exact.py:197-214``)."""

    def __init__(self, in_c: int, features: int, kernel: int = 5,
                 num_blocks: int = 1):
        super().__init__()
        mid = features // 2
        self.short_conv = CSPConvBN(in_c, mid, 1)
        self.main_conv = CSPConvBN(in_c, mid, 1)
        self.blocks = nn.ModuleList([DarknetBottleneck(mid, kernel)
                                     for _ in range(num_blocks)])
        self.final_conv = CSPConvBN(2 * mid, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        short = self.short_conv(x)
        main = self.main_conv(x)
        for block in self.blocks:
            main = block(main)
        return self.final_conv(torch.cat([main, short], 1))


def _upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW ``x`` to an exact (h, w): source
    row (i·sh)//h, column (j·sw)//w (``slanet_exact.py:217-223``)."""
    sh, sw = x.shape[2], x.shape[3]
    rows = torch.arange(h, device=x.device) * sh // h
    cols = torch.arange(w, device=x.device) * sw // w
    return x[:, :, rows][:, :, :, cols]

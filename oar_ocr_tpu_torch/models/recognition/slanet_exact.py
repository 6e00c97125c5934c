"""PP-LCNet v1 building blocks at the official tensor names.

Counterpart of the first part of
``oar_ocr_tpu/models/recognition/slanet_exact.py`` (:56-110):
``hardswish``, ``PPLCNET_V1_CONFIG``, ``PPLCNetConvBN`` and
``DepthwiseSeparable``, which the PP-LCNet v1 classifiers
(``models/classification/pp_lcnet_exact.py``) are made of. SLANet itself
(CSPPAN, SLAHead) is not ported yet. NCHW inside; attribute names are the
Paddle attribute paths, so ``runtime/weights.params_from_jax`` maps the
JAX parameters onto them.
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

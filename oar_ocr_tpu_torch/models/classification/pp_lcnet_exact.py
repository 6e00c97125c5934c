"""Exact PP-LCNet v1 classifier: the PULC checkpoint topology.

Counterpart of ``oar_ocr_tpu/models/classification/pp_lcnet_exact.py``
(:24-48). The document- and text-line-orientation and table classifiers
are PaddleClas PULC exports of PP-LCNet v1: ``conv1`` + ``blocks2..6``
trunk (``models/recognition/slanet_exact.py``), then GAP → ``last_conv``
(1×1 to ``class_expand`` = 1280, no bias) → hardswish → flatten → ``fc``.

Dtype policy (the JAX module's): the trunk and ``last_conv`` compute in
the input's dtype; the GAP is taken in float32 and cast back; ``fc``
runs in float32 on the float32-cast features, so it stays float32 when
the module is cast to bfloat16 (:meth:`PPLCNetV1Cls.apply_dtype_policy`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..lcnetv3 import make_divisible
from ..recognition.slanet_exact import (PPLCNET_V1_CONFIG, DepthwiseSeparable,
                                        PPLCNetConvBN, hardswish)


class PPLCNetV1Cls(nn.Module):
    """PaddleClas PPLCNet(scale, class_num) at inference (dropout = id).
    Input (N, H, W, 3) normalized; output (N, class_num) float32 logits."""

    def __init__(self, class_num: int, scale: float = 1.0,
                 class_expand: int = 1280):
        super().__init__()
        ch = lambda c: make_divisible(c * scale)  # noqa: E731
        self.conv1 = PPLCNetConvBN(3, ch(16), 3, 2)
        for stage, blocks in PPLCNET_V1_CONFIG.items():
            setattr(self, stage, nn.Sequential(*[
                DepthwiseSeparable(ch(in_c), ch(out_c), k, s, se)
                for (k, in_c, out_c, s, se) in blocks]))
        self.last_conv = nn.Conv2d(ch(512), class_expand, 1, bias=False)
        self.fc = nn.Linear(class_expand, class_num)

    def apply_dtype_policy(self) -> "PPLCNetV1Cls":
        """``fc`` stays float32 whatever the trunk's dtype (the JAX
        module's ``nn.Dense`` on ``x.astype(float32)``)."""
        self.fc.float()
        return self

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x_nhwc.permute(0, 3, 1, 2))
        for stage in PPLCNET_V1_CONFIG:
            x = getattr(self, stage)(x)
        x = x.float().mean((2, 3), keepdim=True).to(x.dtype)   # GAP
        x = hardswish(self.last_conv(x))
        return self.fc(x.flatten(1).float())

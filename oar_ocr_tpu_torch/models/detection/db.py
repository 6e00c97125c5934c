"""DB text detector — exact PP-OCRv5 mobile det topology.

Counterpart of ``oar_ocr_tpu/models/detection/db.py``: PPLCNetV3(0.75,
det) backbone, or PP-HGNetV2 for the server model → RSEFPN(96) neck →
DBHead binarize branch. NCHW inside;
:meth:`DBNet.forward` takes the JAX package's normalized NHWC batch and
returns the (N, H, W) probability map.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FrozenBatchNorm2d, SEModule, conv_bn, deconv_bn, upsample2x
from ..hgnet import PPHGNetV2
from ..lcnetv3 import PPLCNetV3


class RSELayer(nn.Module):
    """``db_fpn.RSELayer``: in_conv (no bias) + SE, residual shortcut."""

    def __init__(self, in_c: int, out_c: int, k: int, shortcut: bool = True):
        super().__init__()
        self.in_conv = nn.Conv2d(in_c, out_c, k, padding=k // 2, bias=False)
        self.se_block = SEModule(out_c)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ins = self.in_conv(x)
        se = self.se_block(ins)
        return ins + se if self.shortcut else se


class RSEFPN(nn.Module):
    """``db_fpn.RSEFPN``: top-down adds, concat [p5·8, p4·4, p3·2, p2]."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 96,
                 shortcut: bool = True):
        super().__init__()
        self.ins_conv = nn.ModuleList([
            RSELayer(c, out_channels, 1, shortcut) for c in in_channels])
        self.inp_conv = nn.ModuleList([
            RSELayer(out_channels, out_channels // 4, 3, shortcut)
            for _ in in_channels])

    def forward(self, feats):
        c2, c3, c4, c5 = feats
        in5 = self.ins_conv[3](c5)
        in4 = self.ins_conv[2](c4)
        in3 = self.ins_conv[1](c3)
        in2 = self.ins_conv[0](c2)
        out4 = in4 + upsample2x(in5)
        out3 = in3 + upsample2x(out4)
        out2 = in2 + upsample2x(out3)
        p5 = upsample2x(self.inp_conv[3](in5), 8)
        p4 = upsample2x(self.inp_conv[2](out4), 4)
        p3 = upsample2x(self.inp_conv[1](out3), 2)
        p2 = self.inp_conv[0](out2)
        return torch.cat([p5, p4, p3, p2], dim=1)


class DBHeadBranch(nn.Module):
    """``det_db_head.Head``: conv1 → conv_bn1+relu → 2×2 deconv →
    conv_bn2+relu → 2×2 deconv to 1 channel → sigmoid."""

    def __init__(self, in_c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, in_c // 4, 3, padding=1, bias=False)
        self.conv_bn1 = FrozenBatchNorm2d(in_c // 4)
        self.conv2 = nn.ConvTranspose2d(in_c // 4, in_c // 4, 2, 2)
        self.conv_bn2 = FrozenBatchNorm2d(in_c // 4)
        self.conv3 = nn.ConvTranspose2d(in_c // 4, 1, 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv_bn(x, self.conv1, self.conv_bn1))
        x = F.relu(deconv_bn(x, self.conv2, self.conv_bn2))
        return torch.sigmoid(self.conv3(x))


class DBHead(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.binarize = DBHeadBranch(in_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.binarize(x)


class DBNet(nn.Module):
    """Input: normalized (N, H, W, 3) batch, H and W multiples of 32.
    Output: (N, H, W) probability map. ``backbone``: ``"lcnet"`` (the
    mobile models, PP-LCNetV3 × ``backbone_scale``) or ``"hgnet"`` (the
    server models, PP-HGNetV2-B4, ``db.py:147-150``)."""

    def __init__(self, backbone_scale: float = 0.75, fpn_channels: int = 96,
                 backbone: str = "lcnet"):
        super().__init__()
        if backbone == "hgnet":
            self.backbone = PPHGNetV2(mode="det")
            in_channels = self.backbone.stage_channels
        else:
            self.backbone = PPLCNetV3(backbone_scale, mode="det")
            in_channels = self.backbone.out_channels
        self.neck = RSEFPN(in_channels, fpn_channels)
        self.head = DBHead(fpn_channels)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        return self.head(self.neck(self.backbone(x)))[:, 0]

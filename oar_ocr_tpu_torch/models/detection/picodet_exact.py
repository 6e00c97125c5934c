"""Exact PicoDet layout detector: the deploy checkpoint topology.

Counterpart of ``oar_ocr_tpu/models/detection/picodet_exact.py``
(:51-214), module for module, with the Paddle attribute paths as the
attribute names (so ``runtime/weights.params_from_jax`` maps the JAX
parameters onto them):

- ``backbone``: PP-LCNet v1 (``conv1`` + ``blocks2..6``), the blocks4/5/6
  outputs at strides 8/16/32 (:51-68);
- ``neck``: CSP-PAN with the P6 extra level, ``conv_t.convs.{i}``
  laterals, ``top_down_blocks`` / ``downsamples`` / ``bottom_up_blocks``
  and ``first_top_conv`` + ``second_top_conv`` summed into the stride-64
  output (:71-105);
- ``head``: per-level ``conv_feat.cls_conv_dw{s}.{i}`` /
  ``cls_conv_pw{s}.{i}`` stacks and one fused 1×1 ``head_cls{i}`` per
  level emitting [classes | 4·(reg_max + 1)], decoded as sigmoid scores
  and the GFL integral × stride around cell centres (:108-190).

Dtype policy (the JAX module's): the network computes in the input's
dtype; the scores and boxes are float32 (:173-190). NCHW inside; the
input is the JAX package's normalized NHWC batch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..layers import FrozenBatchNorm2d, conv_bn
from ..lcnetv3 import make_divisible
from ..recognition.slanet_exact import (PPLCNET_V1_CONFIG, CSPConvBN,
                                        CSPLayer, DepthwiseSeparable, DPModule,
                                        PPLCNetConvBN, _upsample_nearest,
                                        hardswish)

_FEATURE_STAGES = ("blocks4", "blocks5", "blocks6")


class LCNetPico(nn.Module):
    """ppdet LCNet(scale, feature_maps=[3, 4, 5]): the blocks4/5/6
    outputs (:51-68)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        ch = lambda c: make_divisible(c * scale)  # noqa: E731
        self.conv1 = PPLCNetConvBN(3, ch(16), 3, 2)
        for stage, blocks in PPLCNET_V1_CONFIG.items():
            setattr(self, stage, nn.Sequential(*[
                DepthwiseSeparable(ch(in_c), ch(out_c), k, s, se)
                for (k, in_c, out_c, s, se) in blocks]))
        self.out_channels = [ch(PPLCNET_V1_CONFIG[s][-1][2])
                             for s in _FEATURE_STAGES]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.conv1(x)
        feats = []
        for stage in PPLCNET_V1_CONFIG:
            x = getattr(self, stage)(x)
            if stage in _FEATURE_STAGES:
                feats.append(x)
        return feats


class _Convs(nn.Module):
    """The ``conv_t`` holder: its laterals sit at ``conv_t.convs.{i}``."""

    def __init__(self, convs):
        super().__init__()
        self.convs = nn.ModuleList(convs)


class PicoCSPPAN(nn.Module):
    """csp_pan.CSPPAN with num_features=4: three backbone levels in, four
    out; the stride-64 level is first_top_conv(lateral[-1]) +
    second_top_conv(pan_out[-1]) (:71-105)."""

    def __init__(self, in_channels: Sequence[int], features: int = 128,
                 kernel: int = 5):
        super().__init__()
        n = len(in_channels)
        self.conv_t = _Convs([CSPConvBN(c, features, 1)
                              for c in in_channels])
        self.top_down_blocks = nn.ModuleList([
            CSPLayer(2 * features, features, kernel) for _ in range(n - 1)])
        self.downsamples = nn.ModuleList([
            DPModule(features, kernel, stride=2) for _ in range(n - 1)])
        self.bottom_up_blocks = nn.ModuleList([
            CSPLayer(2 * features, features, kernel) for _ in range(n - 1)])
        self.first_top_conv = DPModule(features, kernel, stride=2)
        self.second_top_conv = DPModule(features, kernel, stride=2)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(feats)
        lats = [conv(f) for conv, f in zip(self.conv_t.convs, feats)]
        inner = [lats[-1]]
        for idx in range(n - 1, 0, -1):
            low = lats[idx - 1]
            up = _upsample_nearest(inner[0], low.shape[2], low.shape[3])
            inner.insert(0, self.top_down_blocks[n - 1 - idx](
                torch.cat([up, low], 1)))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsamples[idx](outs[-1])
            outs.append(self.bottom_up_blocks[idx](
                torch.cat([down, inner[idx + 1]], 1)))
        top = self.first_top_conv(lats[-1])
        outs.append(top + self.second_top_conv(outs[-1]))
        return outs


class ConvNormLayer(nn.Module):
    """ppdet ConvNormLayer: conv (no bias) + bn (``norm``), no activation
    (:108-123)."""

    def __init__(self, in_c: int, out_c: int, kernel: int, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, padding=kernel // 2,
                              groups=groups, bias=False)
        self.norm = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(x, self.conv, self.norm)


class PicoFeat(nn.Module):
    """pico_head.PicoFeat with share_cls_reg: per-level depthwise 5×5 and
    pointwise ConvNormLayer stacks, hardswish after each (:126-145)."""

    def __init__(self, feat_out: int, num_convs: int, num_levels: int):
        super().__init__()
        self.num_convs = num_convs
        for s in range(num_levels):
            setattr(self, f"cls_conv_dw{s}", nn.ModuleList([
                ConvNormLayer(feat_out, feat_out, 5, groups=feat_out)
                for _ in range(num_convs)]))
            setattr(self, f"cls_conv_pw{s}", nn.ModuleList([
                ConvNormLayer(feat_out, feat_out, 1)
                for _ in range(num_convs)]))

    def forward(self, feat: torch.Tensor, stage_idx: int) -> torch.Tensor:
        x = feat
        dw = getattr(self, f"cls_conv_dw{stage_idx}")
        pw = getattr(self, f"cls_conv_pw{stage_idx}")
        for i in range(self.num_convs):
            x = hardswish(dw[i](x))
            x = hardswish(pw[i](x))
        return x


class PicoHeadExact(nn.Module):
    """pico_head.PicoHead (GFL, share_cls_reg): fused ``head_cls{i}``
    1×1 emitting [cls | 4·(reg_max + 1)], decoded to (scores, xyxy boxes)
    in float32 (:148-190)."""

    def __init__(self, num_classes: int, reg_max: int = 7, feat: int = 128,
                 num_convs: int = 4,
                 strides: Tuple[int, ...] = (8, 16, 32, 64),
                 cell_offset: float = 0.5):
        super().__init__()
        self.num_classes, self.reg_max = num_classes, reg_max
        self.strides, self.cell_offset = strides, cell_offset
        self.conv_feat = PicoFeat(feat, num_convs, len(strides))
        for level in range(len(strides)):
            setattr(self, f"head_cls{level}",
                    nn.Conv2d(feat, num_classes + 4 * (reg_max + 1), 1))

    def forward(self, feats: Sequence[torch.Tensor]):
        c, r = self.num_classes, self.reg_max + 1
        all_scores, all_boxes = [], []
        for level, f in enumerate(feats):
            h = self.conv_feat(f, level)
            out = getattr(self, f"head_cls{level}")(h)
            b, _, hh, ww = out.shape
            out = out.permute(0, 2, 3, 1)                     # NHWC
            stride = self.strides[level]
            scores = torch.sigmoid(out[..., :c].float()).reshape(
                b, hh * ww, c)
            reg = out[..., c:].float().reshape(b, hh * ww, 4, r)
            bins = torch.arange(r, dtype=torch.float32, device=out.device)
            ltrb = (torch.softmax(reg, -1) * bins).sum(-1) * stride
            cx = (torch.arange(ww, dtype=torch.float32, device=out.device)
                  + self.cell_offset) * stride
            cy = (torch.arange(hh, dtype=torch.float32, device=out.device)
                  + self.cell_offset) * stride
            gy, gx = torch.meshgrid(cy, cx, indexing="ij")
            centers = torch.stack([gx, gy], -1).reshape(1, hh * ww, 2)
            boxes = torch.cat([centers - ltrb[..., 0:2],
                               centers + ltrb[..., 2:4]], -1)
            all_scores.append(scores)
            all_boxes.append(boxes.expand(b, -1, -1))
        return torch.cat(all_scores, 1), torch.cat(all_boxes, 1)


class PicoDetExact(nn.Module):
    """backbone → neck → head (:193-214). Input (N, H, W, 3) normalized;
    output (scores (N, A, C) float32, boxes (N, A, 4) xyxy float32 in
    input pixels)."""

    def __init__(self, num_classes: int, scale: float = 1.0,
                 neck_feat: int = 128, head_convs: int = 4,
                 reg_max: int = 7,
                 strides: Tuple[int, ...] = (8, 16, 32, 64),
                 cell_offset: float = 0.5):
        super().__init__()
        self.backbone = LCNetPico(scale)
        self.neck = PicoCSPPAN(self.backbone.out_channels, neck_feat)
        self.head = PicoHeadExact(num_classes, reg_max, neck_feat,
                                  head_convs, strides, cell_offset)

    def forward(self, x_nhwc: torch.Tensor):
        feats = self.backbone(x_nhwc.permute(0, 3, 1, 2))
        return self.head(self.neck(feats))

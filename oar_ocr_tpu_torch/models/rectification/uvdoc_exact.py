"""UVDoc rectification network, the published UVDoc architecture.

Counterpart of ``oar_ocr_tpu/models/rectification/uvdoc_exact.py``: a
5×5-conv head to stride 4, a dilated-residual encoder to stride 16
(712×488 → 45×31, the UVDoc grid), six parallel dilated bridge branches
(dilation chains 1 / 2 / 5 / 8-3-2 / 12-7-4 / 18-12-6) concatenated and
fused by a 1×1 conv, and two point heads: ``out_point_positions2D``
(the normalized sampling grid) and ``out_point_positions3D``.

Every convolution pads symmetrically by d·(k//2), as the JAX module's
explicit padding does. Attribute names follow the flax module names
(``resnet_head.0``, ``resnet_down.layer1.0``, ``bridge_4.2``, …), so
``params_from_jax`` maps the JAX parameters onto them. The 2-D grid is
clipped to [-1, 1] in float32. NCHW inside, NHWC in and out.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FrozenBatchNorm2d, conv_bn

UVDOC_INPUT_HW = (712, 488)
UVDOC_GRID_HW = (45, 31)

BRIDGE_DILATIONS: Tuple[Tuple[int, ...], ...] = (
    (1,), (2,), (5,), (8, 3, 2), (12, 7, 4), (18, 12, 6))


class ConvBNRelu(nn.Module):
    """conv (with bias, padding d·(k//2)) + bn + relu."""

    def __init__(self, in_c: int, out_c: int, kernel: int = 5,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride,
                              padding=dilation * (kernel // 2),
                              dilation=dilation)
        self.bn = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(conv_bn(x, self.conv, self.bn))


class _ConvBN(nn.Module):
    """The projection shortcut's ``downsample.conv`` + ``downsample.bn``."""

    def __init__(self, in_c: int, out_c: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, 1, stride, bias=False)
        self.bn = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(x, self.conv, self.bn)


class ResidualBlock(nn.Module):
    """3×3 conv pair with identity/projection shortcut (DDCP residual)."""

    def __init__(self, in_c: int, out_c: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, out_c, 3, stride, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(out_c)
        self.conv2 = nn.Conv2d(out_c, out_c, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(out_c)
        if stride != 1 or in_c != out_c:
            self.downsample = _ConvBN(in_c, out_c, stride)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(conv_bn(x, self.conv1, self.bn1))
        h = conv_bn(h, self.conv2, self.bn2)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class PointHead(nn.Module):
    """conv-bn-relu → 3×3 projection to coordinate channels."""

    def __init__(self, in_c: int, out_channels: int, mid: int):
        super().__init__()
        self.conv = ConvBNRelu(in_c, mid, 3)
        self.proj = nn.Conv2d(mid, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.conv(x))


class _Down(nn.Module):
    def __init__(self, nf: int, block_nums: Tuple[int, int]):
        super().__init__()
        self.layer1 = nn.Sequential(*[
            ResidualBlock(nf * 2 if i == 0 else nf * 4, nf * 4,
                          2 if i == 0 else 1) for i in range(block_nums[0])])
        self.layer2 = nn.Sequential(*[
            ResidualBlock(nf * 4 if i == 0 else nf * 8, nf * 8,
                          2 if i == 0 else 1) for i in range(block_nums[1])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer2(self.layer1(x))


class UVDocNetExact(nn.Module):
    """Full UVDoc net. Input (B, 712, 488, 3) x/255; output the 2-D grid
    (B, 45, 31, 2) of normalized [-1, 1] sampling positions, float32, and
    the 3-D head (B, 45, 31, 3), float32."""

    def __init__(self, num_filter: int = 32,
                 block_nums: Tuple[int, int] = (3, 4)):
        super().__init__()
        nf = num_filter
        self.resnet_head = nn.Sequential(
            ConvBNRelu(3, nf, 5, stride=2), ConvBNRelu(nf, nf, 5),
            ConvBNRelu(nf, nf * 2, 5, stride=2))
        self.resnet_down = _Down(nf, block_nums)
        for bi, dils in enumerate(BRIDGE_DILATIONS, start=1):
            setattr(self, f"bridge_{bi}", nn.Sequential(*[
                ConvBNRelu(nf * 8, nf * 8, 3, dilation=d) for d in dils]))
        self.bridge_concat = ConvBNRelu(nf * 8 * len(BRIDGE_DILATIONS),
                                        nf * 8, 1)
        self.out_point_positions2D = PointHead(nf * 8, 2, nf * 4)
        self.out_point_positions3D = PointHead(nf * 8, 3, nf * 4)

    def forward(self, x_nhwc: torch.Tensor):
        x = self.resnet_down(self.resnet_head(x_nhwc.permute(0, 3, 1, 2)))
        x = torch.cat([getattr(self, f"bridge_{bi}")(x)
                       for bi in range(1, len(BRIDGE_DILATIONS) + 1)], dim=1)
        x = self.bridge_concat(x)
        grid2d = self.out_point_positions2D(x).permute(0, 2, 3, 1)
        grid3d = self.out_point_positions3D(x).permute(0, 2, 3, 1)
        return torch.clamp(grid2d.float(), -1.0, 1.0), grid3d.float()

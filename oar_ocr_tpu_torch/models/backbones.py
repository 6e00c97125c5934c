"""The parametric PP-LCNet backbone in classification and det mode.

Counterpart of ``oar_ocr_tpu/models/backbones.py`` (``make_divisible``,
``PPLCNetV3`` with ``mode="cls"`` or ``"det"``) and the blocks it is made
of in ``oar_ocr_tpu/models/layers.py`` (``ConvBNAct``, ``SEModule``,
``DepthSepConv``). It is the trunk of the non-default
``PPLCNetClassifier`` (``models/classification/pp_lcnet.py``, cls) and
of the default table-structure model ``SLANet``
(``models/recognition/slanet.py``, det); the OCR det and rec models run
the exact deploy topology of ``models/lcnetv3.py`` instead.

The flax modules carry no names, so flax numbers them per type
(``ConvBNAct_0``, ``DepthSepConv_3``, ``Conv_0``, ``BatchNorm_0``); the
attributes here carry the same names, so ``params_from_jax`` maps the
JAX parameters onto them. The convolutions pad as flax's ``"SAME"``
does: at stride 2 the padding is asymmetric, ``(k − s)//2`` before and
the rest after (for an even input), which this module applies with
``F.pad``. NCHW inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import FrozenBatchNorm2d, conv_bn, hswish


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# Stage configs: (kernel, out_channels, use_se) per block; the first block
# of each stage carries the stage stride (``backbones.py:35-47``).
_STAGES: Sequence[Sequence[Tuple[int, int, bool]]] = (
    ((3, 32, False),),
    ((3, 64, False), (3, 64, False)),
    ((3, 128, False), (3, 128, False)),
    ((3, 256, False), (5, 256, False), (5, 256, False), (5, 256, False),
     (5, 256, False)),
    ((5, 512, True), (5, 512, True)),
)
_CLS_STRIDES = (1, 2, 2, 2, 2)


def same_pad(x: torch.Tensor, k: int,
             s: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """Pad H and W as flax's ``padding="SAME"``: out = ceil(n/s), the
    total (out − 1)·s + k − n split low = total//2, high = the rest.
    ``s``: one stride, or (stride_h, stride_w)."""
    sh, sw = (s, s) if isinstance(s, int) else s
    pads = []
    for n, st in ((x.shape[3], sw), (x.shape[2], sh)):   # F.pad: W, then H
        total = max((-(-n // st) - 1) * st + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvBNAct(nn.Module):
    """Conv (no bias) + inference BatchNorm + hardswish, ReLU with
    ``act="relu"``, or no activation with ``act=None`` (``layers.ConvBNAct``
    with ``use_bn``, ``"SAME"`` padding). ``stride``: one stride, or
    (stride_h, stride_w)."""

    def __init__(self, in_c: int, out_c: int, k: int,
                 stride: Union[int, Tuple[int, int]] = 1, groups: int = 1,
                 act: Optional[str] = "hswish"):
        super().__init__()
        self.k, self.stride = k, stride
        self.act = {"relu": F.relu, "hswish": hswish, None: _identity}[act]
        self.Conv_0 = nn.Conv2d(in_c, out_c, k, stride, groups=groups,
                                bias=False)
        self.BatchNorm_0 = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = same_pad(x, self.k, self.stride)
        return self.act(conv_bn(x, self.Conv_0, self.BatchNorm_0))


class SEModule(nn.Module):
    """``layers.SEModule``: mean over H, W, 1×1 conv to c//4 → relu →
    1×1 conv → relu6(x + 3)/6 gate (not PP-LCNet's hardsigmoid(0.2,
    0.5))."""

    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c, max(c // reduction, 1), 1)
        self.Conv_1 = nn.Conv2d(max(c // reduction, 1), c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean((2, 3), keepdim=True).to(x.dtype)
        s = self.Conv_1(F.relu(self.Conv_0(s)))
        return x * F.hardsigmoid(s)


class DepthSepConv(nn.Module):
    """dw k×k ConvBNAct (+SE) → pw 1×1 ConvBNAct (``layers.DepthSepConv``)."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int,
                 use_se: bool):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_c, in_c, k, stride, groups=in_c)
        self.use_se = use_se
        if use_se:
            self.SEModule_0 = SEModule(in_c)
        self.ConvBNAct_1 = ConvBNAct(in_c, out_c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBNAct_0(x)
        if self.use_se:
            x = self.SEModule_0(x)
        return self.ConvBNAct_1(x)


class PPLCNetV3(nn.Module):
    """``backbones.PPLCNetV3`` in ``mode="cls"`` (stem, five stages,
    global average pool → (N, C) in the input's dtype, its mean taken in
    float32) or ``mode="det"`` (the last four stages' maps, strides 4,
    8, 16, 32, ``backbones.py:78-80``); both modes stride the same way.
    The rec mode is not ported (rec runs ``models/lcnetv3``). NCHW in."""

    def __init__(self, scale: float = 1.0, mode: str = "cls"):
        super().__init__()
        if mode not in ("cls", "det"):
            raise ValueError(f"PPLCNetV3 mode {mode!r}: cls or det")
        self.mode = mode
        self.stage_ends = []
        ch = lambda c: make_divisible(c * scale)  # noqa: E731
        self.ConvBNAct_0 = ConvBNAct(3, ch(16), 3, 2)
        i, in_c = 0, ch(16)
        for stage_idx, stage in enumerate(_STAGES):
            for block_idx, (k, out_c, use_se) in enumerate(stage):
                stride = _CLS_STRIDES[stage_idx] if block_idx == 0 else 1
                setattr(self, f"DepthSepConv_{i}",
                        DepthSepConv(in_c, ch(out_c), k, stride, use_se))
                i, in_c = i + 1, ch(out_c)
            self.stage_ends.append(i)
        self.n_blocks = i
        self.out_channels = in_c

    def forward(self, x: torch.Tensor):
        x = self.ConvBNAct_0(x)
        feats = []
        for i in range(self.n_blocks):
            x = getattr(self, f"DepthSepConv_{i}")(x)
            if i + 1 in self.stage_ends:
                feats.append(x)
        if self.mode == "det":
            return tuple(feats[1:])
        return x.float().mean((2, 3)).to(x.dtype)

"""PP-HGNetV2: the server det and rec models' backbone.

Counterpart of ``oar_ocr_tpu/models/hgnet.py`` (``HGBlock``,
``_STAGES_B4``, ``PPHGNetV2`` in the modes det, rec and cls): a 3-conv
stem (stride 2), then four stages, each a depthwise 3×3 downsample
followed by HG blocks. Every stage downsamples: a stage without
``down`` still runs the stride-2 depthwise conv (``hgnet.py:75-77``),
and in rec mode the stages from the third on stride (2, 1), so a
48-high crop goes 24 → 12 → 6 → 3 → 2 and the width W/8 is kept
(``:71-74``). The stem and block convs are ReLU, the downsamples have no
activation, all pad as flax's ``"SAME"`` (``backbones.ConvBNAct``).

The flax modules carry no names, so flax numbers each class per parent:
the stem is ``ConvBNAct_0-2``, each stage's downsample ``ConvBNAct_3-6``
between the blocks ``HGBlock_0-5``, and inside a block the chain is
``ConvBNAct_0-5`` and the two 1×1 aggregations ``ConvBNAct_6-7``. The
attributes here carry those names, so ``params_from_jax`` loads the JAX
parameters strictly with no case of its own. NCHW inside.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .backbones import ConvBNAct

# (mid, out, blocks, downsample, layer_num) per stage (``hgnet.py:44-50``)
STAGES_B4: Sequence[Tuple[int, int, int, bool, int]] = (
    (48, 128, 1, False, 6),
    (96, 512, 1, True, 6),
    (192, 1024, 3, True, 6),
    (384, 2048, 1, True, 6),
)


class HGBlock(nn.Module):
    """``layer_num`` 3×3 ReLU convs in a chain, the input and every
    output concatenated ``[x, h1, …, hn]``, then two 1×1 ReLU
    aggregations; the identity residual when ``identity`` and the
    channels match (``hgnet.py:20-41``)."""

    def __init__(self, in_c: int, mid: int, out: int, layer_num: int = 6,
                 kernel: int = 3, identity: bool = False):
        super().__init__()
        self.layer_num = layer_num
        c = in_c
        for i in range(layer_num):
            setattr(self, f"ConvBNAct_{i}",
                    ConvBNAct(c, mid, kernel, act="relu"))
            c = mid
        setattr(self, f"ConvBNAct_{layer_num}",
                ConvBNAct(in_c + layer_num * mid, out // 2, 1, act="relu"))
        setattr(self, f"ConvBNAct_{layer_num + 1}",
                ConvBNAct(out // 2, out, 1, act="relu"))
        self.residual = identity and in_c == out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, h = [x], x
        for i in range(self.layer_num):
            h = getattr(self, f"ConvBNAct_{i}")(h)
            outs.append(h)
        agg = getattr(self, f"ConvBNAct_{self.layer_num}")(torch.cat(outs, 1))
        agg = getattr(self, f"ConvBNAct_{self.layer_num + 1}")(agg)
        return agg + x if self.residual else agg


class PPHGNetV2(nn.Module):
    """``mode="det"``: the four stages' maps (strides 4/8/16/32);
    ``"rec"``: the last map averaged over its height in float32, (N, C, 1,
    W/8) in the input's dtype; ``"cls"``: the global average, (N, C)."""

    def __init__(self, mode: str = "det",
                 stages: Sequence[Tuple[int, int, int, bool, int]] = STAGES_B4,
                 stem_width: int = 32):
        super().__init__()
        if mode not in ("det", "rec", "cls"):
            raise ValueError(f"PPHGNetV2 mode {mode!r}: det, rec or cls")
        self.mode = mode
        w = stem_width
        self.ConvBNAct_0 = ConvBNAct(3, w, 3, 2, act="relu")
        self.ConvBNAct_1 = ConvBNAct(w, w, 3, act="relu")
        self.ConvBNAct_2 = ConvBNAct(w, 2 * w, 3, act="relu")
        c, block = 2 * w, 0
        self.stages = []            # (downsample name, block names)
        for si, (mid, out, blocks, down, layer_num) in enumerate(stages):
            stride = (2, 1) if down and mode == "rec" and si >= 2 else (2, 2)
            down_name = f"ConvBNAct_{3 + si}"
            setattr(self, down_name, ConvBNAct(c, c, 3, stride, groups=c,
                                               act=None))
            names = []
            for bi in range(blocks):
                name = f"HGBlock_{block}"
                setattr(self, name, HGBlock(c, mid, out, layer_num,
                                            identity=bi > 0))
                names.append(name)
                block, c = block + 1, out
            self.stages.append((down_name, names))
        self.out_channels = c
        self.stage_channels = tuple(s[1] for s in stages)

    def forward(self, x: torch.Tensor):
        x = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        feats = []
        for down_name, names in self.stages:
            x = getattr(self, down_name)(x)
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        if self.mode == "det":
            return tuple(feats)
        if self.mode == "rec":
            return x.float().mean(2, keepdim=True).to(x.dtype)
        return x.float().mean((2, 3)).to(x.dtype)

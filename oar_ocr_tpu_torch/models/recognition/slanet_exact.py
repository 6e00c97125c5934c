"""Exact SLANet (SLANet_plus): PP-LCNet v1 + CSP-PAN + SLAHead at the
official tensor names.

Counterpart of ``oar_ocr_tpu/models/recognition/slanet_exact.py``:

- the PP-LCNet v1 blocks (:56-110: ``hardswish``, ``PPLCNET_V1_CONFIG``,
  ``PPLCNetConvBN``, ``DepthwiseSeparable``), which the PP-LCNet v1
  classifiers (``models/classification/pp_lcnet_exact.py``) and
  PicoDet's backbone are made of too, and :class:`PPLCNetTable`
  (:112-131), the table backbone returning the blocks3-6 maps;
- the CSP-PAN pieces (:134-223: ``CSPConvBN``, ``DPModule``,
  ``DarknetBottleneck``, ``CSPLayer``, ``_upsample_nearest``), which
  PicoDet's neck is made of too, and :class:`CSPPAN` (:226-256);
- the head: :class:`AttentionGRUCell` (:259-303, additive attention and
  a Paddle-layout GRU, :func:`.slanet.gru_step`) and
  :class:`SLAHeadExact` (:306-361), ``max_text_length + 1`` steps of
  ``models/recognition/sla_decode.py``'s loop; ``i2h(batch_H)``, the
  same product at every JAX step, is taken once per decode;
- :class:`SLANetExact` (:363-383) and :class:`SLANetExactModel`
  (:392-509): each table crop sampled keep-ratio into the 488 canvas
  straight from the resident page batch (``ops/warp.sample_transform``:
  the gather, then K1 with the BGR ImageNet normalization, the pad
  exactly 0.0 after normalizing, caller ``"table"``), float32 whatever
  the runtime's dtype, as the JAX model (:407-411, :447-450); and
  ``recognize_images``, the host path.

NCHW inside; attribute names are the Paddle attribute paths, so
``runtime/weights.params_from_jax`` maps the JAX parameters onto them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.constants import IMAGENET_MEAN, IMAGENET_STD
from ...ops.warp import resize_matrix, sample_transform
from ...runtime.runtime import Runtime
from ...utils.tracing import stage_timer
from ..layers import FrozenBatchNorm2d, SEModule, conv_bn, init_state_dict
from ..layers import load_weights
from ..lcnetv3 import make_divisible
from .sla_decode import DecodeGraphs, SLADecoder
from .slanet import (TABLE_NORM, TABLE_STRUCTURE_VOCAB, GRUWeights,
                     TableStructure, decode_structure, derot_dims,
                     fetch_decoded, gru_step, rotate_boxes_back,
                     rotation_matrix)


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


class PPLCNetTable(nn.Module):
    """PP-LCNet v1 trunk returning the blocks3/4/5/6 maps, out channels
    ×scale (``slanet_exact.py:112-131``)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        ch = lambda c: make_divisible(c * scale)  # noqa: E731
        self.conv1 = PPLCNetConvBN(3, ch(16), 3, 2)
        for stage, blocks in PPLCNET_V1_CONFIG.items():
            setattr(self, stage, nn.ModuleList([
                DepthwiseSeparable(ch(in_c), ch(out_c), k, s, se)
                for (k, in_c, out_c, s, se) in blocks]))
        self.out_channels = [ch(c) for c in (64, 128, 256, 512)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.conv1(x)
        feats = []
        for stage in PPLCNET_V1_CONFIG:
            for block in getattr(self, stage):
                x = block(x)
            if stage != "blocks2":
                feats.append(x)
        return feats


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


class _ConvT(nn.Module):
    """The ``conv_t`` holder of CSP-PAN's 1×1 projections (``convs``)."""

    def __init__(self, in_channels: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList([CSPConvBN(c, features, 1)
                                    for c in in_channels])


class CSPPAN(nn.Module):
    """PicoDet CSP-PAN over the backbone's scales
    (``slanet_exact.py:226-256``): 1×1 projections, a top-down pass of
    CSP layers over [nearest upsample ‖ skip], a bottom-up pass of
    stride-2 DPModules and CSP layers."""

    def __init__(self, in_channels: Sequence[int], features: int = 96,
                 kernel: int = 5):
        super().__init__()
        n = len(in_channels)
        self.conv_t = _ConvT(in_channels, features)
        self.top_down_blocks = nn.ModuleList([
            CSPLayer(2 * features, features, kernel) for _ in range(n - 1)])
        self.downsamples = nn.ModuleList([
            DPModule(features, kernel, stride=2) for _ in range(n - 1)])
        self.bottom_up_blocks = nn.ModuleList([
            CSPLayer(2 * features, features, kernel) for _ in range(n - 1)])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(feats)
        feats = [conv(f) for conv, f in zip(self.conv_t.convs, feats)]
        inner = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            low = feats[idx - 1]
            up = _upsample_nearest(inner[0], low.shape[2], low.shape[3])
            inner.insert(0, self.top_down_blocks[n - 1 - idx](
                torch.cat([up, low], 1)))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = self.downsamples[idx](outs[-1])
            outs.append(self.bottom_up_blocks[idx](
                torch.cat([down, inner[idx + 1]], 1)))
        return outs


# ----------------------------- SLAHead -----------------------------


class AttentionGRUCell(nn.Module):
    """ppocr ``AttentionGRUCell`` (``slanet_exact.py:259-303``):
    additive attention over the visual memory, then a GRU step on
    [context ‖ onehot(prev)] with Paddle-layout ``rnn`` weights."""

    def __init__(self, in_c: int, hidden: int, num_embeddings: int):
        super().__init__()
        self.i2h = nn.Linear(in_c, hidden, bias=False)
        self.h2h = nn.Linear(hidden, hidden)
        self.score = nn.Linear(hidden, 1, bias=False)
        self.rnn = GRUWeights(in_c + num_embeddings, hidden)


class SLAHeadExact(SLADecoder):
    """ppocr ``SLAHead`` (``slanet_exact.py:306-361``): float32 memory,
    ``max_text_length + 1`` steps; the structure and corner generators
    are two Linear layers each (no activation between), the corners
    through a sigmoid."""

    def __init__(self, out_channels: int, in_c: int, hidden_size: int = 256,
                 max_text_length: int = 500, loc_reg_num: int = 8):
        super().__init__(out_channels, hidden_size, loc_reg_num,
                         max_text_length + 1)
        self.structure_attention_cell = AttentionGRUCell(
            in_c, hidden_size, out_channels)
        self.structure_generator = nn.Sequential(
            nn.Linear(hidden_size, hidden_size),
            nn.Linear(hidden_size, out_channels))
        self.loc_generator = nn.Sequential(
            nn.Linear(hidden_size, hidden_size),
            nn.Linear(hidden_size, loc_reg_num))

    def prepare(self, memory: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return memory, self.structure_attention_cell.i2h(memory)

    def step(self, h, tok, ctx):
        batch_h, h_proj = ctx
        cell = self.structure_attention_cell
        p_proj = cell.h2h(h)[:, None, :]
        e = cell.score(torch.tanh(h_proj + p_proj))
        alpha = torch.softmax(e, dim=1)
        context = (alpha * batch_h).sum(1)
        onehot = F.one_hot(tok, self.vocab).to(batch_h.dtype)
        new_h = gru_step(torch.cat([context, onehot], -1), h, cell.rnn)
        return (new_h, self.structure_generator(new_h),
                torch.sigmoid(self.loc_generator(new_h)))


class SLANetExact(nn.Module):
    """backbone → neck → head at the checkpoint roots; input (N, 3, 488,
    488) normalized BGR; ``forward`` gives (logits (N, T, vocab),
    corners (N, T, loc), steps run) through the plain loop
    (``slanet_exact.py:363-383``)."""

    def __init__(self, vocab_size: int = len(TABLE_STRUCTURE_VOCAB),
                 scale: float = 1.0, neck_channels: int = 96,
                 hidden_size: int = 256, max_text_length: int = 500,
                 loc_reg_num: int = 8):
        super().__init__()
        self.backbone = PPLCNetTable(scale)
        self.neck = CSPPAN(self.backbone.out_channels, neck_channels)
        self.head = SLAHeadExact(vocab_size, neck_channels, hidden_size,
                                 max_text_length, loc_reg_num)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The (N, HW, C) float32 memory: the neck's coarsest map."""
        fea = self.neck(self.backbone(x))[-1]
        return fea.flatten(2).transpose(1, 2).float()

    def forward(self, x: torch.Tensor):
        return self.head.decode(self.features(x))


class SLANetExactModel:
    """Keep-ratio 488-pad driver around :class:`SLANetExact`
    (``slanet_exact.py:392-509``). ``state_dict``: port weights
    (``params_from_jax``); seeded random weights when None. ``model_kw``
    sizes the network. float32 in every runtime; the decoder runs
    through :class:`~.sla_decode.DecodeGraphs` on the card."""

    INPUT = 488
    TIMER = "slanet_exact.device"

    def __init__(self, state_dict=None, *, runtime: Optional[Runtime] = None,
                 **model_kw):
        self.runtime = runtime or Runtime()
        model = self._make_model(**model_kw)
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(0))
        self.model = load_weights(model, state_dict,
                                  device=self.runtime.device)
        self.graphs = DecodeGraphs(self.model.head)

    def _make_model(self, **model_kw) -> nn.Module:
        return SLANetExact(**model_kw)

    @torch.no_grad()
    def decode_inputs(self, x: torch.Tensor):
        """(logits, corners) of an NHWC float32 canvas batch: the
        backbone, then the decoder through its graph (the plain loop on
        the CPU)."""
        memory = self.model.features(x.permute(0, 3, 1, 2))
        return self.graphs.decode(memory)[:2]

    @torch.no_grad()
    def inputs(self, pages_u8: torch.Tensor,
               regions: Sequence[Tuple[int, Tuple[int, int, int, int]]],
               angles: Sequence[int]):
        """(canvases, scales): the (N, S, S, 3) float32 canvases, each
        crop keep-ratio in the top-left (vh, vw) and the rest exactly 0.0
        (the gather, then K1, :413-450), and each crop's (scale, w, h,
        angle) for the decode."""
        n = self.INPUT
        mats, idxs, vw, vh, scales = [], [], [], [], []
        for (page_i, (x0, y0, x1, y1)), ang in zip(regions, angles):
            w, h = max(x1 - x0, 1), max(y1 - y0, 1)
            dw, dh = derot_dims(ang, w, h)
            s = min(n / dh, n / dw)
            nh, nw = max(int(round(dh * s)), 1), max(int(round(dw * s)), 1)
            m = (rotation_matrix(ang, w, h)
                 @ resize_matrix(dh, dw, nh, nw).astype(np.float64))
            shift = np.array([[1, 0, x0], [0, 1, y0], [0, 0, 1]],
                             np.float64)
            mats.append((shift @ m).astype(np.float32))
            idxs.append(page_i)
            vw.append(nw)
            vh.append(nh)
            scales.append((s, w, h, ang))
        put = self.runtime.put
        x = sample_transform(
            pages_u8, put(np.stack(mats)), put(np.asarray(idxs, np.int64)),
            put(np.asarray(vw, np.int32)), put(np.asarray(vh, np.int32)),
            out_h=n, out_w=n, norm=TABLE_NORM, out_dtype=torch.float32,
            caller="table")
        return x, scales

    def recognize(self, pages_u8: torch.Tensor,
                  regions: Sequence[Tuple[int, Tuple[int, int, int, int]]],
                  angles: Optional[Sequence[int]] = None
                  ) -> List[TableStructure]:
        """Device path (drop-in for ``pipelines/table_analyzer.py``):
        each table crop sampled keep-ratio into the canvas straight from
        the resident page batch, decoded, and its cells mapped back
        (:413-462)."""
        if not regions:
            return []
        angles = list(angles) if angles is not None else [0] * len(regions)
        with stage_timer(self.TIMER, batch=len(regions)):
            x, scales = self.inputs(pages_u8, regions, angles)
            ids, conf, locs = fetch_decoded(*self.decode_inputs(x))
        return self._decode_batch(ids, conf, locs, scales)

    def _decode_batch(self, ids, conf, locs, scales) -> List[TableStructure]:
        """Cell boxes back to crop px, de-rotated and clipped (:464-479)."""
        out = []
        for i, entry in enumerate(scales):
            s, w, h = entry[:3]
            ang = entry[3] if len(entry) > 3 else 0
            tokens, boxes, sc = decode_structure(ids[i], conf[i], locs[i])
            boxes = boxes * (self.INPUT / s)
            if boxes.size:
                boxes = rotate_boxes_back(boxes, ang, w, h)
                boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
                boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
            out.append(TableStructure(tokens=tokens, cell_boxes=boxes,
                                      score=float(np.mean(sc)) if sc
                                      else 0.0))
        return out

    @torch.no_grad()
    def recognize_images(self, crops: Sequence[np.ndarray]
                         ) -> List[TableStructure]:
        """Host uint8 RGB table crops → structures (keep-ratio nearest
        resize + pad on the host, :481-509)."""
        if not crops:
            return []
        n = self.INPUT
        batch = np.zeros((len(crops), n, n, 3), np.float32)
        scales = []
        for i, im in enumerate(crops):
            h, w = im.shape[:2]
            s = min(n / h, n / w)
            nh, nw = max(int(round(h * s)), 1), max(int(round(w * s)), 1)
            ys = (np.arange(nh) * h // nh).astype(int)
            xs = (np.arange(nw) * w // nw).astype(int)
            resized = im[ys][:, xs].astype(np.float32)
            bgr = resized[..., ::-1] / 255.0           # slanet.rs:7-11
            bgr = (bgr - np.asarray(IMAGENET_MEAN)) / np.asarray(
                IMAGENET_STD)
            batch[i, :nh, :nw] = bgr
            scales.append((s, w, h))
        with stage_timer(self.TIMER, batch=len(crops)):
            ids, conf, locs = fetch_decoded(
                *self.decode_inputs(self.runtime.put(batch)))
        return self._decode_batch(ids, conf, locs, scales)

"""Exact RT-DETR: PPHGNetV2 backbone, HybridEncoder, deformable decoder.

Counterpart of ``oar_ocr_tpu/models/detection/rtdetr.py`` (:49-687),
module for module, with the Paddle attribute paths as attribute names
(``stages.0.blocks.1``, ``input_proj.0.conv``, ``enc_output.0``,
``decoder.layers.5`` become ``nn.ModuleList`` / ``nn.Sequential`` paths),
so ``runtime/weights.params_from_jax`` maps the JAX parameters onto them:

- ``backbone`` PPHGNetV2 (:58-206): the StemBlock with its right/bottom
  pads and 2×2 stride-1 max-pool, HG blocks, depthwise stride-2
  downsamples; the stride 8/16/32 maps;
- ``neck`` HybridEncoder (:213-403): ``input_proj`` conv+BN, AIFI (one
  post-norm encoder layer with the 2-D sincos position embedding on the
  stride-32 level), the CCFF top-down FPN and bottom-up PAN of
  CSPRepLayers;
- ``transformer`` RTDETRTransformer (:410-644): ``input_proj``, the
  anchor grid (invalid anchors ``inf`` in logit space, their memory
  zeroed), encoder-output query selection (top ``num_queries`` by the
  largest class logit), six decoder layers of self attention,
  multi-scale deformable cross attention and FFN, with iterative box
  refinement.

The attention is the JAX package's plain einsum (``FusedMHA``, one
``in_proj_weight`` in Paddle's (d, 3d) layout); the deformable sampling
is its clipped bilinear gather (:428-452), not ``F.grid_sample``. Top-k
selections take the lower index first among equal values, as
``lax.top_k`` does (``ops/nms.topk_stable``).

Dtype policy (the JAX modules'): everything computes in the input's
dtype, except the deformable sampling and its attention weights
(float32, :475-502), the box arithmetic (float32) and the returned
logits and boxes (float32, :644). NCHW inside; the input is the JAX
package's normalized NHWC batch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.nms import topk_stable
from ..layers import FrozenBatchNorm2d, conv_bn

# --------------------------------------------------------------------------
# PPHGNetV2 backbone
# --------------------------------------------------------------------------


class HGConvBNAct(nn.Module):
    """hgnet_v2 ConvBNAct: conv (no bias, (k−1)//2 padding) + bn (+ relu)
    (:58-78)."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int = 1,
                 groups: int = 1, use_act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias=False)
        self.bn = FrozenBatchNorm2d(out_c)
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn(x, self.conv, self.bn)
        return F.relu(x) if self.use_act else x


class LightConvBNAct(nn.Module):
    """1×1 conv (no act) → depthwise k×k conv (relu) (:81-91)."""

    def __init__(self, in_c: int, out_c: int, kernel: int):
        super().__init__()
        self.conv1 = HGConvBNAct(in_c, out_c, 1, use_act=False)
        self.conv2 = HGConvBNAct(out_c, out_c, kernel, groups=out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class StemBlock(nn.Module):
    """hgnet_v2 StemBlock (:94-111): stem1 stride 2, a right/bottom pad of
    one, stem2a/stem2b 2×2 convs (stem2b after another right/bottom pad)
    beside a 2×2 stride-1 max-pool, concat [pool, conv], stem3 stride 2,
    stem4 1×1. A 2×2 kernel's ``(k − 1)//2`` padding is 0."""

    def __init__(self, mid_c: int, out_c: int):
        super().__init__()
        self.stem1 = HGConvBNAct(3, mid_c, 3, stride=2)
        self.stem2a = HGConvBNAct(mid_c, mid_c // 2, 2)
        self.stem2b = HGConvBNAct(mid_c // 2, mid_c, 2)
        self.stem3 = HGConvBNAct(2 * mid_c, mid_c, 3, stride=2)
        self.stem4 = HGConvBNAct(mid_c, out_c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = F.pad(self.stem2a(x), (0, 1, 0, 1))
        x2 = self.stem2b(x2)
        x1 = F.max_pool2d(x, 2, stride=1)
        x = self.stem3(torch.cat([x1, x2], 1))
        return self.stem4(x)


class HGBlockV2(nn.Module):
    """hgnet_v2 HG_Block: layer chain → concat → squeeze/excite 1×1s
    (:114-143)."""

    def __init__(self, in_c: int, mid_c: int, out_c: int, layer_num: int,
                 kernel: int, light_block: bool, identity: bool):
        super().__init__()
        layers = []
        for i in range(layer_num):
            c = in_c if i == 0 else mid_c
            layers.append(LightConvBNAct(c, mid_c, kernel) if light_block
                          else HGConvBNAct(c, mid_c, kernel))
        self.layers = nn.ModuleList(layers)
        total = in_c + layer_num * mid_c
        self.aggregation_squeeze_conv = HGConvBNAct(total, out_c // 2, 1)
        self.aggregation_excitation_conv = HGConvBNAct(out_c // 2, out_c, 1)
        self.identity = identity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, h = [x], x
        for layer in self.layers:
            h = layer(h)
            outs.append(h)
        agg = self.aggregation_squeeze_conv(torch.cat(outs, 1))
        agg = self.aggregation_excitation_conv(agg)
        return agg + x if self.identity else agg


# arch spec: stem (mid, out); stages: (mid, out, blocks, downsample,
# light_block, kernel, layer_num) — rtdetr.py:148-178
HGNETV2_ARCH = {
    "L": {
        "stem": (32, 48),
        "stages": (
            (48, 128, 1, False, False, 3, 6),
            (96, 512, 1, True, False, 3, 6),
            (192, 1024, 3, True, True, 5, 6),
            (384, 2048, 1, True, True, 5, 6),
        ),
    },
    "X": {
        "stem": (64, 64),
        "stages": (
            (64, 128, 1, False, False, 3, 6),
            (128, 512, 2, True, False, 3, 6),
            (256, 1024, 5, True, True, 5, 6),
            (512, 2048, 2, True, True, 5, 6),
        ),
    },
    # tiny config for CPU parity tests: every module type (plain + light
    # blocks, downsample, identity) at toy widths
    "T": {
        "stem": (8, 12),
        "stages": (
            (16, 32, 1, False, False, 3, 2),
            (24, 64, 1, True, False, 3, 2),
            (32, 128, 2, True, True, 5, 2),
            (48, 256, 1, True, True, 5, 2),
        ),
    },
}


class HGStage(nn.Module):
    """One stage: an optional depthwise stride-2 ``downsample`` (no act),
    then ``blocks`` (:192-200)."""

    def __init__(self, in_c: int, mid: int, out: int, blocks: int,
                 down: bool, light: bool, kernel: int, layer_num: int):
        super().__init__()
        if down:
            self.downsample = HGConvBNAct(in_c, in_c, 3, stride=2,
                                          groups=in_c, use_act=False)
        self.down = down
        self.blocks = nn.ModuleList([
            HGBlockV2(in_c if bi == 0 else out, mid, out, layer_num, kernel,
                      light, identity=bi > 0) for bi in range(blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


class PPHGNetV2Det(nn.Module):
    """PPHGNetV2 trunk for RT-DETR, return_idx (1, 2, 3) (:181-206)."""

    def __init__(self, arch: str = "L",
                 return_idx: Tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        spec = HGNETV2_ARCH[arch]
        self.stem = StemBlock(*spec["stem"])
        stages, c = [], spec["stem"][1]
        for mid, out, blocks, down, light, k, ln in spec["stages"]:
            stages.append(HGStage(c, mid, out, blocks, down, light, k, ln))
            c = out
        self.stages = nn.ModuleList(stages)
        self.return_idx = return_idx

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.stages[i].blocks[-1].aggregation_excitation_conv
                     .conv.out_channels for i in self.return_idx)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return tuple(feats[i] for i in self.return_idx)


# --------------------------------------------------------------------------
# HybridEncoder
# --------------------------------------------------------------------------


class BaseConv(nn.Module):
    """csp_darknet BaseConv: conv (no bias) + bn + silu (:213-228)."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride,
                              padding=(kernel - 1) // 2, bias=False)
        self.bn = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(conv_bn(x, self.conv, self.bn))


class RepConvBN(nn.Module):
    """cspresnet ConvBNLayer: conv (no bias) + bn, no act (:231-243)."""

    def __init__(self, in_c: int, out_c: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel,
                              padding=(kernel - 1) // 2, bias=False)
        self.bn = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(x, self.conv, self.bn)


class RepVggBlock(nn.Module):
    """The unfused form the checkpoints store: silu(3×3 + 1×1)
    (:246-255)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = RepConvBN(c, c, 3)
        self.conv2 = RepConvBN(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    """(:258-273)."""

    def __init__(self, in_c: int, out_c: int, num_blocks: int,
                 expansion: float = 1.0):
        super().__init__()
        hidden = int(out_c * expansion)
        self.conv1 = BaseConv(in_c, hidden, 1)
        self.conv2 = BaseConv(in_c, hidden, 1)
        self.bottlenecks = nn.ModuleList([RepVggBlock(hidden)
                                          for _ in range(num_blocks)])
        if hidden != out_c:
            self.conv3 = BaseConv(hidden, out_c, 1)
        self.fuse = hidden != out_c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.conv1(x), self.conv2(x)
        for block in self.bottlenecks:
            a = block(a)
        h = a + b
        return self.conv3(h) if self.fuse else h


class FusedMHA(nn.Module):
    """ppdet MultiHeadAttention with qkv_same_embed_dim (:276-304): one
    ``in_proj_weight`` in Paddle's (d, 3d) layout applied as x @ w[:, :d],
    q scaled by hd^-0.5 before q·kᵀ, the softmax in float32 cast back to
    q's dtype, then ``out_proj``."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(embed_dim,
                                                       3 * embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor,
                v_in: torch.Tensor) -> torch.Tensor:
        d, h = self.embed_dim, self.num_heads
        hd = d // h
        w = self.in_proj_weight.to(q_in.dtype)
        b = self.in_proj_bias.to(q_in.dtype)
        q = q_in @ w[:, :d] + b[:d]
        k = k_in @ w[:, d:2 * d] + b[d:2 * d]
        v = v_in @ w[:, 2 * d:] + b[2 * d:]
        bsz, lq, lk = q.shape[0], q.shape[1], k.shape[1]
        q = q.reshape(bsz, lq, h, hd) * (hd ** -0.5)
        k = k.reshape(bsz, lk, h, hd)
        v = v.reshape(bsz, lk, h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k)
        attn = torch.softmax(attn.float(), -1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bsz, lq, d)
        return self.out_proj(out)


class TransformerEncoderLayerAIFI(nn.Module):
    """Post-norm encoder layer, gelu FFN (:307-326)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = FusedMHA(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        h = self.linear2(F.gelu(self.linear1(src)))
        return self.norm2(src + h)


def sincos_pos_embed_2d(w: int, h: int, embed_dim: int,
                        temperature: float = 10000.0) -> np.ndarray:
    """build_2d_sincos_position_embedding, replicated literally with its
    meshgrid(w, h) flatten order (:329-343; host numpy, the same code)."""
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32),
                                 indexing="ij")
    pos_dim = embed_dim // 4
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w),
                           np.sin(out_h), np.cos(out_h)], axis=1)[None]


class _Layers(nn.Module):
    """A holder whose children sit at ``<name>.layers.{i}``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class HybridEncoder(nn.Module):
    """AIFI + CCFF over three levels; returns three (B, hidden, H, W)
    maps (:346-403)."""

    def __init__(self, in_channels: Sequence[int], hidden_dim: int = 256,
                 use_encoder_idx: Tuple[int, ...] = (2,),
                 num_encoder_layers: int = 1, nhead: int = 8,
                 dim_feedforward: int = 1024, expansion: float = 1.0,
                 depth_mult: float = 1.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.use_encoder_idx = use_encoder_idx
        self.input_proj = nn.ModuleList([
            nn.Sequential(nn.Conv2d(c, hidden_dim, 1, bias=False),
                          FrozenBatchNorm2d(hidden_dim))
            for c in in_channels])
        self.encoder = nn.ModuleList([_Layers([
            TransformerEncoderLayerAIFI(hidden_dim, nhead, dim_feedforward)
            for _ in range(num_encoder_layers)]) for _ in use_encoder_idx])
        nlev, nb = len(in_channels), round(3 * depth_mult)
        self.lateral_convs = nn.ModuleList([
            BaseConv(hidden_dim, hidden_dim, 1) for _ in range(nlev - 1)])
        self.fpn_blocks = nn.ModuleList([
            CSPRepLayer(2 * hidden_dim, hidden_dim, nb, expansion)
            for _ in range(nlev - 1)])
        self.downsample_convs = nn.ModuleList([
            BaseConv(hidden_dim, hidden_dim, 3, stride=2)
            for _ in range(nlev - 1)])
        self.pan_blocks = nn.ModuleList([
            CSPRepLayer(2 * hidden_dim, hidden_dim, nb, expansion)
            for _ in range(nlev - 1)])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        nlev = len(feats)
        proj = [conv_bn(f, p[0], p[1]) for p, f in zip(self.input_proj,
                                                        feats)]
        for enc, enc_ind in zip(self.encoder, self.use_encoder_idx):
            f = proj[enc_ind]
            b, c, h, w = f.shape
            seq = f.flatten(2).transpose(1, 2)               # (B, HW, C)
            pos = torch.from_numpy(sincos_pos_embed_2d(
                w, h, self.hidden_dim)).to(device=f.device, dtype=f.dtype)
            for layer in enc.layers:
                seq = layer(seq, pos)
            proj[enc_ind] = seq.transpose(1, 2).reshape(b, c, h, w)

        inner = [proj[-1]]
        for idx in range(nlev - 1, 0, -1):
            hi = self.lateral_convs[nlev - 1 - idx](inner[0])
            inner[0] = hi
            up = F.interpolate(hi, scale_factor=2, mode="nearest")
            inner.insert(0, self.fpn_blocks[nlev - 1 - idx](
                torch.cat([up, proj[idx - 1]], 1)))
        outs = [inner[0]]
        for idx in range(nlev - 1):
            down = self.downsample_convs[idx](outs[-1])
            outs.append(self.pan_blocks[idx](
                torch.cat([down, inner[idx + 1]], 1)))
        return outs


# --------------------------------------------------------------------------
# RTDETRTransformer
# --------------------------------------------------------------------------


class MLPHead(nn.Module):
    """ppdet MLP: ``layers.{i}`` Linears with relu between (:410-425)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList([nn.Linear(dims[i], dims[i + 1])
                                     for i in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _bilinear_gather(value: torch.Tensor, gx: torch.Tensor,
                     gy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """grid_sample(align_corners=False, padding_mode='zeros') over one
    flattened level, as the JAX function computes it (:428-452): four
    taps at the clipped indices, each weighted by its bilinear weight
    times its in-bounds mask, summed in the order (0,0), (0,1), (1,0),
    (1,1). value (B, heads, h·w, hd) float32; gx, gy (B, heads, S) pixel
    coordinates (``loc·size − 0.5``). Returns (B, heads, S, hd)."""
    hd = value.shape[-1]
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
            inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xi_c = torch.clamp(xi, 0, w - 1).long()
            yi_c = torch.clamp(yi, 0, h - 1).long()
            idx = yi_c * w + xi_c
            g = torch.gather(value, 2, idx[..., None].expand(*idx.shape, hd))
            term = g * (wgt * inb.float())[..., None]
            out = term if out is None else out + term
    return out


class MSDeformableAttention(nn.Module):
    """Multi-scale deformable attention, 4-d reference points
    (:455-506)."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        hlp = num_heads * num_levels * num_points
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.sampling_offsets = nn.Linear(embed_dim, hlp * 2)
        self.attention_weights = nn.Linear(embed_dim, hlp)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor,
                value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        b, q, _ = query.shape
        nh, nl, npt = self.num_heads, self.num_levels, self.num_points
        hd = self.embed_dim // nh
        v = self.value_proj(value).reshape(b, -1, nh, hd)
        off = self.sampling_offsets(query).float().reshape(
            b, q, nh, nl, npt, 2)
        aw = torch.softmax(self.attention_weights(query).float().reshape(
            b, q, nh, nl * npt), -1).reshape(b, q, nh, nl, npt)

        ref = ref_points.float()                       # (B, Q, 4) cxcywh
        loc = (ref[:, :, None, None, None, :2]
               + off / npt * ref[:, :, None, None, None, 2:] * 0.5)

        v32 = v.float().transpose(1, 2)                # (B, heads, V, hd)
        start, level_out = 0, []
        for lvl, (h, w) in enumerate(spatial_shapes):
            vl = v32[:, :, start:start + h * w]
            start += h * w
            lo = loc[:, :, :, lvl]                     # (B, Q, H, P, 2)
            gx = lo[..., 0].transpose(1, 2).reshape(b, nh, q * npt) * w - 0.5
            gy = lo[..., 1].transpose(1, 2).reshape(b, nh, q * npt) * h - 0.5
            g = _bilinear_gather(vl, gx, gy, h, w)
            level_out.append(g.reshape(b, nh, q, npt, hd))
        sampled = torch.stack(level_out, 3)            # (B, H, Q, L, P, hd)
        wts = aw.permute(0, 2, 1, 3, 4)                # (B, H, Q, L, P)
        out = (sampled * wts[..., None]).sum((3, 4))   # (B, H, Q, hd)
        out = out.transpose(1, 2).reshape(b, q, self.embed_dim)
        return self.output_proj(out.to(query.dtype))


class TransformerDecoderLayerRT(nn.Module):
    """(:509-534)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 1024, num_levels: int = 3,
                 num_points: int = 4):
        super().__init__()
        self.self_attn = FusedMHA(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformableAttention(d_model, nhead, num_levels,
                                                num_points)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, ref_points, memory, spatial_shapes, query_pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        cross = self.cross_attn(tgt + query_pos, ref_points, memory,
                                spatial_shapes)
        tgt = self.norm2(tgt + cross)
        h = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + h)


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """log(x / (1 − x)) with both clipped at ``eps`` (:537-539)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.log(torch.clamp(x, min=eps) / torch.clamp(1.0 - x, min=eps))


def generate_anchors(spatial_shapes: Sequence[Tuple[int, int]],
                     grid_size: float = 0.05, eps: float = 1e-2
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """rtdetr_transformer._generate_anchors (:542-558; host numpy, the
    same code): logit-space anchors (1, ΣHW, 4), ``inf`` where invalid,
    and the validity mask (1, ΣHW, 1)."""
    anchors = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        gxy = np.stack([gx, gy], -1)
        gxy = (gxy + 0.5) / np.array([w, h], np.float32)
        wh = np.ones_like(gxy) * grid_size * (2.0 ** lvl)
        anchors.append(np.concatenate([gxy, wh], -1).reshape(1, h * w, 4))
    a = np.concatenate(anchors, axis=1)
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdims=True)
    a = np.log(a / (1 - a))
    a = np.where(valid, a, np.inf)
    return a.astype(np.float32), valid


class _InputProj(nn.Module):
    """``input_proj.{i}``: ``conv`` + ``norm``."""

    def __init__(self, in_c: int, hidden_dim: int):
        super().__init__()
        self.conv = nn.Conv2d(in_c, hidden_dim, 1, bias=False)
        self.norm = FrozenBatchNorm2d(hidden_dim)


class RTDETRTransformer(nn.Module):
    """(:561-644)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 hidden_dim: int = 256, num_queries: int = 300,
                 nhead: int = 8, num_levels: int = 3, num_points: int = 4,
                 num_decoder_layers: int = 6, dim_feedforward: int = 1024):
        super().__init__()
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.input_proj = nn.ModuleList([_InputProj(c, hidden_dim)
                                         for c in in_channels])
        # training-only denoising embedding: in the checkpoints, so the
        # conversion is strict; unused at eval (:587-591)
        self.denoising_class_embed = nn.Embedding(num_classes + 1,
                                                  hidden_dim)
        self.enc_output = nn.Sequential(nn.Linear(hidden_dim, hidden_dim),
                                        nn.LayerNorm(hidden_dim, eps=1e-5))
        self.enc_score_head = nn.Linear(hidden_dim, num_classes)
        self.enc_bbox_head = MLPHead(hidden_dim, hidden_dim, 4, 3)
        self.query_pos_head = MLPHead(4, 2 * hidden_dim, hidden_dim, 2)
        self.decoder = _Layers([
            TransformerDecoderLayerRT(hidden_dim, nhead, dim_feedforward,
                                      num_levels, num_points)
            for _ in range(num_decoder_layers)])
        self.dec_bbox_head = nn.ModuleList([
            MLPHead(hidden_dim, hidden_dim, 4, 3)
            for _ in range(num_decoder_layers)])
        # one score head per layer in the checkpoint; eval reads only the
        # last one's output (:633-642)
        self.dec_score_head = nn.ModuleList([
            nn.Linear(hidden_dim, num_classes)
            for _ in range(num_decoder_layers)])

    def forward(self, feats: Sequence[torch.Tensor]):
        dt, b = feats[0].dtype, feats[0].shape[0]
        dev = feats[0].device
        spatial_shapes = [(int(f.shape[2]), int(f.shape[3])) for f in feats]
        memory = torch.cat([
            conv_bn(f, p.conv, p.norm).flatten(2).transpose(1, 2)
            for p, f in zip(self.input_proj, feats)], 1)   # (B, ΣHW, D)

        # encoder-output query selection
        anchors_np, valid_np = generate_anchors(spatial_shapes)
        anchors = torch.from_numpy(anchors_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        mem_f = torch.where(valid, memory.float(),
                            torch.zeros((), device=dev)).to(dt)
        out_mem = self.enc_output(mem_f)
        enc_logits = self.enc_score_head(out_mem)
        enc_coord = self.enc_bbox_head(out_mem).float() + anchors

        top_sc = enc_logits.float().max(-1).values
        _, topk_ind = topk_stable(top_sc, self.num_queries)   # (B, Q)

        def take(t):
            return torch.gather(t, 1, topk_ind[..., None].expand(
                -1, -1, t.shape[-1]))

        ref_unact, target, enc_topk_logits = (take(enc_coord), take(out_mem),
                                              take(enc_logits))

        # decoder with iterative refinement
        ref_points = torch.sigmoid(ref_unact)             # float32
        output = target
        logits = boxes = None
        last = self.num_decoder_layers - 1
        for li, layer in enumerate(self.decoder.layers):
            query_pos = self.query_pos_head(ref_points.to(dt))
            output = layer(output, ref_points, memory, spatial_shapes,
                           query_pos)
            delta = self.dec_bbox_head[li](output)
            inter_ref = torch.sigmoid(delta.float()
                                      + _inverse_sigmoid(ref_points))
            if li == last:
                logits = self.dec_score_head[li](output)
                boxes = inter_ref
            ref_points = inter_ref
        return logits.float(), boxes, enc_topk_logits


class RTDETRExact(nn.Module):
    """backbone → neck → transformer (:647-671). Input (B, H, W, 3)
    normalized; output ((B, Q, C) logits float32, (B, Q, 4) cxcywh in
    [0, 1] float32)."""

    def __init__(self, num_classes: int, arch: str = "L",
                 hidden_dim: int = 256, num_queries: int = 300,
                 num_decoder_layers: int = 6, nhead: int = 8,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.backbone = PPHGNetV2Det(arch)
        chans = self.backbone.out_channels()
        self.neck = HybridEncoder(chans, hidden_dim=hidden_dim, nhead=nhead,
                                  dim_feedforward=dim_feedforward)
        self.transformer = RTDETRTransformer(
            num_classes, [hidden_dim] * len(chans), hidden_dim=hidden_dim,
            num_queries=num_queries, nhead=nhead,
            dim_feedforward=dim_feedforward,
            num_decoder_layers=num_decoder_layers)

    def forward(self, x_nhwc: torch.Tensor):
        feats = self.backbone(x_nhwc.permute(0, 3, 1, 2))
        logits, boxes, _ = self.transformer(self.neck(feats))
        return logits, boxes


def rtdetr_postprocess(logits: torch.Tensor, boxes: torch.Tensor,
                       num_top: int = 300):
    """DETRPostProcess (use_focal_loss): sigmoid → top-k over Q·C →
    (scores, labels, normalized xyxy boxes) (:674-687)."""
    b, q, c = logits.shape
    scores = torch.sigmoid(logits).reshape(b, q * c)
    top_sc, idx = topk_stable(scores, min(num_top, q * c))
    labels = idx % c
    qidx = idx // c
    sel = torch.gather(boxes, 1, qidx[..., None].expand(-1, -1, 4))
    cx, cy, w, h = sel.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return top_sc, labels, xyxy

"""Exact SLANeXt: Vary-ViT-B (the SAM ViT encoder) + SLAHead at the
official tensor names.

Counterpart of ``oar_ocr_tpu/models/recognition/slanext_exact.py``:
``LayerNorm2d`` (:49-61), ``_get_rel_pos`` (:64-78), ``SAMAttention``
(:81-114), the window partition (:117-137), ``MLPBlock``, ``SAMBlock``
(:140-172), ``ImageEncoderViT`` (:175-224), ``VaryVITB`` (:227-257,
with ``net_3`` and ``mm_projector_vary`` for PP-FormulaNet-L),
``SLANeXtExact`` (:260-289) and ``SLANeXtExactModel`` (:297-318): the
keep-ratio square canvas of ``slanet_exact.SLANetExactModel``, 512 for
the wired model and 488 for the wireless one.

The ViT runs NHWC as the JAX module does (tokens on the last axis); the
convolutions permute to NCHW around ``F.conv2d``. Attention is plain
PyTorch, as it is plain einsum in the JAX package: its decomposed
relative-position bias is added to the scores before the softmax, which
K2 (``ops/flash_attention.py``) has no input for.

At 488 px the patch grid is 30 and the checkpoint's is 32: ``pos_embed``
and the global blocks' rel-pos tables are re-interpolated as
``jax.image.resize(method="linear", antialias=False)`` does it
(:func:`resize_linear`: half-pixel sample points, triangle weights
normalized by their sum, zero outside the input, one weight matrix per
resized axis).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .slanet import TABLE_STRUCTURE_VOCAB
from .slanet_exact import SLAHeadExact, SLANetExactModel


@lru_cache(maxsize=None)
def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of a linear resize without antialiasing
    (``jax/_src/image/scale.py`` ``compute_weight_mat``), in float32:
    sample point (j + 0.5)/scale − 0.5 with scale = out/in, weight
    max(0, 1 − |sample − i|), each column divided by its sum, zeroed
    where the sample lies outside [−0.5, in − 0.5]."""
    inv_scale = np.float32(1) / (np.float32(out_size) / np.float32(in_size))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, sizes, "linear", antialias=False)`` of a
    float32 tensor: each axis whose size changes contracted with its
    weight matrix."""
    for axis, out in enumerate(sizes):
        if x.shape[axis] == out:
            continue
        w = torch.from_numpy(_linear_weights(x.shape[axis], out)).to(x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1,
                          axis)
    return x


def get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Decomposed rel-pos table (size, size, C) for q_size = k_size =
    size, the stored table re-interpolated when its length is not
    2·size − 1 (``slanext_exact.py:64-78``)."""
    max_rel_dist = 2 * size - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_linear(rel_pos.float(),
                                (max_rel_dist, rel_pos.shape[1]))
    idx = (np.arange(size)[:, None] - np.arange(size)[None, :] + size - 1)
    return rel_pos[torch.from_numpy(idx).to(rel_pos.device)]


class LayerNorm2d(nn.Module):
    """SAM's neck LayerNorm over the channel axis of an NHWC map, in
    float32, eps 1e-6 (``slanext_exact.py:49-61``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        u = x32.mean(-1, keepdim=True)
        s = ((x32 - u) ** 2).mean(-1, keepdim=True)
        y = (x32 - u) / torch.sqrt(s + 1e-6)
        return (self.weight * y + self.bias).to(x.dtype)


class SAMAttention(nn.Module):
    """Windowed or global attention with decomposed relative positions
    (``slanext_exact.py:81-114``); ``table_size``: the stored tables
    cover 2·table_size − 1 offsets."""

    def __init__(self, dim: int, heads: int, table_size: int):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * table_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * table_size - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, dim = x.shape
        hd = dim // self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * self.heads, h * w,
                                                 hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * (hd ** -0.5)) @ k.transpose(1, 2)
        rh = get_rel_pos(h, self.rel_pos_h).to(q.dtype)
        rw = get_rel_pos(w, self.rel_pos_w).to(q.dtype)
        r_q = q.reshape(-1, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = attn + (rel_h[:, :, :, :, None]
                       + rel_w[:, :, :, None, :]).reshape(-1, h * w, h * w)
        attn = torch.softmax(attn.float(), -1).to(q.dtype)
        out = (attn @ v).reshape(b, self.heads, h, w, hd)
        out = out.permute(0, 2, 3, 1, 4).reshape(b, h, w, dim)
        return self.proj(out)


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) → (B·nH·nW, ws, ws, C) windows, zero-padded to whole
    windows, and the padded (Hp, Wp) (``slanext_exact.py:117-127``)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp))


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw, hw):
    """The inverse of :func:`window_partition`, the padding cut off
    (``slanext_exact.py:130-137``)."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class MLPBlock(nn.Module):
    """lin1 → exact GELU → lin2 (``slanext_exact.py:140-148``)."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class SAMBlock(nn.Module):
    """Pre-norm block, windowed (``window`` > 0) or global
    (``slanext_exact.py:151-172``)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, window: int,
                 global_table: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SAMAttention(dim, heads,
                                 window if window > 0 else global_table)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window > 0:
            h, w = y.shape[1], y.shape[2]
            y, pad_hw = window_partition(y, self.window)
            y = window_unpartition(self.attn(y), self.window, pad_hw, (h, w))
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class ImageEncoderViT(nn.Module):
    """SAM ViT encoder + Vary's ``net_2`` tail; NHWC in, NHWC out at
    stride 32 with ``net2_out`` channels (``slanext_exact.py:175-224``),
    or with ``net3_out`` > 0 Vary's ``net_3`` after it, stride 64 with
    ``net3_out`` channels (PP-FormulaNet-L's full tower). ``neck`` is
    SAM's 1×1 conv, LayerNorm2d, 3×3 conv, LayerNorm2d."""

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12,
                 heads: int = 12, mlp_ratio: float = 4.0,
                 out_chans: int = 256, window: int = 14,
                 global_idx: Tuple[int, ...] = (2, 5, 8, 11),
                 net2_out: int = 512, net3_out: int = 0,
                 pos_grid: int = 32):
        super().__init__()
        self.patch_embed = _PatchEmbed(patch, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid, pos_grid,
                                                  dim))
        self.blocks = nn.ModuleList([
            SAMBlock(dim, heads, mlp_ratio,
                     0 if i in global_idx else window, pos_grid)
            for i in range(depth)])
        self.neck = nn.ModuleList([
            nn.Conv2d(dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans)])
        self.net_2 = nn.Conv2d(out_chans, net2_out, 3, 2, padding=1,
                               bias=False)
        if net3_out:
            self.net_3 = nn.Conv2d(net2_out, net3_out, 3, 2, padding=1,
                                   bias=False)
        else:
            self.net_3 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_nhwc(x, self.patch_embed.proj)
        pos = self.pos_embed
        if pos.shape[1:3] != x.shape[1:3]:
            pos = resize_linear(pos.float(), (1, x.shape[1], x.shape[2],
                                              pos.shape[3]))
        x = x + pos.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        conv0, norm1, conv2, norm3 = self.neck
        x = norm3(_conv_nhwc(norm1(_conv_nhwc(x, conv0)), conv2))
        x = _conv_nhwc(x, self.net_2)
        return x if self.net_3 is None else _conv_nhwc(x, self.net_3)


class VaryVITB(nn.Module):
    """Vary_VIT_B (``slanext_exact.py:227-257``): the encoder at
    ``vision_tower_high``; with ``projector=True`` its map flattened to a
    (B, H·W, C) sequence through the ``mm_projector_vary`` Dense (the
    PP-FormulaNet-L encoder), else the NHWC map (SLANeXt)."""

    def __init__(self, projector: bool = False, **encoder_kw):
        super().__init__()
        self.vision_tower_high = ImageEncoderViT(**encoder_kw)
        if projector:
            c = encoder_kw.get("net3_out") or encoder_kw.get("net2_out", 512)
            self.mm_projector_vary = nn.Linear(c, c)
        else:
            self.mm_projector_vary = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.vision_tower_high(x)
        if self.mm_projector_vary is None:
            return x
        b, h, w, c = x.shape
        return self.mm_projector_vary(x.reshape(b, h * w, c))


class SLANeXtExact(nn.Module):
    """backbone → head at the checkpoint roots; input (N, 3, S, S)
    normalized BGR (NCHW, as the other table models); ``forward`` gives
    (logits, corners, steps run) through the plain loop
    (``slanext_exact.py:260-289``)."""

    def __init__(self, vocab_size: int = len(TABLE_STRUCTURE_VOCAB),
                 patch: int = 16, dim: int = 768, depth: int = 12,
                 heads: int = 12, out_chans: int = 256, window: int = 14,
                 global_idx: Tuple[int, ...] = (2, 5, 8, 11),
                 net2_out: int = 512, pos_grid: int = 32,
                 hidden_size: int = 512, max_text_length: int = 500,
                 loc_reg_num: int = 8):
        super().__init__()
        self.backbone = VaryVITB(
            patch=patch, dim=dim, depth=depth, heads=heads,
            out_chans=out_chans, window=window, global_idx=global_idx,
            net2_out=net2_out, pos_grid=pos_grid)
        self.head = SLAHeadExact(vocab_size, net2_out, hidden_size,
                                 max_text_length, loc_reg_num)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The (N, HW, C) float32 memory of the backbone's map."""
        fea = self.backbone(x.permute(0, 2, 3, 1))
        return fea.reshape(fea.shape[0], -1, fea.shape[3]).float()

    def forward(self, x: torch.Tensor):
        return self.head.decode(self.features(x))


class SLANeXtExactModel(SLANetExactModel):
    """The keep-ratio square-canvas driver of
    :class:`~.slanet_exact.SLANetExactModel` around :class:`SLANeXtExact`
    (``slanext_exact.py:297-318``): ``input_size`` 512 (wired) or 488
    (wireless)."""

    TIMER = "slanet_exact.device"

    def __init__(self, state_dict=None, *, input_size: int = 512,
                 runtime=None, **model_kw):
        self.INPUT = input_size
        super().__init__(state_dict, runtime=runtime, **model_kw)

    def _make_model(self, **model_kw) -> nn.Module:
        return SLANeXtExact(**model_kw)

"""Device-side detection ops: separable resize+normalize, bit-packing,
the bitmap dilation, quad scoring and polygon scoring.

Counterpart of ``oar_ocr_tpu/ops/det_device.py``. The two interpolation
products of :func:`separable_resize_normalize` stay ``torch.matmul`` in
float32 (TF32 is off, ``runtime.Runtime``), as the JAX package computes
them at ``Precision.HIGHEST`` outside any Pallas kernel
(``det_device.py:77-84``); the normalize, the pad mask and the cast that
follow go through the K1 kernel (``ops/normalize.normalize_masked``).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

from .normalize import normalize_masked


def _interp_weights(dst_pad: int, src_len: int, src_valid: torch.Tensor,
                    dst_valid: torch.Tensor) -> torch.Tensor:
    """(B, dst_pad, src_len) bilinear tent weights in cv2's half-pixel
    convention with border clamp; 0 beyond ``dst_valid``."""
    dev = src_valid.device
    o = torch.arange(dst_pad, dtype=torch.float32, device=dev)[None, :]
    scale = (src_valid.float() / dst_valid.float())[:, None]
    pos = (o + 0.5) * scale - 0.5
    pos = torch.minimum(torch.clamp(pos, min=0.0),
                        src_valid.float()[:, None] - 1.0)
    i = torch.arange(src_len, dtype=torch.float32, device=dev)[None, None, :]
    w = torch.clamp(1.0 - torch.abs(pos[:, :, None] - i), min=0.0)
    return torch.where(o[:, :, None] < dst_valid.float()[:, None, None],
                       w, torch.zeros((), device=dev))


def resample(images: torch.Tensor, ry: torch.Tensor,
             cx: torch.Tensor) -> torch.Tensor:
    """out[b] = ry[b] · img[b] · cx[b]ᵀ per channel, in float32:
    (B, H, W, C) with ry (B, Ho, H), cx (B, Wo, W) → (B, Ho, Wo, C)."""
    b, h, w, c = images.shape
    ho, wo = ry.shape[1], cx.shape[1]
    img = images.float().reshape(b, h, w * c)
    t = torch.bmm(ry, img).reshape(b, ho, w, c)           # contract H
    t = t.permute(0, 1, 3, 2).reshape(b, ho * c, w)
    out = torch.bmm(t, cx.transpose(1, 2))                # contract W
    return out.reshape(b, ho, c, wo).permute(0, 1, 3, 2).contiguous()


def separable_resize_normalize(
    images: torch.Tensor,            # (B, H, W, 3) uint8/float, zero-padded
    src_h: torch.Tensor,             # (B,) int32 valid source heights
    src_w: torch.Tensor,
    dst_h: torch.Tensor,             # (B,) int32 valid target heights
    dst_w: torch.Tensor,
    alpha: Sequence[float],          # fused normalize: out·alpha + beta
    beta: Sequence[float],
    *,
    out_h: int,
    out_w: int,
    out_dtype: torch.dtype = torch.bfloat16,
    pad_value: Union[float, Sequence[float]] = 0.0,
    swap_rb: bool = False,
    caller: str = "det",
) -> torch.Tensor:
    """Per-image bilinear resize to (dst_h[b], dst_w[b]) inside a padded
    (out_h, out_w) tile, then the K1 normalize with ``pad_value`` beyond
    the valid extent: 0 for detection, −1 (β) for recognition
    (``det_device.py:65-69``). ``swap_rb`` reverses the channels before
    normalizing (the rec gather path's BGR flip, ``recognizer.py:165``)."""
    ry = _interp_weights(out_h, images.shape[1], src_h, dst_h)
    cx = _interp_weights(out_w, images.shape[2], src_w, dst_w)
    out = resample(images, ry, cx)
    return normalize_masked(out, alpha, beta, valid_h=dst_h, valid_w=dst_w,
                            pad=pad_value, swap_rb=swap_rb,
                            out_dtype=out_dtype, caller=caller)


def dilate2x2(bitmap: torch.Tensor) -> torch.Tensor:
    """2×2 OR-dilation of a (B, H, W) bool map, window anchored at the
    top-left with False beyond the bottom/right edge (``detector.py:135-141``
    reduce_window padding ((0, 1), (0, 1)))."""
    x = F.pad(bitmap.to(torch.uint8)[:, None], (0, 1, 0, 1))
    return F.max_pool2d(x.float(), 2, stride=1)[:, 0] > 0


def pack_bits(bitmap: torch.Tensor) -> torch.Tensor:
    """(…, W) bool → (…, W/8) uint8, MSB-first (np.unpackbits order).
    W must be a multiple of 8. The bit weights 128 … 1 are made on the
    device: a table copied from the host would block the host until the
    stream's queued work is done (a pageable copy syncs)."""
    shape = bitmap.shape
    x = bitmap.to(torch.uint8).reshape(*shape[:-1], shape[-1] // 8, 8)
    wts = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=x.device)
    return (x * wts).sum(-1, dtype=torch.int32).to(torch.uint8)


def quad_scores(prob: torch.Tensor, quads: torch.Tensor,
                img_idx: torch.Tensor, *, chunk: int = 8) -> torch.Tensor:
    """Mean probability inside each convex quad (box_score_fast).

    prob (B, H, W) f32; quads (K, 4, 2) (x, y) in prob-map coordinates;
    img_idx (K,). Inclusive half-plane tests at pixel centres; quads may
    wind either way. No padding of K is needed (eager execution), so the
    JAX package's candidate-count buckets have no counterpart here."""
    _, h, w = prob.shape
    k = quads.shape[0]
    dev = prob.device
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    x, y = quads[..., 0], quads[..., 1]
    area2 = (x * torch.roll(y, -1, 1) - torch.roll(x, -1, 1) * y).sum(1)
    sign = torch.where(area2 >= 0, 1.0, -1.0)[:, None, None]
    out = torch.zeros(k, dtype=torch.float32, device=dev)
    for s in range(0, k, chunk):
        q = quads[s:s + chunk]
        inside = torch.ones((q.shape[0], h, w), dtype=torch.bool, device=dev)
        for e in range(4):
            p0, p1 = q[:, e], q[:, (e + 1) % 4]
            ex = (p1[:, 0] - p0[:, 0])[:, None, None]
            ey = (p1[:, 1] - p0[:, 1])[:, None, None]
            cross = (ex * (py - p0[:, 1][:, None, None])
                     - ey * (px - p0[:, 0][:, None, None]))
            inside &= cross * sign[s:s + chunk] >= 0
        pmap = prob[img_idx[s:s + chunk]]
        num = torch.where(inside, pmap, 0.0).sum((1, 2))
        den = inside.sum((1, 2)).float()
        out[s:s + chunk] = torch.where(den > 0, num / torch.clamp(den, min=1),
                                       0.0)
    return out


def poly_scores(prob: torch.Tensor, polys: torch.Tensor,
                img_idx: torch.Tensor, *, chunk: int = 4) -> torch.Tensor:
    """Mean probability inside arbitrary simple polygons (the POLY/seal
    path's box score over simplified contours, ``det_device.py:223-261``):
    even-odd ray casting per pixel against the resident probability map,
    in groups of ``chunk`` polygons, so a group's (chunk, H, W) crossing
    counts bound the memory.

    prob (B, H, W) f32; polys (K, P, 2) (x, y), vertices padded by
    REPEATING vertex 0 (zero-length edges cross nothing); img_idx (K,).
    K need not be a multiple of ``chunk`` (eager execution)."""
    _, h, w = prob.shape
    k, p, _ = polys.shape
    dev = prob.device
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    out = torch.zeros(k, dtype=torch.float32, device=dev)
    for s in range(0, k, chunk):
        q = polys[s:s + chunk]
        crossings = torch.zeros((q.shape[0], h, w), dtype=torch.int32,
                                device=dev)
        for e in range(p):
            x1 = q[:, e, 0][:, None, None]
            y1 = q[:, e, 1][:, None, None]
            x2 = q[:, (e + 1) % p, 0][:, None, None]
            y2 = q[:, (e + 1) % p, 1][:, None, None]
            straddles = (y1 > py) != (y2 > py)
            dy = torch.where((y2 - y1).abs() < 1e-9,
                             torch.full_like(y1, 1e-9), y2 - y1)
            xint = x1 + (py - y1) * (x2 - x1) / dy
            crossings += (straddles & (px < xint)).to(torch.int32)
        inside = (crossings % 2) == 1
        pmap = prob[img_idx[s:s + chunk]]
        num = torch.where(inside, pmap, 0.0).sum((1, 2))
        den = inside.sum((1, 2)).float()
        out[s:s + chunk] = torch.where(den > 0, num / torch.clamp(den, min=1),
                                       0.0)
    return out

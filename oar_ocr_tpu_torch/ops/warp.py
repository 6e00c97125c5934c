"""Recognition crop warps and their host-side matrix builders.

Counterpart of ``oar_ocr_tpu/ops/warp.py``:

- :func:`warp_rec_tiles_separable` — the composed warp→resize chain for
  axis-aligned or axis-swapped crops as two float32 matmuls per crop
  (TF32 off), then the K1 kernel with ``swap_rb`` (BGR) and pad = β;
- :func:`sample_transform` — the JAX op: the projective bilinear gather
  in plain PyTorch, then K1 for the normalize, the pad mask and the cast
  (the classifiers' and UVDoc's input); :func:`sample_pixels` is the
  gather alone, which the slanted rec crops take (the resize after it
  normalizes);
- jax-free copies of the host builders (``separable_coefs``,
  ``band_origin``, ``build_native_crop_matrix``, ``crop_geometry``,
  ``resize_matrix``), identical numpy code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .det_device import resample
from .normalize import normalize_masked


@dataclass(frozen=True)
class NormSpec:
    """Per-channel fused normalization: out = sample·alpha + beta, after
    an optional R/B swap (``warp.py:35-61``)."""

    alpha: Tuple[float, float, float]
    beta: Tuple[float, float, float]
    swap_rb: bool = False

    @staticmethod
    def imagenet_rgb(scale: float = 1.0 / 255.0) -> "NormSpec":
        """(x·scale − mean)/std with the ImageNet statistics, RGB."""
        mean = (0.485, 0.456, 0.406)
        std = (0.229, 0.224, 0.225)
        return NormSpec(
            alpha=tuple(scale / s for s in std),
            beta=tuple(-m / s for m, s in zip(mean, std)),
            swap_rb=False,
        )

    @staticmethod
    def rec_bgr() -> "NormSpec":
        """x·(2/255) − 1 in BGR order."""
        return NormSpec(alpha=(2.0 / 255.0,) * 3, beta=(-1.0,) * 3,
                        swap_rb=True)

    @staticmethod
    def identity() -> "NormSpec":
        return NormSpec(alpha=(1.0,) * 3, beta=(0.0,) * 3, swap_rb=False)


def sample_pixels(
    images_u8: torch.Tensor,     # (P, H, W, C) uint8 padded page batch
    mats: torch.Tensor,          # (B, 3, 3) f32: output px → source px
    img_idx: torch.Tensor,       # (B,) page index per item
    *,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """The gather of :func:`sample_transform` alone: projective-sample B
    items into a (B, out_h, out_w, C) float32 tile of raw pixel values.
    Coordinates are explicit f32 multiply-adds (``warp.py:95-104``)
    clamped to the page BEFORE the floor (``warp.py:106-112``).

    The slanted rec-crop path calls it directly: it feeds the tile to
    ``separable_resize_normalize``, which normalizes through K1 and clamps
    its taps to the valid native extent, so pixels beyond it are never
    read and no normalize pass runs here."""
    p, h, w, c = images_u8.shape
    b = mats.shape[0]
    dev = images_u8.device
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    gx, gy = xs.reshape(1, -1), ys.reshape(1, -1)

    def row(i):
        return (mats[:, i, 0][:, None] * gx + mats[:, i, 1][:, None] * gy
                + mats[:, i, 2][:, None])

    sxn, syn, denom = row(0), row(1), row(2)
    denom = torch.where(denom.abs() < 1e-8,
                        torch.full_like(denom, 1e-8), denom)
    sx = torch.clamp(sxn / denom, 0.0, w - 1.0)
    sy = torch.clamp(syn / denom, 0.0, h - 1.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)

    flat = images_u8.reshape(p * h * w, c)
    base = img_idx.long()[:, None] * h

    def fetch(yi, xi):
        return flat[((base + yi) * w + xi).reshape(-1)].reshape(
            b, -1, c).float()

    top = fetch(y0i, x0i) * (1.0 - fx) + fetch(y0i, x1i) * fx
    bot = fetch(y1i, x0i) * (1.0 - fx) + fetch(y1i, x1i) * fx
    return (top * (1.0 - fy) + bot * fy).reshape(b, out_h, out_w, c)


def sample_transform(
    images_u8: torch.Tensor,     # (P, H, W, C) uint8 padded page batch
    mats: torch.Tensor,          # (B, 3, 3) f32: output px → source px
    img_idx: torch.Tensor,       # (B,) page index per item
    valid_w: torch.Tensor,       # (B,) int valid output width
    valid_h: torch.Tensor,       # (B,) int valid output height
    *,
    out_h: int,
    out_w: int,
    norm: NormSpec,
    out_dtype: torch.dtype = torch.float32,
    pad_value: float = 0.0,
    caller: str = "sample_transform",
) -> torch.Tensor:
    """Projective-sample B items into a (B, out_h, out_w, C) tile
    (``warp.py:67-150``): the gather (:func:`sample_pixels`, plain
    PyTorch as it is XLA in the JAX package), then the K1 normalize with
    the norm's R/B swap, ``x·alpha + beta``, ``pad_value`` at
    y ≥ valid_h[b] or x ≥ valid_w[b], and the cast to ``out_dtype``.
    ``caller`` names the launch in K1's per-caller count."""
    raw = sample_pixels(images_u8, mats, img_idx, out_h=out_h, out_w=out_w)
    return normalize_masked(raw, norm.alpha, norm.beta, valid_h=valid_h,
                            valid_w=valid_w, pad=pad_value,
                            swap_rb=norm.swap_rb, out_dtype=out_dtype,
                            caller=caller)


def warp_crops(images_u8: torch.Tensor, mats: torch.Tensor,
               img_idx: torch.Tensor, valid_w: torch.Tensor, *, out_h: int,
               out_w: int, normalize: bool = True,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Recognition crops through :func:`sample_transform`, every row
    valid (``warp.py:152-163``); normalized tiles pad with the
    post-normalize black (−1) as every other rec path does."""
    valid_h = torch.full(valid_w.shape, out_h, dtype=torch.int32,
                         device=valid_w.device)
    norm = NormSpec.rec_bgr() if normalize else NormSpec.identity()
    return sample_transform(images_u8, mats, img_idx, valid_w, valid_h,
                            out_h=out_h, out_w=out_w, norm=norm,
                            out_dtype=out_dtype,
                            pad_value=-1.0 if normalize else 0.0,
                            caller="rec")


# ---------------- separable (matmul-only) rec-crop warp ----------------

def separable_coefs(matrix: np.ndarray, eps: float = 1e-6):
    """Classify a native-crop matrix (native px → page px) as separable:
    None, or ``(swapped, (row_a, row_b), (col_a, col_b))``
    (``warp.py:183-207``)."""
    m = np.asarray(matrix, np.float64)
    scale = max(np.abs(m[:2, :2]).max(), 1.0)
    if abs(m[2, 0]) > eps or abs(m[2, 1]) > eps or abs(m[2, 2] - 1.0) > eps:
        return None
    if abs(m[0, 1]) <= eps * scale and abs(m[1, 0]) <= eps * scale:
        return False, (float(m[1, 1]), float(m[1, 2])), \
            (float(m[0, 0]), float(m[0, 2]))
    if abs(m[0, 0]) <= eps * scale and abs(m[1, 1]) <= eps * scale:
        return True, (float(m[0, 1]), float(m[0, 2])), \
            (float(m[1, 0]), float(m[1, 2]))
    return None


def band_origin(row_coef, nat_h_valid: int, src_h: int, band_h: int) -> int:
    """First page row of the ``band_h``-row band covering a crop's
    sampled rows (``warp.py:210-218``)."""
    a, b = float(row_coef[0]), float(row_coef[1])
    lo = min(b, a * (nat_h_valid - 1) + b) - 1.0
    return int(np.clip(np.floor(lo), 0, max(src_h - band_h, 0)))


def _affine_tent(n_out: int, src_len: int, a, b, lo, hi, offset):
    """(B, n_out, src_len) tent weights; a/b/lo/hi/offset are (B,)."""
    dev = a.device
    i = torch.arange(n_out, dtype=torch.float32, device=dev)[None, :]
    pos = torch.minimum(torch.maximum(a[:, None] * i + b[:, None],
                                      lo[:, None]), hi[:, None])
    pos = pos - offset[:, None]
    s = torch.arange(src_len, dtype=torch.float32, device=dev)[None, None, :]
    return torch.clamp(1.0 - torch.abs(pos[..., None] - s), min=0.0)


def _resize_tent(n_out: int, src_bucket: int, dst_valid, src_valid,
                 out_valid):
    """(B, n_out, src_bucket) stage-2 weights (cv2 half-pixel,
    valid-extent clamp, zero beyond the valid output)."""
    dev = dst_valid.device
    o = torch.arange(n_out, dtype=torch.float32, device=dev)[None, :]
    scale = (src_valid / dst_valid)[:, None]
    pos = torch.minimum(torch.clamp((o + 0.5) * scale - 0.5, min=0.0),
                        src_valid[:, None] - 1.0)
    s = torch.arange(src_bucket, dtype=torch.float32, device=dev)[None, None, :]
    w = torch.clamp(1.0 - torch.abs(pos[..., None] - s), min=0.0)
    return torch.where(o[..., None] < out_valid[:, None, None], w,
                       torch.zeros((), device=dev))


def warp_rec_tiles_separable(
    src_pages: torch.Tensor,     # (P, SH, SW, C) uint8 pages (transposed
                                 # pages for the axis-swapped crop group)
    row_coef: torch.Tensor,      # (B, 2) f32 (a, b): src row = a·i + b
    col_coef: torch.Tensor,      # (B, 2) f32
    img_idx: torch.Tensor,       # (B,) int
    band_y0: torch.Tensor,       # (B,) int band origin (band_origin())
    nat_h: torch.Tensor,         # (B,) int valid native crop dims
    nat_w: torch.Tensor,
    dst_w: torch.Tensor,         # (B,) int valid output width (≤ out_w)
    *,
    out_h: int,
    out_w: int,
    nat_h_bucket: int,
    nat_w_bucket: int,
    band_h: int,
    norm: NormSpec,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """tile_b = (W2y·W1y)_b · band_b · (W1x·W2x)_bᵀ — the exact
    warp→resize chain as batched float32 matmuls — then the K1 normalize
    with the norm's swap and pad = β beyond ``dst_w`` (the reference pads
    rec tiles in image space before normalizing, ``warp.py:313-317``)."""
    p, sh, sw, c = src_pages.shape
    bh = min(band_h, sh)
    dev = src_pages.device
    y0 = torch.clamp(band_y0.long(), 0, sh - bh)
    rows = y0[:, None] + torch.arange(bh, device=dev)[None, :]
    bands = src_pages[img_idx.long()[:, None], rows]      # (B, bh, SW, C)

    zeros = torch.zeros(band_y0.shape, dtype=torch.float32, device=dev)
    y0f = band_y0.float()
    nhf, nwf, dwf = nat_h.float(), nat_w.float(), dst_w.float()
    full = torch.full_like(y0f, float(out_h))
    w1y = _affine_tent(nat_h_bucket, bh, row_coef[:, 0], row_coef[:, 1],
                       zeros, zeros + float(sh - 1), y0f)
    wy = torch.bmm(_resize_tent(out_h, nat_h_bucket, full, nhf, full), w1y)
    w1x = _affine_tent(nat_w_bucket, sw, col_coef[:, 0], col_coef[:, 1],
                       zeros, zeros + float(sw - 1), zeros)
    wx = torch.bmm(_resize_tent(out_w, nat_w_bucket, dwf, nwf, dwf), w1x)

    tiles = resample(bands, wy, wx)                       # (B, Ho, Wo, C)
    valid_h = torch.full(dst_w.shape, out_h, dtype=torch.int32, device=dev)
    return normalize_masked(tiles, norm.alpha, norm.beta, valid_h=valid_h,
                            valid_w=dst_w, pad=norm.beta,
                            swap_rb=norm.swap_rb, out_dtype=out_dtype,
                            caller="rec")


# ------------------------- host-side matrix builders -------------------------

def resize_matrix(src_h: int, src_w: int, dst_h: int, dst_w: int) -> np.ndarray:
    """Affine matrix for a pure resize, cv2 half-pixel convention."""
    sx = src_w / float(dst_w)
    sy = src_h / float(dst_h)
    return np.array([[sx, 0.0, 0.5 * sx - 0.5],
                     [0.0, sy, 0.5 * sy - 0.5],
                     [0.0, 0.0, 1.0]], np.float32)


def crop_geometry(quad: np.ndarray) -> Tuple[int, int, bool]:
    """(crop_w, crop_h, rotate90) for a TL,TR,BR,BL quad
    (``warp.py:335-346``)."""
    q = np.asarray(quad, np.float32).reshape(4, 2)
    cw = int(round(max(np.linalg.norm(q[0] - q[1]), np.linalg.norm(q[2] - q[3]))))
    ch = int(round(max(np.linalg.norm(q[0] - q[3]), np.linalg.norm(q[1] - q[2]))))
    cw, ch = max(cw, 1), max(ch, 1)
    return cw, ch, ch >= cw * 1.5


def build_native_crop_matrix(quad: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Matrix mapping NATIVE-resolution crop pixels → page pixels with
    the tall-crop rotation folded in; returns (matrix, rw, rh)
    (``warp.py:349-386``: pts_std at full W/H, rotate270 for h ≥ 1.5w)."""
    import cv2

    quad = np.asarray(quad, np.float32).reshape(4, 2)
    cw, ch, rot = crop_geometry(quad)
    pts_std = np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]], np.float32)
    m1 = cv2.getPerspectiveTransform(pts_std, quad)
    if rot:
        r = np.array([[0.0, -1.0, cw - 1.0],
                      [1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0]], np.float64)
        return (m1 @ r).astype(np.float32), ch, cw
    return m1.astype(np.float32), cw, ch

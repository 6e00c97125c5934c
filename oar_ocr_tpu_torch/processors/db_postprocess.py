"""DB bitmap → text quads or polygons (the host geometry half of
detection).

Copied value for value from ``oar_ocr_tpu/processors/db_postprocess.py``:
``DBPostProcessConfig`` (:36-49), ``order_mini_box_points`` (:52-59),
``get_mini_box`` (:62-75), ``box_score`` (:78-95), ``unclip_delta``
(:98-107), ``expand_rect`` (:110-126), ``unclip_polygon_raster``
(:129-147), ``_scale_clamp`` (:150-158) and ``DBPostProcess`` (:161-371):
the split quad path whose scores the device computes
(``ops/det_device.quad_scores``), the split POLY path whose scores the
device computes too (``ops/det_device.poly_scores``), and the whole-host
``__call__`` that the slow-score mode runs on the fetched probability map.

``finalize_quads_batch`` runs the port's native extension
(``oar_ocr_tpu_torch/native.py``) and falls back to the per-quad Python
form below when it is unavailable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import cv2
import numpy as np

from .. import native as native_mod
from ..core.types import BoxType, ScoreMode


@dataclass(frozen=True)
class DBPostProcessConfig:
    """Defaults: thresh 0.3, box_thresh 0.7, unclip_ratio 2.0 (the
    pipeline presets override these)."""

    thresh: float = 0.3
    box_thresh: float = 0.7
    max_candidates: int = 1000
    unclip_ratio: float = 2.0
    use_dilation: bool = False
    score_mode: ScoreMode = ScoreMode.FAST
    box_type: BoxType = BoxType.QUAD
    min_size: float = 3.0


def order_mini_box_points(pts: np.ndarray) -> np.ndarray:
    """PaddleX get_mini_boxes ordering: sort by x, pick [TL, TR, BR, BL]
    by y-comparisons within each x-pair."""
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    i1, i4 = (0, 1) if pts[1, 1] > pts[0, 1] else (1, 0)
    i2, i3 = (2, 3) if pts[3, 1] > pts[2, 1] else (3, 2)
    return pts[[i1, i2, i3, i4]]


def get_mini_box(points: np.ndarray) -> Optional[Tuple[np.ndarray, float]]:
    """Min-area rect of a point set → (ordered 4 pts, short side)."""
    points = np.asarray(points, np.float32).reshape(-1, 2)
    if len(points) < 3:
        return None
    rect = cv2.minAreaRect(points)
    (w, h) = rect[1]
    min_side = min(w, h)
    if not np.isfinite(min_side) or min_side <= 0:
        return None
    box = cv2.boxPoints(rect).astype(np.float32)
    return order_mini_box_points(box), float(min_side)


def box_score(pred: np.ndarray, polygon: np.ndarray) -> float:
    """Mean probability inside the polygon, evaluated only over its AABB
    (floor/ceil + inclusive-clamp semantics)."""
    h, w = pred.shape
    poly = np.asarray(polygon, np.float32).reshape(-1, 2)
    xmin = int(np.clip(np.floor(poly[:, 0].min()), 0, w - 1))
    xmax = int(np.clip(np.ceil(poly[:, 0].max()), 0, w - 1))
    ymin = int(np.clip(np.floor(poly[:, 1].min()), 0, h - 1))
    ymax = int(np.clip(np.ceil(poly[:, 1].max()), 0, h - 1))
    mask = np.zeros((ymax - ymin + 1, xmax - xmin + 1), np.uint8)
    shifted = poly.copy()
    shifted[:, 0] -= xmin
    shifted[:, 1] -= ymin
    cv2.fillPoly(mask, [np.round(shifted).astype(np.int32)], 1)
    region = pred[ymin : ymax + 1, xmin : xmax + 1]
    denom = int(mask.sum())
    return float((region * mask).sum() / denom) if denom > 0 else 0.0


def unclip_delta(polygon: np.ndarray, unclip_ratio: float) -> float:
    """delta = area·unclip_ratio / perimeter."""
    p = np.asarray(polygon, np.float64)
    x, y = p[:, 0], p[:, 1]
    area = abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0
    perimeter = float(np.sum(np.hypot(*(p - np.roll(p, -1, axis=0)).T)))
    if area <= np.finfo(np.float64).eps or perimeter <= np.finfo(np.float64).eps:
        return 0.0
    return float(area * unclip_ratio / perimeter)


def expand_rect(quad: np.ndarray, delta: float) -> np.ndarray:
    """Exact round-join offset of a rectangle followed by min-area-rect:
    push each corner outward by delta along both edge directions."""
    q = np.asarray(quad, np.float64).reshape(4, 2)
    u = q[1] - q[0]
    v = q[3] - q[0]
    nu = np.linalg.norm(u)
    nv = np.linalg.norm(v)
    u = u / nu if nu > 0 else np.array([1.0, 0.0])
    v = v / nv if nv > 0 else np.array([0.0, 1.0])
    return np.stack([
        q[0] - delta * u - delta * v,
        q[1] + delta * u - delta * v,
        q[2] + delta * u + delta * v,
        q[3] - delta * u + delta * v,
    ]).astype(np.float32)


def unclip_polygon_raster(polygon: np.ndarray,
                          delta: float) -> Optional[np.ndarray]:
    """Round-join polygon offset as a raster Minkowski sum with a disk."""
    poly = np.asarray(polygon, np.float32).reshape(-1, 2)
    r = max(int(np.ceil(delta)), 1)
    xmin, ymin = np.floor(poly.min(axis=0)).astype(int)
    origin = np.array([xmin - r - 2, ymin - r - 2], np.float32)
    local = np.round(poly - origin).astype(np.int32)
    w = int(local[:, 0].max()) + r + 3
    h = int(local[:, 1].max()) + r + 3
    canvas = np.zeros((h, w), np.uint8)
    cv2.fillPoly(canvas, [local], 1)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1, 2 * r + 1))
    canvas = cv2.dilate(canvas, kernel)
    contours, _ = cv2.findContours(canvas, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    biggest = max(contours, key=cv2.contourArea)
    return biggest.reshape(-1, 2).astype(np.float32) + origin


def _scale_clamp(points: np.ndarray, width_scale: float, height_scale: float,
                 dest_w: int, dest_h: int) -> np.ndarray:
    """Scale bitmap coords to original image coords, round + clamp (to
    the dest size, not size-1)."""
    out = np.empty_like(points, np.float32)
    out[:, 0] = np.clip(np.round(points[:, 0] * width_scale), 0, dest_w)
    out[:, 1] = np.clip(np.round(points[:, 1] * height_scale), 0, dest_h)
    return out


class DBPostProcess:
    """Bitmap → boxes: quads or polygons in two phases around the device
    scoring, or wholly on the host by ``__call__``."""

    def __init__(self, cfg: DBPostProcessConfig = DBPostProcessConfig()):
        self.cfg = cfg

    def __call__(
        self,
        pred: np.ndarray,         # (H, W) f32 probability map (model input res)
        bitmap: np.ndarray,       # (H, W) uint8 0/1 thresholded (maybe dilated)
        dest_w: int,
        dest_h: int,
        *,
        valid_h: Optional[int] = None,
        valid_w: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], List[float]]:
        """Returns (boxes, scores); each box (4,2) quad or (N,2) polygon in
        original image coordinates. ``valid_h/w`` crop bucket padding."""
        if valid_h is not None or valid_w is not None:
            pred = pred[: valid_h or pred.shape[0], : valid_w or pred.shape[1]]
            bitmap = bitmap[: pred.shape[0], : pred.shape[1]]
        if self.cfg.box_type == BoxType.QUAD:
            return self._boxes_from_bitmap(pred, bitmap, dest_w, dest_h)
        return self._polygons_from_bitmap(pred, bitmap, dest_w, dest_h)

    def _contours(self, bitmap: np.ndarray) -> List[np.ndarray]:
        contours, _ = cv2.findContours(
            bitmap.astype(np.uint8), cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
        return [c.reshape(-1, 2).astype(np.float32) for c in contours]

    def quad_candidates(self, bitmap: np.ndarray) -> List[np.ndarray]:
        """Phase 1: contours → min-size-filtered mini-boxes (scores are
        computed on the device)."""
        out: List[np.ndarray] = []
        for contour in self._contours(bitmap)[: self.cfg.max_candidates]:
            mb = get_mini_box(contour)
            if mb is None:
                continue
            mini_box, min_side = mb
            if min_side < self.cfg.min_size:
                continue
            out.append(mini_box)
        return out

    def poly_candidates(self, bitmap: np.ndarray) -> List[np.ndarray]:
        """Phase 1 of the poly path: contours → approx_poly_dp simplified
        polygons (epsilon = 0.002·perimeter); scores are computed on the
        device (``ops/det_device.poly_scores``)."""
        out: List[np.ndarray] = []
        for contour in self._contours(bitmap)[: self.cfg.max_candidates]:
            if len(contour) < 4:
                continue
            epsilon = 0.002 * cv2.arcLength(contour.reshape(-1, 1, 2), True)
            approx = cv2.approxPolyDP(contour.reshape(-1, 1, 2), epsilon,
                                      True).reshape(-1, 2).astype(np.float32)
            if len(approx) >= 4:
                out.append(approx)
        return out

    def finalize_poly(self, approx: np.ndarray, score: float,
                      width_scale: float, height_scale: float,
                      dest_w: int, dest_h: int
                      ) -> Optional[Tuple[np.ndarray, float]]:
        """Phase 2 of the poly path: threshold, raster round-join unclip,
        min-size filter, scale."""
        if score < self.cfg.box_thresh:
            return None
        delta = unclip_delta(approx, self.cfg.unclip_ratio)
        if delta <= 0:
            return None
        unclipped = unclip_polygon_raster(approx, delta)
        if unclipped is None or len(unclipped) < 3:
            return None
        mb = get_mini_box(unclipped)
        if mb is None or mb[1] < self.cfg.min_size + 2.0:
            return None
        return (_scale_clamp(unclipped, width_scale, height_scale,
                             dest_w, dest_h), score)

    def finalize_quads_batch(self, minis: List[np.ndarray],
                             width_scale: float, height_scale: float,
                             dest_w: int, dest_h: int
                             ) -> List[Optional[np.ndarray]]:
        """Batched :meth:`finalize_quad_geometry` over one page's
        candidates: the native extension when it is available, else the
        per-quad Python form."""
        if not minis:
            return []
        out = native_mod.finalize_quads(
            np.stack(minis).astype(np.float32, copy=False),
            self.cfg.unclip_ratio, self.cfg.min_size,
            width_scale, height_scale, dest_w, dest_h)
        if out is None:
            return [self.finalize_quad_geometry(
                mb, width_scale, height_scale, dest_w, dest_h)
                for mb in minis]
        return [out[i, :8].reshape(4, 2).copy() if out[i, 8] > 0 else None
                for i in range(len(minis))]

    def finalize_quad_geometry(self, mini_box: np.ndarray,
                               width_scale: float, height_scale: float,
                               dest_w: int, dest_h: int
                               ) -> Optional[np.ndarray]:
        """Phase 2, one quad: unclip, re-minbox, size filter, scale."""
        delta = unclip_delta(mini_box, self.cfg.unclip_ratio)
        if delta <= 0:
            return None
        unclipped = expand_rect(mini_box, delta)
        mb2 = get_mini_box(unclipped)
        if mb2 is None:
            return None
        box_points, sside = mb2
        if sside < self.cfg.min_size + 2.0:
            return None
        return _scale_clamp(box_points, width_scale, height_scale,
                            dest_w, dest_h)

    def _boxes_from_bitmap(self, pred, bitmap, dest_w, dest_h):
        """Quad path on the host, scoring on the fetched map."""
        h, w = bitmap.shape
        width_scale = dest_w / float(w)
        height_scale = dest_h / float(h)
        boxes: List[np.ndarray] = []
        scores: List[float] = []
        for contour in self._contours(bitmap)[: self.cfg.max_candidates]:
            mb = get_mini_box(contour)
            if mb is None:
                continue
            mini_box, min_side = mb
            if min_side < self.cfg.min_size:
                continue
            score = (box_score(pred, mini_box)
                     if self.cfg.score_mode == ScoreMode.FAST
                     else box_score(pred, contour))
            if score < self.cfg.box_thresh:
                continue
            delta = unclip_delta(mini_box, self.cfg.unclip_ratio)
            if delta <= 0:
                continue
            unclipped = expand_rect(mini_box, delta)
            mb2 = get_mini_box(unclipped)
            if mb2 is None:
                continue
            box_points, sside = mb2
            if sside < self.cfg.min_size + 2.0:
                continue
            boxes.append(_scale_clamp(box_points, width_scale, height_scale,
                                      dest_w, dest_h))
            scores.append(score)
        return boxes, scores

    def _polygons_from_bitmap(self, pred, bitmap, dest_w, dest_h):
        """Poly path on the host: approx_poly_dp epsilon = 0.002·perimeter,
        score on the simplified polygon, raster unclip."""
        h, w = bitmap.shape
        width_scale = dest_w / float(w)
        height_scale = dest_h / float(h)
        boxes: List[np.ndarray] = []
        scores: List[float] = []
        for contour in self._contours(bitmap)[: self.cfg.max_candidates]:
            if len(contour) < 4:
                continue
            epsilon = 0.002 * cv2.arcLength(contour.reshape(-1, 1, 2), True)
            approx = cv2.approxPolyDP(contour.reshape(-1, 1, 2), epsilon, True)
            approx = approx.reshape(-1, 2).astype(np.float32)
            if len(approx) < 4:
                continue
            score = box_score(pred, approx)
            if score < self.cfg.box_thresh:
                continue
            delta = unclip_delta(approx, self.cfg.unclip_ratio)
            if delta <= 0:
                continue
            unclipped = unclip_polygon_raster(approx, delta)
            if unclipped is None or len(unclipped) < 3:
                continue
            mb = get_mini_box(unclipped)
            if mb is None or mb[1] < self.cfg.min_size + 2.0:
                continue
            boxes.append(_scale_clamp(unclipped, width_scale, height_scale,
                                      dest_w, dest_h))
            scores.append(score)
        return boxes, scores

"""Host-side 2-D geometry: point ordering, min-area rects, polygons and
the rotate-back of a page's orientation correction.

Copied value for value from ``oar_ocr_tpu/processors/geometry.py``:
``order_quad_points`` (:26-38), ``min_area_rect`` (:41-53),
``polygon_area`` (:56-60), ``polygon_perimeter`` (:63-65),
``approx_poly_dp`` (:68-72), ``rotate_points_back`` (:136-160) and
``clip_points`` (:163-170).
"""

from __future__ import annotations

from typing import Tuple

import cv2
import numpy as np

Quad = np.ndarray  # (4, 2) float32, ordered TL, TR, BR, BL
Poly = np.ndarray  # (N, 2) float32


def order_quad_points(pts: np.ndarray) -> Quad:
    """Order 4 points TL, TR, BR, BL: sort by x (y as tie-break); the two
    leftmost become TL/BL by y, the two rightmost TR/BR by y."""
    pts = np.asarray(pts, dtype=np.float32).reshape(4, 2)
    idx = np.lexsort((pts[:, 1], pts[:, 0]))
    left, right = pts[idx[:2]], pts[idx[2:]]
    tl, bl = (left[0], left[1]) if left[0, 1] <= left[1, 1] else (left[1], left[0])
    tr, br = (right[0], right[1]) if right[0, 1] <= right[1, 1] else (right[1], right[0])
    return np.stack([tl, tr, br, bl]).astype(np.float32)


def min_area_rect(points: np.ndarray) -> Tuple[Quad, float]:
    """Minimum-area rotated rectangle over a point set: (4 corners
    ordered TL, TR, BR, BL, length of the shorter side)."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 2)
    rect = cv2.minAreaRect(points)
    box = cv2.boxPoints(rect)
    (w, h) = rect[1]
    return order_quad_points(box), float(min(w, h))


def polygon_area(poly: Poly) -> float:
    """Signed shoelace area, absolute value."""
    p = np.asarray(poly, dtype=np.float64)
    x, y = p[:, 0], p[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def polygon_perimeter(poly: Poly) -> float:
    p = np.asarray(poly, dtype=np.float64)
    return float(np.sum(np.linalg.norm(p - np.roll(p, -1, axis=0), axis=1)))


def approx_poly_dp(contour: np.ndarray, epsilon: float) -> Poly:
    """Douglas-Peucker simplification."""
    c = np.asarray(contour, dtype=np.float32).reshape(-1, 1, 2)
    out = cv2.approxPolyDP(c, epsilon, True)
    return out.reshape(-1, 2).astype(np.float32)


def rotate_points_back(points: np.ndarray, rotation_deg: int,
                       rotated_w: int, rotated_h: int) -> np.ndarray:
    """Map points detected on a rotated image back to original
    coordinates. ``rotation_deg`` is the rotation that *was applied* to
    produce the rotated image (CCW positive, one of 0/90/180/270);
    ``rotated_w/h`` are the rotated image's dimensions (the space
    ``points`` live in)."""
    p = np.asarray(points, dtype=np.float32).reshape(-1, 2)
    x, y = p[:, 0], p[:, 1]
    if rotation_deg % 360 == 0:
        out = p
    elif rotation_deg % 360 == 90:
        # original (W0,H0) = (rotated_h, rotated_w); a 90° CCW rotation sent
        # original (x0,y0) → (y0, W0-1-x0) ≈ (y0, W0-x0); invert.
        out = np.stack([rotated_h - y, x], axis=1)
    elif rotation_deg % 360 == 180:
        out = np.stack([rotated_w - x, rotated_h - y], axis=1)
    elif rotation_deg % 360 == 270:
        out = np.stack([y, rotated_w - x], axis=1)
    else:
        raise ValueError(f"unsupported rotation {rotation_deg}")
    return out.astype(np.float32)


def clip_points(points: np.ndarray, w: int, h: int) -> np.ndarray:
    """Clip points into [0, w-1] × [0, h-1] on a copy of the input."""
    p = np.array(points, dtype=np.float32, copy=True)
    p[..., 0] = np.clip(p[..., 0], 0, w - 1)
    p[..., 1] = np.clip(p[..., 1], 0, h - 1)
    return p

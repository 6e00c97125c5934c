"""Host-side 2-D geometry: boxes, min-area rects, IoU, rotations.

Re-expresses oar-ocr-core/src/processors/geometry.rs (1,328 LoC: BoundingBox,
MinAreaRect via rotating calipers :301-310, approx_poly_dp :453, iou :688,
ioa :734, rotate_back_to_original :848, box_points :909) on NumPy + OpenCV.
Where the reference hand-rolls rotating calipers we call ``cv2.minAreaRect``;
the *semantics* (point ordering, clamping, rotate-back math) are reproduced
exactly because they are parity-critical (SURVEY §8).

Everything here operates on small host arrays (contours, a few thousand
boxes); the device never sees this code.

The port's copy of ``oar_ocr_tpu/processors/geometry.py`` (:1-192), line
for line; only this paragraph is new.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import cv2
import numpy as np

Quad = np.ndarray  # (4, 2) float32, ordered TL, TR, BR, BL
Poly = np.ndarray  # (N, 2) float32


def order_quad_points(pts: np.ndarray) -> Quad:
    """Order 4 points TL, TR, BR, BL.

    Mirrors utils/transform.rs:99-118: sort by x (y as tie-break); the two
    leftmost become TL/BL by y, the two rightmost TR/BR by y.
    """

    pts = np.asarray(pts, dtype=np.float32).reshape(4, 2)
    idx = np.lexsort((pts[:, 1], pts[:, 0]))
    left, right = pts[idx[:2]], pts[idx[2:]]
    tl, bl = (left[0], left[1]) if left[0, 1] <= left[1, 1] else (left[1], left[0])
    tr, br = (right[0], right[1]) if right[0, 1] <= right[1, 1] else (right[1], right[0])
    return np.stack([tl, tr, br, bl]).astype(np.float32)


def min_area_rect(points: np.ndarray) -> Tuple[Quad, float]:
    """Minimum-area rotated rectangle over a point set.

    Returns (4 corner points ordered TL,TR,BR,BL, length of the shorter
    side). Replaces geometry.rs:301-310/:909 (rotating calipers + box_points)
    with cv2.minAreaRect, then applies the reference's point ordering.
    """

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
    """Douglas-Peucker simplification (geometry.rs:453)."""
    c = np.asarray(contour, dtype=np.float32).reshape(-1, 1, 2)
    out = cv2.approxPolyDP(c, epsilon, True)
    return out.reshape(-1, 2).astype(np.float32)


@dataclass(frozen=True)
class AABB:
    """Axis-aligned bounding box [x0, y0, x1, y1]."""

    x0: float
    y0: float
    x1: float
    y1: float

    @staticmethod
    def of(points: np.ndarray) -> "AABB":
        p = np.asarray(points, dtype=np.float32).reshape(-1, 2)
        return AABB(float(p[:, 0].min()), float(p[:, 1].min()),
                    float(p[:, 0].max()), float(p[:, 1].max()))

    @property
    def width(self) -> float:
        return max(0.0, self.x1 - self.x0)

    @property
    def height(self) -> float:
        return max(0.0, self.y1 - self.y0)

    @property
    def area(self) -> float:
        return self.width * self.height

    def intersection(self, other: "AABB") -> float:
        w = min(self.x1, other.x1) - max(self.x0, other.x0)
        h = min(self.y1, other.y1) - max(self.y0, other.y0)
        return max(0.0, w) * max(0.0, h)

    def iou(self, other: "AABB") -> float:
        """geometry.rs:688."""
        inter = self.intersection(other)
        union = self.area + other.area - inter
        return inter / union if union > 0 else 0.0

    def ioa(self, other: "AABB") -> float:
        """Intersection over self's area (geometry.rs:734)."""
        return self.intersection(other) / self.area if self.area > 0 else 0.0

    def as_array(self) -> np.ndarray:
        return np.array([self.x0, self.y0, self.x1, self.y1], dtype=np.float32)


def boxes_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized pairwise IoU of two (N,4)/(M,4) xyxy arrays."""
    a = np.asarray(a, dtype=np.float32).reshape(-1, 4)
    b = np.asarray(b, dtype=np.float32).reshape(-1, 4)
    ax0, ay0, ax1, ay1 = a[:, 0:1], a[:, 1:2], a[:, 2:3], a[:, 3:4]
    bx0, by0, bx1, by1 = b[None, :, 0], b[None, :, 1], b[None, :, 2], b[None, :, 3]
    iw = np.clip(np.minimum(ax1, bx1) - np.maximum(ax0, bx0), 0, None)
    ih = np.clip(np.minimum(ay1, by1) - np.maximum(ay0, by0), 0, None)
    inter = iw * ih
    area_a = np.clip(ax1 - ax0, 0, None) * np.clip(ay1 - ay0, 0, None)
    area_b = np.clip(bx1 - bx0, 0, None) * np.clip(by1 - by0, 0, None)
    union = area_a + area_b - inter
    return np.where(union > 0, inter / union, 0.0)


def rotate_points_back(points: np.ndarray, rotation_deg: int,
                       rotated_w: int, rotated_h: int) -> np.ndarray:
    """Map points detected on a rotated image back to original coordinates.

    reference: geometry.rs:848 rotate_back_to_original. ``rotation_deg`` is
    the rotation that *was applied* to produce the rotated image (CCW
    positive, one of 0/90/180/270); ``rotated_w/h`` are the rotated image's
    dimensions (the space ``points`` live in).
    """

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
    # np.asarray returns the CALLER'S array when it is already f32 —
    # copy so clipping never mutates the input (every sibling helper
    # here returns a fresh array)
    p = np.array(points, dtype=np.float32, copy=True)
    p[..., 0] = np.clip(p[..., 0], 0, w - 1)
    p[..., 1] = np.clip(p[..., 1], 0, h - 1)
    return p


def get_perspective_transform(src: Quad, dst: Quad) -> np.ndarray:
    """3×3 homography from 4 source to 4 destination points.

    reference: utils/transform.rs:187 solves the 8×8 system with nalgebra;
    cv2.getPerspectiveTransform does the identical computation.
    """

    return cv2.getPerspectiveTransform(
        np.asarray(src, dtype=np.float32), np.asarray(dst, dtype=np.float32)
    ).astype(np.float32)


def quad_crop_size(quad: Quad) -> Tuple[int, int]:
    """Output (w, h) of a perspective crop: max opposite-edge lengths
    (utils/transform.rs:50 region)."""

    q = np.asarray(quad, dtype=np.float32)
    w = int(round(max(np.linalg.norm(q[0] - q[1]), np.linalg.norm(q[2] - q[3]))))
    h = int(round(max(np.linalg.norm(q[0] - q[3]), np.linalg.norm(q[1] - q[2]))))
    return max(w, 1), max(h, 1)

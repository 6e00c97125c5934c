"""Table-cell reconciliation: detected cell boxes aligned to the
structure decode's cells.

Copied from ``oar_ocr_tpu/processors/layout_utils.py``: its box helpers
(:20-40: ``Box``, ``_as_xyxy``, ``_area``, ``_pair_intersection``), the
k-means box combination (:145-211: ``_kmeans_maxdist_init``,
``combine_rectangles_kmeans``) and ``reconcile_table_cells`` (:212-242),
line for line; the table analyzer is the port's one caller. The rest of
that module (OCR↔layout association, column sorting, overlap removal)
has no caller in the port. ``tests/test_torch_host_copies.py`` holds the
copy to the original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Box = Tuple[float, float, float, float]


def _as_xyxy(boxes) -> np.ndarray:
    a = np.asarray(boxes, np.float32)
    return a.reshape(0, 4) if a.size == 0 else a.reshape(-1, 4)


def _area(b: np.ndarray) -> np.ndarray:
    return np.maximum(b[..., 2] - b[..., 0], 0) * \
        np.maximum(b[..., 3] - b[..., 1], 0)


def _pair_intersection(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) intersection areas."""
    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    return np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)


# ---------------------- k-means box combination ----------------------

def _kmeans_maxdist_init(points: np.ndarray, k: int) -> np.ndarray:
    """Deterministic k-means++ variant (layout_utils.rs:572-641): first
    center = median-x point, then repeatedly the farthest point from the
    existing centers."""

    n = len(points)
    if n == 0 or k == 0:
        return np.zeros((0, 2), np.float32)
    if k >= n:
        return points.copy()
    order = np.argsort(points[:, 0], kind="stable")
    centers = [points[order[n // 2]]]
    for _ in range(1, k):
        d = np.min(
            ((points[:, None, :] - np.asarray(centers)[None, :, :]) ** 2
             ).sum(-1), axis=1)
        total = float(d.sum())
        if total <= 0.0:
            remaining = [p for p in points
                         if not any(np.array_equal(p, c) for c in centers)]
            if remaining:
                centers.append(remaining[0])
            else:
                break
            continue
        centers.append(points[int(np.argmax(d))])
    return np.asarray(centers, np.float32)


def combine_rectangles_kmeans(rectangles, target_n: int) -> np.ndarray:
    """Merge boxes into ≤ target_n via k-means on centers, union per
    cluster (layout_utils.rs:451-569)."""

    rects = _as_xyxy(rectangles)
    n = len(rects)
    if n == 0 or target_n == 0:
        return np.zeros((0, 4), np.float32)
    if target_n >= n:
        return rects.copy()
    pts = np.stack([(rects[:, 0] + rects[:, 2]) * 0.5,
                    (rects[:, 1] + rects[:, 3]) * 0.5], -1)
    centers = _kmeans_maxdist_init(pts, target_n)
    labels = np.zeros(n, np.int64)
    for _ in range(10):
        d = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new_labels = np.argmin(d, axis=1)
        changed = bool(np.any(new_labels != labels))
        labels = new_labels
        for c in range(target_n):
            sel = labels == c
            if sel.any():
                centers[c] = pts[sel].mean(0)
        if not changed:
            break
    combined = []
    for c in range(target_n):
        sel = labels == c
        if sel.any():
            sub = rects[sel]
            combined.append([sub[:, 0].min(), sub[:, 1].min(),
                             sub[:, 2].max(), sub[:, 3].max()])
    return (np.asarray(combined, np.float32) if combined
            else rects.copy())


# ---------------------- table-cell reconciliation ----------------------

def reconcile_table_cells(structure_cells, detected_cells) -> np.ndarray:
    """Align detected cell geometry to the structure decode's N cells
    (layout_utils.rs:259-339): k-means-compress excess detections, assign
    each detection to its best-IoA structure cell, then per structure
    cell: fill (no match → keep structure box), exact (one match), or
    compress (union of matches)."""

    s = _as_xyxy(structure_cells)
    d = _as_xyxy(detected_cells)
    n = len(s)
    if n == 0:
        return np.zeros((0, 4), np.float32)
    if len(d) == 0:
        return s.copy()
    if len(d) > n:
        d = combine_rectangles_kmeans(d, n)
    inter = _pair_intersection(d, s)
    det_area = _area(d)
    ioa = np.where(det_area[:, None] > 0, inter / det_area[:, None], 0.0)
    out = s.copy()
    best = np.argmax(ioa, axis=1)
    valid = ioa[np.arange(len(d)), best] > 0.001
    for i in range(n):
        sel = (best == i) & valid
        if sel.any():
            sub = d[sel]
            out[i] = [sub[:, 0].min(), sub[:, 1].min(),
                      sub[:, 2].max(), sub[:, 3].max()]
    return out

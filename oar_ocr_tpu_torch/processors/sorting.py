"""Reading-order sorting of quad and polygon boxes.

Copied value for value from ``oar_ocr_tpu/processors/sorting.py``:
``sort_quad_boxes_indices`` (:17-48), ``sort_poly_boxes_indices``
(:55-57), and ``SortDirection``, ``_projection_gaps`` and
``sort_by_xycut`` (:64-136), which the layout reading order
(``processors/layout_sorting.py``) uses.
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Tuple

import numpy as np


def _y_min(box: np.ndarray) -> float:
    return float(np.asarray(box)[:, 1].min())


def _x_min(box: np.ndarray) -> float:
    return float(np.asarray(box)[:, 0].min())


def sort_quad_boxes_indices(boxes: Sequence[np.ndarray]) -> List[int]:
    """Reading-order indices for quad boxes: sort by (y_min, x_min), then
    a bubble pass swapping adjacent boxes on the same line (|Δy| < 10)
    that are out of x order. The bubble pass is order-sensitive and kept
    exactly."""
    n = len(boxes)
    if n == 0:
        return []
    keys = [(_y_min(b), _x_min(b), i) for i, b in enumerate(boxes)]
    order = sorted(range(n), key=lambda i: (keys[i][0], keys[i][1]))
    for i in range(n - 1):
        j = i
        while j >= 0:
            if j + 1 >= n:
                break
            cy, ny = keys[order[j]][0], keys[order[j + 1]][0]
            cx, nx = keys[order[j]][1], keys[order[j + 1]][1]
            if abs(ny - cy) < 10.0 and nx < cx:
                order[j], order[j + 1] = order[j + 1], order[j]
                j -= 1
            else:
                break
    return order


def sort_poly_boxes_indices(boxes: Sequence[np.ndarray]) -> List[int]:
    """Poly boxes sort by y_min only, stable."""
    return sorted(range(len(boxes)), key=lambda i: _y_min(boxes[i]))


class SortDirection(enum.Enum):
    HORIZONTAL = "horizontal"
    VERTICAL = "vertical"


def _projection_gaps(intervals: np.ndarray, min_gap: int) -> List[Tuple[float, float]]:
    """Gaps in the 1-D union of [start, end) intervals."""
    order = np.argsort(intervals[:, 0])
    gaps = []
    cur_end = None
    for i in order:
        s, e = intervals[i]
        if cur_end is None:
            cur_end = e
            continue
        if s - cur_end >= min_gap:
            gaps.append((cur_end, s))
        cur_end = max(cur_end, e)
    return gaps


def sort_by_xycut(
    bboxes: Sequence[np.ndarray] | np.ndarray,
    direction: SortDirection = SortDirection.VERTICAL,
    min_gap: int = 1,
) -> List[int]:
    """Recursive XY-cut over xyxy boxes (sorting.rs:161): project onto the
    cut axis, split at gaps >= min_gap, recurse alternating direction; leaves
    are sorted top-to-bottom (vertical) / left-to-right (horizontal)."""

    boxes = np.asarray([np.asarray(b, np.float32).reshape(4) for b in bboxes])
    idx = list(range(len(boxes)))

    # Terminal (uncuttable-bucket) order is fixed by the top-level
    # variant, NOT by the direction whose projection happened to fail
    # last: recursive_yx_cut always emits x_sorted_indices
    # (sorting.rs:363-367) and recursive_xy_cut emits y-sorted
    # (sorting.rs:456-460). Sorting terminals by the retry direction
    # reversed reading order for side-by-side blocks whose right block
    # sits a few px higher.
    if direction == SortDirection.VERTICAL:       # yx → x-order leaves
        term_key = lambda i: (boxes[i][0], boxes[i][1])
    else:                                         # xy → y-order leaves
        term_key = lambda i: (boxes[i][1], boxes[i][0])

    def rec(indices: List[int], direction: SortDirection, depth: int) -> List[int]:
        if len(indices) <= 1:
            return indices
        sub = boxes[indices]
        if direction == SortDirection.VERTICAL:
            intervals = sub[:, [1, 3]]
        else:
            intervals = sub[:, [0, 2]]
        gaps = _projection_gaps(intervals, min_gap)
        nxt = (SortDirection.HORIZONTAL if direction == SortDirection.VERTICAL
               else SortDirection.VERTICAL)
        if not gaps:
            if depth > 0:
                return sorted(indices, key=term_key)
            return rec(indices, nxt, depth + 1)
        cuts = [g[0] for g in gaps]
        buckets: List[List[int]] = [[] for _ in range(len(cuts) + 1)]
        axis = 1 if direction == SortDirection.VERTICAL else 0
        for i in indices:
            start = boxes[i][axis]
            b = sum(1 for c in cuts if start >= c)
            buckets[b].append(i)
        out: List[int] = []
        for bucket in buckets:
            out.extend(rec(bucket, nxt, 0))
        return out

    return rec(idx, direction, 0)

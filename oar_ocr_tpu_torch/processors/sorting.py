"""Reading-order sorting of quad and polygon boxes.

Copied value for value from ``oar_ocr_tpu/processors/sorting.py``:
``sort_quad_boxes_indices`` (:17-48) and ``sort_poly_boxes_indices``
(:55-57).
"""

from __future__ import annotations

from typing import List, Sequence

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

"""Quad point ordering.

Copied value for value from ``oar_ocr_tpu/processors/geometry.py:26-38``
(``order_quad_points``).
"""

from __future__ import annotations

import numpy as np


def order_quad_points(pts: np.ndarray) -> np.ndarray:
    """Order 4 points TL, TR, BR, BL: sort by x (y as tie-break); the two
    leftmost become TL/BL by y, the two rightmost TR/BR by y."""
    pts = np.asarray(pts, dtype=np.float32).reshape(4, 2)
    idx = np.lexsort((pts[:, 1], pts[:, 0]))
    left, right = pts[idx[:2]], pts[idx[2:]]
    tl, bl = (left[0], left[1]) if left[0, 1] <= left[1, 1] else (left[1], left[0])
    tr, br = (right[0], right[1]) if right[0, 1] <= right[1, 1] else (right[1], right[0])
    return np.stack([tl, tr, br, bl]).astype(np.float32)

"""Word-level boxes from CTC column positions.

Copied value for value from ``oar_ocr_tpu/processors/word_boxes.py:18-64``
(``_apply_homography``, ``word_boxes``): each kept CTC timestep maps to a
column span of the recognizer tile; consecutive kept characters group
into words at whitespace, and each word's tile-space span maps back
through the crop homography into page coordinates as a quad.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _apply_homography(mat: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(3,3) native-crop→page matrix applied to (N,2) points."""
    p = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    out = p @ mat.T
    return out[:, :2] / np.clip(out[:, 2:3], 1e-8, None)


def word_boxes(
    matrix: np.ndarray,           # (3,3) native crop px → page px
    native_w: int,
    native_h: int,
    tile_w: int,                  # resized width w_i (h=48 tile)
    num_timesteps: int,           # T of the CTC output for this tile width
    cols: Sequence[int],          # kept column indices (one per char)
    text: str,                    # decoded text, len == len(cols)
) -> List[Tuple[str, np.ndarray]]:
    """Returns [(word, (4,2) page-coords quad)] for one region."""
    if not cols or not text or num_timesteps <= 0:
        return []
    stride = tile_w / float(num_timesteps)
    scale = native_w / float(max(tile_w, 1))

    # group chars into words at whitespace (chars and cols are parallel)
    words: List[Tuple[str, int, int]] = []   # (word, col_start, col_end)
    cur: List[str] = []
    cur_cols: List[int] = []
    for ch, col in zip(text, cols):
        if ch.isspace():
            if cur:
                words.append(("".join(cur), cur_cols[0], cur_cols[-1]))
                cur, cur_cols = [], []
        else:
            cur.append(ch)
            cur_cols.append(int(col))
    if cur:
        words.append(("".join(cur), cur_cols[0], cur_cols[-1]))

    out: List[Tuple[str, np.ndarray]] = []
    for word, c0, c1 in words:
        x0 = min(c0 * stride * scale, native_w - 1.0)
        x1 = min((c1 + 1) * stride * scale, float(native_w))
        rect = np.array([[x0, 0.0], [x1, 0.0],
                         [x1, float(native_h)], [x0, float(native_h)]],
                        np.float32)
        out.append((word, _apply_homography(matrix, rect).astype(np.float32)))
    return out

"""Layout postprocess helpers: box unclipping and NMS-with-merge.

Re-expresses oar-ocr-core/src/processors/layout_postprocess.rs
(:636 unclip_boxes, :743 apply_nms_with_merge) and the OCR↔layout
association helpers of layout_utils.rs — the host-side refinements applied
after the device NMS (ops/nms.py) has pruned the dense candidates.

The port's copy of ``oar_ocr_tpu/processors/layout_postprocess.py``
(:1-168), line for line; only this paragraph is new.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..domain.layout import LayoutBox


def unclip_boxes(boxes: Sequence[LayoutBox], ratio_w: float = 1.0,
                 ratio_h: float = 1.0,
                 page_w: Optional[float] = None,
                 page_h: Optional[float] = None) -> None:
    """Expand boxes around their center (layout_postprocess.rs:636);
    clamps to page bounds when given. In place."""

    for b in boxes:
        x0, y0, x1, y1 = b.xyxy
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        hw = (x1 - x0) / 2 * ratio_w
        hh = (y1 - y0) / 2 * ratio_h
        nx0, ny0, nx1, ny1 = cx - hw, cy - hh, cx + hw, cy + hh
        if page_w is not None:
            nx0, nx1 = max(nx0, 0.0), min(nx1, page_w)
        if page_h is not None:
            ny0, ny1 = max(ny0, 0.0), min(ny1, page_h)
        b.box = np.array([nx0, ny0, nx1, ny1], np.float32)


def _iou(a, b) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def apply_nms_with_merge(boxes: Sequence[LayoutBox], *,
                         iou_thresh: float = 0.5,
                         merge: bool = True,
                         max_detections: Optional[int] = None
                         ) -> List[LayoutBox]:
    """Greedy same-class NMS where suppressed boxes are MERGED into the
    keeper's extent instead of dropped (layout_postprocess.rs:743) — the
    union box keeps the max score. ``max_detections`` keeps the top-N by
    score, and the kept results are re-sorted by each merged group's
    EARLIEST original index (layout_postprocess.rs:811-830) so
    PP-DocLayoutV2 pointer reading-order inputs keep their sequence."""

    order = sorted(range(len(boxes)), key=lambda i: -boxes[i].score)
    taken = [False] * len(boxes)
    out: List[tuple] = []                        # (min original idx, box)
    for i in order:
        if taken[i]:
            continue
        taken[i] = True
        keeper = boxes[i]
        kx = list(keeper.xyxy)
        order_idx = i
        for j in order:
            if taken[j] or boxes[j].label != keeper.label:
                continue
            if _iou(kx, boxes[j].xyxy) > iou_thresh:
                taken[j] = True
                order_idx = min(order_idx, j)
                if merge:
                    ox = boxes[j].xyxy
                    kx = [min(kx[0], ox[0]), min(kx[1], ox[1]),
                          max(kx[2], ox[2]), max(kx[3], ox[3])]
        out.append((order_idx, LayoutBox(
            label=keeper.label, score=keeper.score,
            box=np.array(kx, np.float32),
            order_index=keeper.order_index)))
    # score-based selection first (out is implicitly score-ordered),
    # THEN restore input order within the kept set
    if max_detections is not None:
        out = out[:max_detections]
    out.sort(key=lambda t: t[0])
    return [b for _, b in out]


def best_containing_layout_index(
    ocr_boxes: Sequence[np.ndarray],
    layout_boxes: Sequence[LayoutBox],
    *,
    min_ioa: float = 0.5,
) -> List[Optional[int]]:
    """For each OCR box, the index of the layout box that best contains it,
    or None (layout_utils.rs OCR↔layout association).

    Renamed from ``associate_ocr_with_layout``: a same-named sibling with
    an incompatible signature lives in processors/layout_utils.py (the
    matched/unmatched-split form) — importing from the wrong module
    type-checked on the first two args and silently mis-associated."""

    out: List[Optional[int]] = []
    for box in ocr_boxes:
        b = np.asarray(box, np.float32).reshape(-1, 2)
        x0, y0 = b.min(0)
        x1, y1 = b.max(0)
        area = max((x1 - x0) * (y1 - y0), 1e-6)
        best, best_v = None, min_ioa
        for li, lb in enumerate(layout_boxes):
            lx0, ly0, lx1, ly1 = lb.xyxy
            iw = max(0.0, min(x1, lx1) - max(x0, lx0))
            ih = max(0.0, min(y1, ly1) - max(y0, ly0))
            ioa = iw * ih / area
            if ioa > best_v:
                best, best_v = li, ioa
        out.append(best)
    return out


def remove_overlapping_boxes(boxes: Sequence[LayoutBox], *,
                             ioa_thresh: float = 0.9) -> List[LayoutBox]:
    """Drop a box mostly contained in a higher-scoring box of any class
    (layout_utils.rs overlap removal)."""

    keep = [True] * len(boxes)
    for i, a in enumerate(boxes):
        ax = a.xyxy
        area_a = max((ax[2] - ax[0]) * (ax[3] - ax[1]), 1e-6)
        for j, b in enumerate(boxes):
            if i == j or not keep[j]:
                continue
            bx = b.xyxy
            iw = max(0.0, min(ax[2], bx[2]) - max(ax[0], bx[0]))
            ih = max(0.0, min(ax[3], bx[3]) - max(ax[1], bx[1]))
            if iw * ih / area_a > ioa_thresh and b.score >= a.score:
                area_b = (bx[2] - bx[0]) * (bx[3] - bx[1])
                if area_b >= area_a:
                    keep[i] = False
                    break
    return [b for b, k in zip(boxes, keep) if k]


def sort_by_order_pairs(boxes: List[LayoutBox],
                        order_pairs: Sequence[Sequence[float]],
                        mode: str) -> List[LayoutBox]:
    """PP-DocLayoutV2/V3 pointer-network reading order
    (layout_detection_adapter.rs:778-800): the deploy graph emits extra
    per-box order features — V2 rows carry a (col, row) pair (feature dim
    8) sorted lexicographically; V3 rows carry a single order scalar
    (feature dim 7). The sorted order is stamped into
    ``LayoutBox.order_index`` so downstream xycut_enhanced can trust the
    model ordering (is_reading_order_sorted)."""

    if mode not in ("v2", "v3"):
        raise ValueError(f"unknown order mode {mode!r}")
    idx = list(range(len(boxes)))
    if mode == "v2":
        idx.sort(key=lambda i: (float(order_pairs[i][0]),
                                float(order_pairs[i][1])))
    else:
        idx.sort(key=lambda i: float(order_pairs[i][0]))
    out = []
    for rank, i in enumerate(idx):
        boxes[i].order_index = float(rank)
        out.append(boxes[i])
    return out

"""Enhanced layout reading-order sorting (`xycut_enhanced`) — complete.

Re-expresses oar-ocr-core/src/processors/layout_sorting.rs:1-1034 (itself a
faithful PaddleX `xycut_enhanced` port), all six passes:

1. header/footer separation (y-sorted, headers first / footers last);
2. cross-layout detection — blocks spanning multiple columns become
   CrossLayout/CrossReference (layout_sorting.rs:315 detect_cross_layout);
3. direction-aware XY-cut over the main flow: single-column pages (one
   merged horizontal-projection interval, or all single-line blocks) cut
   X-first, multi-column pages cut Y-first (rs:279);
4. overlap-shrinking pre-pass splitting slightly-overlapping neighbors at
   the overlap midpoint (rs:534 shrink_overlapping_boxes, exact split
   arithmetic incl. the ±1 px gap and the |gap| ≤ 3 px touch rule);
5. weighted-distance insertion of doc titles, vision blocks, vision
   titles and cross-layout blocks (rs:751 weighted_distance_insert, with
   the PaddleX XYCUT_SETTINGS constants: edge·10⁴ + up·1 + left·2, 50 px
   edge-distance quantization, per-label edge weights rs:862) and
   manhattan insertion of unordered blocks (rs:729);
6. vision-title association — titles move adjacent to their nearest
   vision parent when within 3 text-line-heights (rs:669).

The port's copy of ``oar_ocr_tpu/processors/layout_sorting.py`` (:1-475), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..domain.structure import LayoutElement, LayoutElementType
from .sorting import SortDirection, sort_by_xycut

# XYCUT_SETTINGS (PaddleX setting.py; layout_sorting.rs:16-20)
EDGE_DISTANCE_COMPARE_TOLERANCE_LEN = 2.0
EDGE_WEIGHT = 10000.0
UP_EDGE_WEIGHT = 1.0
LEFT_EDGE_WEIGHT = 2.0
CROSS_LAYOUT_REF_TEXT_BLOCK_WORDS_NUM_THRESHOLD = 10.0


class OrderLabel(enum.Enum):
    HEADER = "header"
    FOOTER = "footer"
    DOC_TITLE = "doc_title"
    PARAGRAPH_TITLE = "paragraph_title"
    VISION = "vision"
    VISION_TITLE = "vision_title"
    UNORDERED = "unordered"
    NORMAL_TEXT = "normal_text"
    CROSS_LAYOUT = "cross_layout"
    CROSS_REFERENCE = "cross_reference"
    REFERENCE = "reference"

    @staticmethod
    def of(et: LayoutElementType) -> "OrderLabel":
        T = LayoutElementType
        if et in (T.HEADER, T.HEADER_IMAGE):
            return OrderLabel.HEADER
        if et in (T.FOOTER, T.FOOTER_IMAGE, T.FOOTNOTE):
            return OrderLabel.FOOTER
        if et == T.DOC_TITLE:
            return OrderLabel.DOC_TITLE
        if et in (T.PARAGRAPH_TITLE, T.CONTENT):
            return OrderLabel.PARAGRAPH_TITLE
        if et == T.REFERENCE:
            return OrderLabel.REFERENCE
        if et in (T.IMAGE, T.FIGURE, T.TABLE, T.CHART, T.ALGORITHM):
            return OrderLabel.VISION
        if et in (T.FIGURE_TITLE, T.TABLE_TITLE, T.CHART_TITLE,
                  T.FIGURE_TABLE_CHART_TITLE):
            return OrderLabel.VISION_TITLE
        if et in (T.SEAL, T.NUMBER, T.ASIDE_TEXT, T.FORMULA_NUMBER):
            return OrderLabel.UNORDERED
        return OrderLabel.NORMAL_TEXT


@dataclass
class _Block:
    bbox: np.ndarray            # (4,) x0 y0 x1 y1 — mutated by shrinking
    original_index: int
    label: OrderLabel
    direction: SortDirection
    num_lines: int
    text_line_height: float

    @staticmethod
    def make(bbox, original_index: int, label: OrderLabel,
             num_lines: Optional[int]) -> "_Block":
        b = np.asarray(bbox, np.float32).copy()
        w, h = b[2] - b[0], b[3] - b[1]
        direction = (SortDirection.HORIZONTAL if w >= h
                     else SortDirection.VERTICAL)
        nl = max(num_lines or 1, 1)
        return _Block(b, original_index, label, direction, nl, h / nl)

    @property
    def width(self) -> float:
        return float(self.bbox[2] - self.bbox[0])

    @property
    def height(self) -> float:
        return float(self.bbox[3] - self.bbox[1])

    @property
    def area(self) -> float:
        return self.width * self.height

    @property
    def center(self) -> Tuple[float, float]:
        return (float(self.bbox[0] + self.bbox[2]) / 2,
                float(self.bbox[1] + self.bbox[3]) / 2)

    @property
    def long_side(self) -> float:
        return max(self.width, self.height)


def _proj_overlap_ratio(b1, b2, direction: SortDirection) -> float:
    """1-D projection IoU (layout_sorting.rs:917)."""
    if direction == SortDirection.HORIZONTAL:
        mn1, mx1, mn2, mx2 = b1[0], b1[2], b2[0], b2[2]
    else:
        mn1, mx1, mn2, mx2 = b1[1], b1[3], b2[1], b2[3]
    inter = max(min(mx1, mx2) - max(mn1, mn2), 0.0)
    union = max(mx1, mx2) - min(mn1, mn2)
    return float(inter / union) if union > 0 else 0.0


def _overlap_ratio_of_a(a, b) -> float:
    """intersection / area(a) (sorting.rs:548 calculate_overlap_ratio)."""
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    area = (a[2] - a[0]) * (a[3] - a[1])
    return float(iw * ih / area) if area > 0 else 0.0


def _nearest_edge_distance(b1, b2, weights) -> float:
    """Weighted nearest-edge distance (layout_sorting.rs:880)."""
    if (_proj_overlap_ratio(b1, b2, SortDirection.HORIZONTAL) > 0
            and _proj_overlap_ratio(b1, b2, SortDirection.VERTICAL) > 0):
        return 0.0
    min_x = min_y = 0.0
    if _proj_overlap_ratio(b1, b2, SortDirection.HORIZONTAL) == 0.0:
        d = min(abs(b1[0] - b2[2]), abs(b1[2] - b2[0]))
        min_x = d * (weights[0] if b1[2] < b2[0] else weights[1])
    if _proj_overlap_ratio(b1, b2, SortDirection.VERTICAL) == 0.0:
        d = min(abs(b1[1] - b2[3]), abs(b1[3] - b2[1]))
        min_y = d * (weights[2] if b1[3] < b2[1] else weights[3])
    return float(min_x + min_y)


def _get_weights(label: OrderLabel,
                 direction: SortDirection) -> Tuple[float, ...]:
    """Per-label edge weights (layout_sorting.rs:862 get_weights)."""
    if label == OrderLabel.DOC_TITLE:
        return ((1.0, 0.1, 0.1, 1.0)
                if direction == SortDirection.HORIZONTAL
                else (0.2, 0.1, 1.0, 1.0))
    if label in (OrderLabel.PARAGRAPH_TITLE, OrderLabel.VISION,
                 OrderLabel.VISION_TITLE, OrderLabel.CROSS_LAYOUT):
        return (1.0, 1.0, 0.1, 1.0)
    return (1.0, 1.0, 1.0, 0.1)


def calculate_discontinuous_projection(
        bboxes, direction: SortDirection) -> List[Tuple[int, int]]:
    """Merged projection intervals; one interval = single column
    (layout_sorting.rs:495)."""
    if len(bboxes) == 0:
        return []
    if direction == SortDirection.HORIZONTAL:
        iv = sorted((int(b[0]), int(b[2])) for b in bboxes)
    else:
        iv = sorted((int(b[1]), int(b[3])) for b in bboxes)
    merged = []
    cs, ce = iv[0]
    for s, e in iv[1:]:
        if s <= ce:
            ce = max(ce, e)
        else:
            merged.append((cs, ce))
            cs, ce = s, e
    merged.append((cs, ce))
    return merged


def shrink_overlapping_boxes(blocks: List[_Block],
                             direction: SortDirection) -> None:
    """Split slightly-overlapping consecutive blocks at the overlap
    midpoint (layout_sorting.rs:534, exact semantics: trigger when
    (match_iou > 0 and 0 < cut_iou < 0.1) or the edges touch/are within
    3 px; the earlier block keeps [.., mid−1], the later [mid+1, ..])."""

    if len(blocks) < 2:
        return
    if direction == SortDirection.VERTICAL:
        blocks.sort(key=lambda b: b.bbox[3])
    else:
        blocks.sort(key=lambda b: b.bbox[2])
    perp = (SortDirection.HORIZONTAL if direction == SortDirection.VERTICAL
            else SortDirection.VERTICAL)
    for i in range(len(blocks) - 1):
        a, b = blocks[i], blocks[i + 1]
        cut_iou = _proj_overlap_ratio(a.bbox, b.bbox, direction)
        match_iou = _proj_overlap_ratio(a.bbox, b.bbox, perp)
        lo, hi = (1, 3) if direction == SortDirection.VERTICAL else (0, 2)
        e2, s1p = a.bbox[hi], b.bbox[lo]
        if ((match_iou > 0 and 0 < cut_iou < 0.1) or e2 == s1p
                or abs(e2 - s1p) <= 3.0):
            omn = max(a.bbox[lo], b.bbox[lo])
            omx = min(a.bbox[hi], b.bbox[hi])
            split = math.floor((omn + omx) / 2.0)
            if a.bbox[lo] < b.bbox[lo]:
                a.bbox[hi] = split - 1.0
                b.bbox[lo] = split + 1.0
            else:
                a.bbox[lo] = split - 1.0
                b.bbox[hi] = split + 1.0


def detect_cross_layout(blocks: List[_Block], page_width: float) -> None:
    """Mark column-spanning blocks CrossLayout / CrossReference
    (layout_sorting.rs:315 detect_cross_layout — PaddleX
    get_layout_structure)."""

    if len(blocks) < 2:
        return
    blocks.sort(key=lambda b: (b.bbox[0], b.width))
    mask = (OrderLabel.DOC_TITLE, OrderLabel.CROSS_LAYOUT,
            OrderLabel.CROSS_REFERENCE)
    n = len(blocks)
    data = [(b.bbox.copy(), b.label, b.area, b.long_side) for b in blocks]
    tlh = [b.text_line_height for b in blocks]
    h_proj = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(n):
            h_proj[i, j] = _proj_overlap_ratio(
                data[i][0], data[j][0], SortDirection.HORIZONTAL)
    neighbors = [[j for j in range(n) if j != i and h_proj[i, j] > 0]
                 for i in range(n)]

    for bi in range(n):
        if data[bi][1] in mask:
            continue
        mark = False
        for ri in neighbors[bi]:
            if data[ri][1] in mask:
                continue
            if blocks[ri].label == OrderLabel.CROSS_LAYOUT:
                continue
            if blocks[bi].label == OrderLabel.CROSS_LAYOUT:
                break
            ov = _overlap_ratio_of_a(data[bi][0], data[ri][0])
            if ov > 0:
                if data[ri][1] == OrderLabel.VISION:
                    blocks[ri].label = OrderLabel.CROSS_LAYOUT
                    continue
                if ov > 0.1 and data[bi][2] < data[ri][2]:
                    mark = True
                    break
            for si in neighbors[bi]:
                if si == ri or data[si][1] in mask:
                    continue
                if blocks[si].label == OrderLabel.CROSS_LAYOUT:
                    continue
                ov2 = _overlap_ratio_of_a(data[bi][0], data[si][0])
                if ov2 > 0.1:
                    if data[si][1] == OrderLabel.VISION:
                        blocks[si].label = OrderLabel.CROSS_LAYOUT
                        continue
                    if (data[bi][1] == OrderLabel.VISION
                            or data[bi][2] < data[si][2]):
                        mark = True
                        break
                ref_match = h_proj[ri, si]
                sec_ref_match = _proj_overlap_ratio(
                    data[ri][0], data[si][0], SortDirection.VERTICAL)
                if ref_match == 0.0 and sec_ref_match > 0.0:
                    if data[bi][1] == OrderLabel.VISION:
                        mark = True
                        break
                    thr = CROSS_LAYOUT_REF_TEXT_BLOCK_WORDS_NUM_THRESHOLD
                    if (data[ri][1] == OrderLabel.NORMAL_TEXT
                            and data[si][1] == OrderLabel.NORMAL_TEXT
                            and data[ri][3] > tlh[ri] * thr
                            and data[si][3] > tlh[si] * thr):
                        mark = True
                        break
            if mark:
                break
        if mark:
            blocks[bi].label = (OrderLabel.CROSS_REFERENCE
                                if data[bi][1] == OrderLabel.REFERENCE
                                else OrderLabel.CROSS_LAYOUT)


def _direction_aware_xycut(blocks: List[_Block]) -> List[_Block]:
    """layout_sorting.rs:279: single column or all-single-line → X-first
    cut; multi-column → Y-first cut. Shrinks overlaps first."""

    bboxes = [b.bbox.copy() for b in blocks]
    max_lines = max(b.num_lines for b in blocks)
    discontinuous = calculate_discontinuous_projection(
        bboxes, SortDirection.HORIZONTAL)
    shrink_overlapping_boxes(blocks, SortDirection.VERTICAL)
    shrunk = [b.bbox for b in blocks]
    if len(discontinuous) == 1 or max_lines == 1:
        order = sort_by_xycut(shrunk, SortDirection.HORIZONTAL, 1)
    else:
        order = sort_by_xycut(shrunk, SortDirection.VERTICAL, 1)
    return [blocks[i] for i in order]


def manhattan_insert(block: _Block, sorted_blocks: List[_Block]) -> None:
    """Insert after the min-|Δx0|+|Δy0| block (layout_sorting.rs:729)."""
    if not sorted_blocks:
        sorted_blocks.append(block)
        return
    dists = [abs(block.bbox[0] - s.bbox[0]) + abs(block.bbox[1] - s.bbox[1])
             for s in sorted_blocks]
    sorted_blocks.insert(int(np.argmin(dists)) + 1, block)


def weighted_distance_insert(block: _Block, sorted_blocks: List[_Block],
                             region_direction: SortDirection
                             = SortDirection.HORIZONTAL) -> None:
    """PaddleX weighted_distance_insert (layout_sorting.rs:751): rank
    positions by quantized-edge·10⁴ + up·1 + left·2, then place before or
    after the winner by y (then x, then center-norm) comparison."""

    if not sorted_blocks:
        sorted_blocks.append(block)
        return
    x1, y1, x2, _ = (float(block.bbox[0]), float(block.bbox[1]),
                     float(block.bbox[2]), float(block.bbox[3]))
    min_weighted = math.inf
    min_up_edge = math.inf
    nearest = 0
    for idx, sb in enumerate(sorted_blocks):
        x1p, y1p, x2p, y2p = (float(sb.bbox[0]), float(sb.bbox[1]),
                              float(sb.bbox[2]), float(sb.bbox[3]))
        weights = _get_weights(block.label, block.direction)
        raw_edge = _nearest_edge_distance(block.bbox, sb.bbox, weights)
        edge = math.floor(raw_edge / 50.0) * 50.0
        if region_direction == SortDirection.HORIZONTAL:
            up_dist, left_dist = y1p, x1p
            is_below = y2p < y1
        else:
            up_dist, left_dist = -x2p, y1p
            is_below = x1p > x2
        is_special = (block.label != OrderLabel.UNORDERED
                      or block.label in (OrderLabel.DOC_TITLE,
                                         OrderLabel.PARAGRAPH_TITLE,
                                         OrderLabel.VISION,
                                         OrderLabel.VISION_TITLE,
                                         OrderLabel.CROSS_LAYOUT))
        if is_special and is_below:
            up_dist, left_dist = -up_dist, -left_dist
        if abs(min_up_edge - up_dist) <= EDGE_DISTANCE_COMPARE_TOLERANCE_LEN:
            up_dist = min_up_edge
        weighted = (edge * EDGE_WEIGHT + up_dist * UP_EDGE_WEIGHT
                    + left_dist * LEFT_EDGE_WEIGHT)
        min_up_edge = min(min_up_edge, up_dist)
        if weighted < min_weighted:
            min_weighted = weighted
            y1_i, y1p_i = int(math.floor(y1)) // 2, int(math.floor(y1p)) // 2
            if abs(y1_i - y1p_i) > 0:
                sorted_val, block_val = y1p, y1
            elif region_direction == SortDirection.HORIZONTAL:
                x1_i, x2_i = int(math.floor(x1)) // 2, int(math.floor(x2)) // 2
                if abs(x1_i - x2_i) > 0:
                    sorted_val, block_val = x1p, x1
                else:
                    cx, cy = block.center
                    scx, scy = sb.center
                    sorted_val = scx * scx + scy * scy
                    block_val = cx * cx + cy * cy
            else:
                sorted_val, block_val = x1p, x1
            nearest = idx + 1 if block_val > sorted_val else idx
    sorted_blocks.insert(min(nearest, len(sorted_blocks)), block)


def associate_child_blocks(sorted_blocks: List[_Block]) -> None:
    """Move VisionTitle blocks adjacent to their nearest Vision parent
    when within 3 text-line-heights (layout_sorting.rs:669)."""

    if len(sorted_blocks) < 2:
        return
    moves = []
    for i, b in enumerate(sorted_blocks):
        if b.label != OrderLabel.VISION_TITLE:
            continue
        best, best_d = None, math.inf
        for j, o in enumerate(sorted_blocks):
            if o.label != OrderLabel.VISION:
                continue
            d = _nearest_edge_distance(b.bbox, o.bbox, (1.0, 1.0, 1.0, 1.0))
            if d < best_d:
                best_d, best = d, j
        if best is not None and best_d < sorted_blocks[best].text_line_height * 3:
            if b.bbox[1] < sorted_blocks[best].bbox[1]:
                moves.append((i, best))
            else:
                moves.append((i, best + 1))
    for from_idx, target in reversed(moves):
        if from_idx == target or from_idx + 1 == target:
            continue
        blk = sorted_blocks.pop(from_idx)
        adjusted = target - 1 if from_idx < target else target
        sorted_blocks.insert(min(adjusted, len(sorted_blocks)), blk)


def sort_layout_enhanced(elements: Sequence[LayoutElement],
                         page_w: float, page_h: float,
                         num_lines: Optional[Sequence[int]] = None
                         ) -> List[int]:
    """Return reading-order indices over ``elements``
    (layout_sorting.rs:160 sort_layout_enhanced)."""

    n = len(elements)
    if n == 0:
        return []
    blocks = [
        _Block.make(e.xyxy, i, OrderLabel.of(e.element_type),
                    num_lines[i] if num_lines else None)
        for i, e in enumerate(elements)
    ]
    headers = [b for b in blocks if b.label == OrderLabel.HEADER]
    footers = [b for b in blocks if b.label == OrderLabel.FOOTER]
    main = [b for b in blocks
            if b.label not in (OrderLabel.HEADER, OrderLabel.FOOTER)]
    headers.sort(key=lambda b: b.bbox[1])
    footers.sort(key=lambda b: b.bbox[1])
    sorted_main = _sort_main_blocks(main, page_w)
    return ([b.original_index for b in headers]
            + [b.original_index for b in sorted_main]
            + [b.original_index for b in footers])


def _sort_main_blocks(blocks: List[_Block],
                      page_width: float) -> List[_Block]:
    """layout_sorting.rs:210 sort_main_blocks."""
    if not blocks:
        return blocks
    detect_cross_layout(blocks, page_width)
    xy_cut, doc_titles, weighted, unordered = [], [], [], []
    for b in blocks:
        if b.label in (OrderLabel.CROSS_LAYOUT, OrderLabel.CROSS_REFERENCE,
                       OrderLabel.VISION, OrderLabel.VISION_TITLE):
            weighted.append(b)
        elif b.label == OrderLabel.DOC_TITLE:
            doc_titles.append(b)
        elif b.label == OrderLabel.UNORDERED:
            unordered.append(b)
        else:
            xy_cut.append(b)
    sorted_blocks = _direction_aware_xycut(xy_cut) if xy_cut else []
    doc_titles.sort(key=lambda b: b.bbox[1])
    for i, b in enumerate(doc_titles):
        if i == 0:
            sorted_blocks.insert(0, b)
        else:
            weighted_distance_insert(b, sorted_blocks)
    weighted.sort(key=lambda b: b.bbox[1])
    for b in weighted:
        weighted_distance_insert(b, sorted_blocks)
    unordered.sort(key=lambda b: b.bbox[1])
    for b in unordered:
        manhattan_insert(b, sorted_blocks)
    associate_child_blocks(sorted_blocks)
    return sorted_blocks

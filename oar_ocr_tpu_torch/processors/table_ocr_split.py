"""Cross-cell OCR box splitting with proportional text distribution.

Port of the reference's stitcher-side splitter
(oar-ocr-core/src/processors/table_ocr_split.rs:1-669). This is a
DIFFERENT mechanism from :func:`~oar_ocr_tpu.processors.table.
split_ocr_boxes_by_cells` (structure.rs:1630), which splits geometry
only and re-recognizes each fragment through the recognizer: this one
runs inside the result stitcher, where no model is available, so the
ORIGINAL text is divided across the segments proportionally to their
width/height with word-boundary snapping (table_ocr_split.rs:527
``split_text_by_ratio``).

Everything here is pure host logic over xyxy tuples.

The port's copy of ``oar_ocr_tpu/processors/table_ocr_split.py`` (:1-316), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

from .table import bbox_iou as _iou

Box = Tuple[float, float, float, float]


@dataclass
class SplitConfig:
    """table_ocr_split.rs:29-54 SplitConfig (defaults :46)."""

    min_overlap_ratio: float = 0.05
    min_cells_to_split: int = 2
    split_horizontal: bool = True
    split_vertical: bool = True


@dataclass
class CrossCellDetection:
    """table_ocr_split.rs:58-73."""

    ocr_index: int
    affected_cell_indices: List[int]
    x_boundaries: List[float] = field(default_factory=list)
    y_boundaries: List[float] = field(default_factory=list)
    is_horizontal_split: bool = True


def _area(b: Box) -> float:
    return max((b[2] - b[0]) * (b[3] - b[1]), 0.0)


def _intersection_area(a: Box, b: Box) -> float:
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    return iw * ih




def detect_cross_cell_ocr_boxes(
        boxes: Sequence[Optional[Box]],
        texts: Sequence[Optional[str]],
        cells: Sequence[Box],
        cfg: Optional[SplitConfig] = None) -> List[CrossCellDetection]:
    """OCR boxes overlapping ≥ min_cells_to_split cells by
    IoA > min_overlap_ratio (table_ocr_split.rs:118-180)."""

    cfg = cfg or SplitConfig()
    detections: List[CrossCellDetection] = []
    if not cells or not boxes:
        return detections
    for ocr_idx, (box, text) in enumerate(zip(boxes, texts)):
        if text is None or box is None:
            continue
        ocr_area = _area(box)
        if ocr_area <= 0.0:
            continue
        overlapping = [ci for ci, cell in enumerate(cells)
                       if _intersection_area(box, cell) / ocr_area
                       > cfg.min_overlap_ratio]
        if len(overlapping) < cfg.min_cells_to_split:
            continue
        overlapping.sort()
        xb, yb, horiz = compute_split_boundaries(box, overlapping, cells,
                                                 cfg)
        if xb or yb:
            detections.append(CrossCellDetection(
                ocr_index=ocr_idx, affected_cell_indices=overlapping,
                x_boundaries=xb, y_boundaries=yb,
                is_horizontal_split=horiz))
    return detections


def _dedup_within(edges: List[float], tol: float = 1.0) -> List[float]:
    """Sort + drop consecutive edges within ``tol`` px (rs:239-243
    dedup_by keeps the FIRST of each run)."""
    edges = sorted(edges)
    out: List[float] = []
    for e in edges:
        if not out or abs(e - out[-1]) >= tol:
            out.append(e)
    return out


def compute_split_boundaries(
        box: Box, cell_indices: Sequence[int], cells: Sequence[Box],
        cfg: SplitConfig) -> Tuple[List[float], List[float], bool]:
    """Cell edges strictly inside the OCR box, deduped within 1 px;
    direction = horizontal for wide boxes when both axes have edges
    (table_ocr_split.rs:185-263)."""

    if not cell_indices:
        return [], [], True
    x0, y0, x1, y1 = box
    x_edges: List[float] = []
    y_edges: List[float] = []
    for ci in cell_indices:
        cx0, cy0, cx1, cy1 = cells[ci]
        if cfg.split_horizontal:
            if x0 < cx0 < x1:
                x_edges.append(cx0)
            if x0 < cx1 < x1:
                x_edges.append(cx1)
        if cfg.split_vertical:
            if y0 < cy0 < y1:
                y_edges.append(cy0)
            if y0 < cy1 < y1:
                y_edges.append(cy1)
    x_edges = _dedup_within(x_edges)
    y_edges = _dedup_within(y_edges)
    if x_edges and y_edges:
        horiz = (x1 - x0) >= (y1 - y0)
    else:
        horiz = bool(x_edges)
    return (x_edges, [], True) if horiz else ([], y_edges, False)


def find_best_matching_cell(segment: Box, candidate_indices: Sequence[int],
                            cells: Sequence[Box]) -> int:
    """Highest-IoU candidate cell; first candidate when all IoU = 0
    (table_ocr_split.rs:491-512)."""
    best_idx = candidate_indices[0] if candidate_indices else 0
    best_iou = 0.0
    for ci in candidate_indices:
        if ci >= len(cells):
            continue
        iou = _iou(segment, cells[ci])
        if iou > best_iou:
            best_iou, best_idx = iou, ci
    return best_idx


def find_word_boundary(chars: Sequence[str], start: int,
                       target_end: int) -> int:
    """Nearest space/comma/period within a 5-char window BEFORE the
    target split point; split lands after it (table_ocr_split.rs:592)."""
    window = min(5, target_end - start)
    for offset in range(window):
        check = target_end - offset
        if (check > start and check < len(chars)
                and (chars[check].isspace() or chars[check] in ",.")):
            return check + 1
    return target_end


def split_text_by_ratio(text: str, ratios: Sequence[float]) -> List[str]:
    """Divide text into len(ratios) parts by character count, snapping
    to word boundaries; each part trimmed; leftover characters append
    to the last part (table_ocr_split.rs:527-589)."""

    if not ratios:
        return [text]
    if len(ratios) == 1:
        return [text]
    chars = list(text)
    total_chars = len(chars)
    if total_chars == 0:
        return ["" for _ in ratios]

    total_ratio = sum(ratios)
    if total_ratio > 0.0:
        normalized = [r / total_ratio for r in ratios]
    else:
        normalized = [1.0 / len(ratios)] * len(ratios)

    result: List[str] = []
    start_idx = 0
    for i, ratio in enumerate(normalized):
        if i == len(normalized) - 1:
            n = total_chars - start_idx
        else:
            # Rust f32::round = half away from zero
            n = int(math.floor(total_chars * ratio + 0.5))
        end_idx = min(start_idx + n, total_chars)
        if start_idx < end_idx < total_chars:
            end_idx = find_word_boundary(chars, start_idx, end_idx)
        result.append("".join(chars[start_idx:end_idx]).strip())
        start_idx = end_idx
    if start_idx < total_chars and result:
        remaining = "".join(chars[start_idx:]).strip()
        if remaining:
            result[-1] += remaining
    return result


def split_ocr_box_at_cell_boundaries(
        box: Box, text: str, detection: CrossCellDetection,
        cells: Sequence[Box]) -> List[Tuple[Box, str, int]]:
    """Split one OCR box at the detected boundaries; returns
    (segment_bbox, segment_text, cell_index) triples
    (table_ocr_split.rs:276-329)."""

    if not text or not detection.affected_cell_indices:
        return []
    if detection.is_horizontal_split and detection.x_boundaries:
        return _split_horizontally(box, text, detection.x_boundaries,
                                   detection.affected_cell_indices, cells)
    if detection.y_boundaries:
        return _split_vertically(box, text, detection.y_boundaries,
                                 detection.affected_cell_indices, cells)
    return [(box, text, detection.affected_cell_indices[0])]


def _ranges_from_boundaries(lo: float, hi: float,
                            boundaries: Sequence[float]
                            ) -> List[Tuple[float, float]]:
    ranges: List[Tuple[float, float]] = []
    prev = lo
    for b in boundaries:
        if prev < b < hi:
            ranges.append((prev, b))
            prev = b
    if prev < hi:
        ranges.append((prev, hi))
    return ranges


def _split_horizontally(box: Box, text: str, x_boundaries: Sequence[float],
                        cell_indices: Sequence[int], cells: Sequence[Box]
                        ) -> List[Tuple[Box, str, int]]:
    """table_ocr_split.rs:332-395."""
    x0, y0, x1, y1 = box
    if x1 - x0 <= 0.0:
        return []
    x_ranges = _ranges_from_boundaries(x0, x1, x_boundaries)
    if not x_ranges:
        return []
    total = sum(b - a for a, b in x_ranges)
    ratios = [(b - a) / total for a, b in x_ranges]
    parts = split_text_by_ratio(text, ratios)
    out: List[Tuple[Box, str, int]] = []
    for (a, b), part in zip(x_ranges, parts):
        seg: Box = (a, y0, b, y1)
        out.append((seg, part,
                    find_best_matching_cell(seg, cell_indices, cells)))
    return out


def _split_vertically(box: Box, text: str, y_boundaries: Sequence[float],
                      cell_indices: Sequence[int], cells: Sequence[Box]
                      ) -> List[Tuple[Box, str, int]]:
    """Vertical split prefers distributing existing text lines over the
    segments; ratio split is the fallback (table_ocr_split.rs:398-488)."""
    x0, y0, x1, y1 = box
    if y1 - y0 <= 0.0:
        return []
    y_ranges = _ranges_from_boundaries(y0, y1, y_boundaries)
    if not y_ranges:
        return []
    out: List[Tuple[Box, str, int]] = []
    lines = text.splitlines()
    if len(lines) >= len(y_ranges):
        per = len(lines) // len(y_ranges)
        idx = 0
        for i, (a, b) in enumerate(y_ranges):
            n = len(lines) - idx if i == len(y_ranges) - 1 else per
            seg: Box = (x0, a, x1, b)
            out.append((seg, "\n".join(lines[idx:idx + n]),
                        find_best_matching_cell(seg, cell_indices, cells)))
            idx += n
    else:
        total = sum(b - a for a, b in y_ranges)
        ratios = [(b - a) / total for a, b in y_ranges]
        parts = split_text_by_ratio(text, ratios)
        for (a, b), part in zip(y_ranges, parts):
            seg = (x0, a, x1, b)
            out.append((seg, part,
                        find_best_matching_cell(seg, cell_indices, cells)))
    return out


def create_expanded_ocr_for_table(
        boxes: Sequence[Optional[Box]],
        texts: Sequence[Optional[str]],
        confidences: Sequence[Optional[float]],
        cells: Sequence[Box],
        cfg: Optional[SplitConfig] = None
) -> Tuple[List[Tuple[Box, str, Optional[float]]], Set[int]]:
    """Detect + split every cross-cell box; returns the new
    (bbox, text, confidence) regions (empty-text segments dropped) and
    the set of original indices that were split
    (table_ocr_split.rs:637-669)."""

    detections = detect_cross_cell_ocr_boxes(boxes, texts, cells, cfg)
    expanded: List[Tuple[Box, str, Optional[float]]] = []
    processed: Set[int] = set()
    for det in detections:
        processed.add(det.ocr_index)
        conf = (confidences[det.ocr_index]
                if det.ocr_index < len(confidences) else None)
        for seg, part, _cell in split_ocr_box_at_cell_boundaries(
                boxes[det.ocr_index], texts[det.ocr_index] or "", det,
                cells):
            if part:
                expanded.append((seg, part, conf))
    return expanded, processed

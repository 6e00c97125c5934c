"""Table structure processing: HTML assembly, cell grid, OCR→cell matching.

Re-expresses oar-ocr-core/src/processors/table_structure_decode.rs (logits→
HTML tokens + cell bboxes, parse_cell_grid_info, wrap_table_html*) and the
OCR-to-cell assignment used by the table analyzer
(oar-ocr/src/oarocr/table_analyzer.rs) plus cross-cell OCR box splitting
(processors/table_ocr_split.rs) in host Python. Pure geometry/string work —
device never sees this.

The port's copy of ``oar_ocr_tpu/processors/table.py`` (:1-832), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class CellInfo:
    """Grid placement of one cell (parse_cell_grid_info)."""

    row: int
    col: int
    rowspan: int = 1
    colspan: int = 1


def parse_cell_grid_info(tokens: Sequence[str]) -> List[CellInfo]:
    """Walk structure tokens tracking (row, col) occupancy incl. spans
    (table_structure_decode.rs:210 parse_cell_grid_info): rows advance on
    ``</tr>``, rowspan carryover marks only FUTURE rows, and every
    ``<td``-prefixed token form is handled via the shared td parser."""

    cells: List[CellInfo] = []
    occupied: set = set()        # (row, col) occupied by earlier rowspans
    row = 0
    col = 0
    i = 0
    n = len(tokens)
    while i < n:
        tok = tokens[i]
        if tok == "<tr>":
            col = 0
            while (row, col) in occupied:
                col += 1
            i += 1
            continue
        if tok == "</tr>":
            row += 1
            i += 1
            continue
        if tok == "<td></td>":
            while (row, col) in occupied:
                col += 1
            cells.append(CellInfo(row=row, col=col))
            col += 1
            i += 1
            continue
        if tok.startswith("<td"):
            _, rowspan, colspan, next_index = _parse_td_tag(tokens, i)
            while (row, col) in occupied:
                col += 1
            cells.append(CellInfo(row=row, col=col,
                                  rowspan=rowspan, colspan=colspan))
            if rowspan > 1:
                for r in range(1, rowspan):
                    for c in range(colspan):
                        occupied.add((row + r, col + c))
            col += colspan
            i = next_index
            continue
        i += 1
    return cells


def _span_attr(text: str, attr: str) -> Optional[int]:
    """Extract ``attr="N"`` from a tag fragment
    (table_structure_decode.rs:294 parse_span_attr)."""
    m = re.search(attr + r'="(\d+)"', text)
    return int(m.group(1)) if m else None


def _parse_td_tag(tokens: Sequence[str], start_idx: int
                  ) -> Tuple[str, int, int, int]:
    """Collect a ``<td`` opener's attribute tokens, its row/col spans,
    and the index just past its closing ``</td>``
    (table_structure_decode.rs:326 parse_td_tag). Handles embedded attrs
    ("<td colspan=\"2\">"), split attr tokens ("<td" ' colspan="2"' ">"),
    and the plain "<td>" … "</td>" pair.
    Returns (attrs, rowspan, colspan, next_index)."""

    attrs = ""
    rowspan = colspan = 1
    tok = tokens[start_idx]
    if tok.startswith("<td"):
        before_gt = tok[3:].split(">", 1)[0]
        if before_gt:
            attrs += before_gt
            v = _span_attr(before_gt, "colspan")
            if v is not None:
                colspan = v
            v = _span_attr(before_gt, "rowspan")
            if v is not None:
                rowspan = v
    idx = start_idx + 1
    n = len(tokens)
    while idx < n:
        t = tokens[idx]
        if (t == ">" or t == "</td>" or t.startswith("<td")
                or t == "<tr>" or t == "</tr>"):
            break
        attrs += t
        v = _span_attr(t, "colspan")
        if v is not None:
            colspan = v
        v = _span_attr(t, "rowspan")
        if v is not None:
            rowspan = v
        idx += 1
    next_index = idx
    while next_index < n:
        t = tokens[next_index]
        if t == "</td>":
            next_index += 1
            break
        if t.startswith("<td") or t == "<tr>" or t == "</tr>":
            break
        next_index += 1
    return attrs, rowspan, colspan, max(next_index, start_idx + 1)


def wrap_table_html(tokens: Sequence[str],
                    cell_texts: Optional[Sequence[str]] = None) -> str:
    """Assemble full HTML, inserting ``cell_texts`` into successive cells
    (table_structure_decode.rs:71 render_table_html). Accepts the
    combined "<td></td>" form, split "<td" attr ">" openers, and plain
    "<td>" … "</td>" pairs; a leading token carrying "<table" suppresses
    the implicit wrapper (rs:79-85)."""

    out: List[str] = ["<html><body>"]
    has_table = bool(tokens) and "<table" in tokens[0]
    if not has_table:
        out.append("<table>")
    td_index = 0
    idx = 0
    n = len(tokens)

    def text_at(i: int) -> Optional[str]:
        if cell_texts is not None and i < len(cell_texts) and cell_texts[i]:
            return cell_texts[i]
        return None

    while idx < n:
        tok = tokens[idx]
        if tok == "<td></td>":
            out.append("<td>")
            t = text_at(td_index)
            if t:
                out.append(t)
            out.append("</td>")
            td_index += 1
            idx += 1
            continue
        if tok.startswith("<td"):
            attrs, _, _, next_index = _parse_td_tag(tokens, idx)
            out.append(f"<td{attrs}>")
            # rs:109-134: a "<b>" token right after the cell span wraps
            # the inserted content (the span scan already consumed any
            # in-cell tokens)
            is_bold = next_index < n and tokens[next_index] == "<b>"
            t = text_at(td_index)
            if t:
                if is_bold:
                    out.append("<b>")
                out.append(t)
                if is_bold:
                    out.append("</b>")
            out.append("</td>")
            td_index += 1
            idx = next_index
            continue
        out.append(tok)
        idx += 1
    if not has_table:
        out.append("</table>")
    out.append("</body></html>")
    return "".join(out)


def cluster_positions(positions: Sequence[float],
                      tolerance: float) -> List[float]:
    """Greedy 1-D clustering of sorted edge coordinates: neighbours
    within ``tolerance`` of the cluster's LAST member merge; each cluster
    reduces to its mean (table_analyzer.rs:79-105)."""
    if not len(positions):
        return []
    xs = sorted(float(p) for p in positions)
    out: List[float] = []
    cur = [xs[0]]
    for p in xs[1:]:
        if abs(p - cur[-1]) <= tolerance:
            cur.append(p)
        else:
            out.append(sum(cur) / len(cur))
            cur = [p]
    out.append(sum(cur) / len(cur))
    return out


def nearest_index(positions: Sequence[float], value: float) -> int:
    """Index of the grid line closest to ``value``
    (table_analyzer.rs:107-118)."""
    return min(range(len(positions)),
               key=lambda i: abs(positions[i] - value)) if positions else 0


def table_cells_to_html_structure(cells_xyxy: np.ndarray,
                                  tolerance: float
                                  ) -> Optional[Tuple[List[str],
                                                      List[Tuple[int,
                                                                 CellInfo]]]]:
    """Reconstruct PaddleX-style structure tokens from DETECTED cell
    boxes alone (no structure model): cluster x/y edges into grid lines,
    snap each cell to its grid span, emit row-major ``<td>`` tokens with
    rowspan/colspan. Returns (tokens, row-major [(source_idx, CellInfo)])
    or None when no usable grid exists (table_analyzer.rs:149-266)."""
    cells_xyxy = np.asarray(cells_xyxy, np.float32).reshape(-1, 4)
    if not len(cells_xyxy):
        return None
    xs = cluster_positions(
        np.concatenate([cells_xyxy[:, 0], cells_xyxy[:, 2]]), tolerance)
    ys = cluster_positions(
        np.concatenate([cells_xyxy[:, 1], cells_xyxy[:, 3]]), tolerance)
    if len(xs) < 2 or len(ys) < 2:
        return None
    num_rows, num_cols = len(ys) - 1, len(xs) - 1

    entries: List[Tuple[int, int, int, int, int]] = []
    cell_map: dict = {}          # (row, col) -> entry index, first wins
    for src, (x0, y0, x1, y1) in enumerate(cells_xyxy):
        c0, c1 = sorted((nearest_index(xs, x0), nearest_index(xs, x1)))
        r0, r1 = sorted((nearest_index(ys, y0), nearest_index(ys, y1)))
        c0 = min(c0, num_cols - 1)
        r0 = min(r0, num_rows - 1)
        rs = max(min(r1, num_rows) - r0, 1)
        cs = max(min(c1, num_cols) - c0, 1)
        idx = len(entries)
        entries.append((src, r0, c0, rs, cs))
        for r in range(r0, min(r0 + rs, num_rows)):
            for c in range(c0, min(c0 + cs, num_cols)):
                cell_map.setdefault((r, c), idx)

    tokens: List[str] = ["<table>", "<tbody>"]
    order: List[Tuple[int, CellInfo]] = []
    for r in range(num_rows):
        tokens.append("<tr>")
        c = 0
        while c < num_cols:
            idx = cell_map.get((r, c))
            if idx is None:
                c += 1
                continue
            src, r0, c0, rs, cs = entries[idx]
            if r0 == r and c0 == c:
                if rs > 1 or cs > 1:
                    # ONE combined token like the reference emits
                    # (table_analyzer.rs:228-238): split '<td'/attr/'>'
                    # tokens have no '</td>' closer, so the row matcher's
                    # is_td_end_token would skip span cells entirely
                    attrs = (f' rowspan="{rs}"' if rs > 1 else "") + \
                        (f' colspan="{cs}"' if cs > 1 else "")
                    tokens.append(f"<td{attrs}></td>")
                else:
                    tokens.append("<td></td>")
                order.append((src, CellInfo(row=r0, col=c0,
                                            rowspan=rs, colspan=cs)))
            c += max(cs, 1)
        tokens.append("</tr>")
    tokens.extend(["</tbody>", "</table>"])
    return (tokens, order) if order else None


def cell_box_to_quad(box8: np.ndarray) -> np.ndarray:
    """(8,) [x1,y1,…,x4,y4] → (4,2) quad."""
    return np.asarray(box8, np.float32).reshape(4, 2)


def cell_aabbs(cell_boxes: np.ndarray) -> np.ndarray:
    """(N, 8) corner boxes → (N, 4) xyxy AABBs."""
    if len(cell_boxes) == 0:
        return np.zeros((0, 4), np.float32)
    q = cell_boxes.reshape(-1, 4, 2)
    return np.concatenate([q.min(1), q.max(1)], axis=1).astype(np.float32)


def match_ocr_to_cells(cell_boxes: np.ndarray,
                       ocr_boxes: Sequence[np.ndarray],
                       ocr_texts: Sequence[str]) -> List[str]:
    """Assign each OCR region to the cell containing its center (max-IoA
    fallback); concatenate texts per cell in reading order
    (table_analyzer.rs cell matching)."""

    aabbs = cell_aabbs(cell_boxes)
    n_cells = len(aabbs)
    assigned: List[List[Tuple[float, float, str]]] = [[] for _ in range(n_cells)]
    for box, text in zip(ocr_boxes, ocr_texts):
        b = np.asarray(box, np.float32).reshape(-1, 2)
        cx, cy = float(b[:, 0].mean()), float(b[:, 1].mean())
        best, best_metric = -1, 0.0
        for ci in range(n_cells):
            x0, y0, x1, y1 = aabbs[ci]
            if x0 <= cx <= x1 and y0 <= cy <= y1:
                # prefer the smallest containing cell
                metric = 1.0 / max((x1 - x0) * (y1 - y0), 1e-6)
                if best == -1 or metric > best_metric:
                    best, best_metric = ci, metric
        if best == -1 and n_cells:
            # fallback: max intersection-over-ocr-area
            bx0, by0 = b.min(0)
            bx1, by1 = b.max(0)
            area = max((bx1 - bx0) * (by1 - by0), 1e-6)
            for ci in range(n_cells):
                x0, y0, x1, y1 = aabbs[ci]
                iw = max(0.0, min(bx1, x1) - max(bx0, x0))
                ih = max(0.0, min(by1, y1) - max(by0, y0))
                ioa = iw * ih / area
                if ioa > best_metric and ioa > 0.3:
                    best, best_metric = ci, ioa
        if best >= 0:
            assigned[best].append((cy, cx, text))
    out = []
    for items in assigned:
        items.sort()
        out.append(" ".join(t for _, _, t in items if t).strip())
    return out


def split_ocr_boxes_by_cells(
    ocr_xyxy: Sequence[Sequence[float]],
    cell_xyxy: np.ndarray,
    *,
    overlap_threshold: float = 0.5,
    min_cells: int = 2,
) -> List[Optional[List[Tuple[float, float, float, float]]]]:
    """Split OCR boxes spanning multiple table cells at cell x-boundaries.

    Exact port of the wired-in splitter
    (oar-ocr/src/oarocr/structure.rs:1630-1846
    ``split_ocr_bboxes_by_table_cells``, mirroring PaddleX's
    ``split_ocr_bboxes_by_table_cells``):

    - a cell "overlaps" an OCR box when intersection / CELL area >
      ``overlap_threshold`` (0.5, CELL_OVERLAP_IOU_THRESHOLD,
      structure.rs:40; note the denominator is the cell, not the box);
    - overlapping cells are sorted left-to-right by cell x1
      (structure.rs:1693-1698);
    - a box overlapping < ``min_cells`` cells is kept as-is
      (k_min_cells = 2, structure.rs:1758);
    - the split emits: a leading segment before the first cell, one
      segment clamped to each cell's x-range, a segment for each gap
      between consecutive cells, and a trailing segment after the last
      cell — all spanning the full OCR y-range — deduplicated exactly
      (structure.rs:1700-1757).

    Returns one entry per input box: ``None`` to keep the original, or
    the list of (x1, y1, x2, y2) sub-boxes to re-recognize.
    """

    cells = [tuple(map(float, c)) for c in np.asarray(cell_xyxy).reshape(-1, 4)
             if c[2] > c[0] and c[3] > c[1]]
    out: List[Optional[List[Tuple[float, float, float, float]]]] = []
    for box in ocr_xyxy:
        bx0, by0, bx1, by1 = [float(v) for v in box]
        hits = []
        for ci, (x0, y0, x1, y1) in enumerate(cells):
            ix0, iy0 = max(bx0, x0), max(by0, y0)
            ix1, iy1 = min(bx1, x1), min(by1, y1)
            if ix1 <= ix0 or iy1 <= iy0:
                continue
            cell_area = (x1 - x0) * (y1 - y0)
            if cell_area <= 0:
                continue
            if (ix1 - ix0) * (iy1 - iy0) / cell_area > overlap_threshold:
                hits.append(ci)
        hits.sort(key=lambda ci: cells[ci][0])
        if len(hits) < min_cells:
            out.append(None)
            continue
        cs = [cells[ci] for ci in hits]
        segs: List[Tuple[float, float, float, float]] = []
        if bx0 < cs[0][0]:
            segs.append((bx0, by0, cs[0][0], by1))
        for k, c in enumerate(cs):
            segs.append((max(bx0, c[0]), by0, min(bx1, c[2]), by1))
            if k + 1 < len(cs) and c[2] < cs[k + 1][0]:
                segs.append((c[2], by0, cs[k + 1][0], by1))
        if cs[-1][2] < bx1:
            segs.append((cs[-1][2], by0, bx1, by1))
        seen = set()
        uniq = []
        for s in segs:
            if s not in seen:
                seen.add(s)
                uniq.append(s)
        out.append(uniq)
    return out


# ====================================================================
# PaddleX-compatible OCR↔cell matching (oar-ocr/src/oarocr/
# stitching.rs:403-1500 stitch_tables machinery). Pure host logic.
# ====================================================================

@dataclass
class TableCell:
    """One structure cell being stitched (domain TableCell analog)."""

    bbox: Tuple[float, float, float, float]
    score: float = 1.0
    text: Optional[str] = None
    row: Optional[int] = None
    col: Optional[int] = None


def is_td_end_token(token: str) -> bool:
    """stitching.rs:1283."""
    return (token == "<td></td>" or token == "</td>"
            or ("<td" in token and "</td>" in token))


def find_row_start_index(structure_tokens: Sequence[str]) -> List[int]:
    """First td index of each row (stitching.rs:1241)."""
    out: List[int] = []
    current = 0
    inside_row = False
    for tok in structure_tokens:
        if tok == "<tr>":
            inside_row = True
        elif tok == "</tr>":
            inside_row = False
        elif is_td_end_token(tok) and inside_row:
            out.append(current)
            inside_row = False
        if is_td_end_token(tok):
            current += 1
    return out


def map_and_get_max(cell_flags: Sequence[int],
                    row_starts: Sequence[int]) -> List[int]:
    """Align detected row boundary flags to structure row starts
    (stitching.rs:1265)."""
    out: List[int] = []
    i = 0
    max_v: Optional[int] = None
    for rs in row_starts:
        while i < len(cell_flags) and cell_flags[i] <= rs:
            max_v = cell_flags[i] if max_v is None else max(max_v,
                                                            cell_flags[i])
            i += 1
        out.append(max_v if max_v is not None else rs)
    return out


def sort_table_cells_boxes(cells: Sequence[TableCell],
                           row_y_tolerance: float
                           ) -> Tuple[List[int], List[int]]:
    """Row-major sort: (sorted_indices, cumulative row-start flags)
    (stitching.rs:1170)."""
    if not cells:
        return [], []
    by_y = sorted(range(len(cells)), key=lambda i: cells[i].bbox[1])
    rows: List[List[int]] = []
    cur: List[int] = []
    cur_y: Optional[float] = None
    for idx in by_y:
        y = cells[idx].bbox[1]
        if cur_y is None:
            cur, cur_y = [idx], y
        elif abs(y - cur_y) <= row_y_tolerance:
            cur.append(idx)
        else:
            cur.sort(key=lambda i: cells[i].bbox[0])
            rows.append(cur)
            cur, cur_y = [idx], y
    if cur:
        cur.sort(key=lambda i: cells[i].bbox[0])
        rows.append(cur)
    sorted_idx: List[int] = []
    flags = [0]
    for row in rows:
        sorted_idx.extend(row)
        flags.append(flags[-1] + len(row))
    return sorted_idx, flags


def bbox_iou(a, b) -> float:
    """xyxy IoU (stitching.rs:1433 calculate_iou) — the shared helper
    for every table/stitch/refine matcher."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


_iou = bbox_iou


def _ioa_of(a, b) -> float:
    """intersection / area(a) (PaddleX compute_inter with rec2=a)."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    area = (a[2] - a[0]) * (a[3] - a[1])
    return iw * ih / area if area > 0 else 0.0


def _l1_distance(a, b) -> float:
    return sum(abs(b[i] - a[i]) for i in range(4))


def _paddlex_distance(table_box, ocr_box) -> float:
    """stitching.rs:1476 (PaddleX table matcher distance)."""
    x1, y1, x2, y2 = table_box
    x3, y3, x4, y4 = ocr_box
    dis = abs(x3 - x1) + abs(y3 - y1) + abs(x4 - x2) + abs(y4 - y2)
    dis2 = abs(x3 - x1) + abs(y3 - y1)
    dis3 = abs(x4 - x2) + abs(y4 - y2)
    return dis + min(dis2, dis3)


def _is_better_cost(candidate, current, cand_idx, cur_idx) -> bool:
    """PaddleX (1-IoU, distance) ordering with near-tie stability
    (stitching.rs:727 is_better_paddlex_match_cost)."""
    eps = 1e-4
    if not (np.isfinite(candidate[0]) and np.isfinite(candidate[1])):
        return False
    if cur_idx is None or not (np.isfinite(current[0])
                               and np.isfinite(current[1])):
        return True
    if candidate[0] + eps < current[0]:
        return True
    if abs(candidate[0] - current[0]) <= eps:
        if candidate[1] + eps < current[1]:
            return True
        if abs(candidate[1] - current[1]) <= eps:
            return cand_idx < cur_idx
    return False


def _maybe_prefer_upper_boundary_cell(cells, ocr_box, best_idx, best_cost,
                                      candidate_costs) -> int:
    """Near-boundary straddle correction (stitching.rs:769)."""
    IOU_DELTA, OVERLAP_MIN = 0.12, 0.35
    best = cells[best_idx]
    if best.row is None or best.col is None or best.row == 0:
        return best_idx
    upper_idx = next((i for i, c in enumerate(cells)
                      if c.row == best.row - 1 and c.col == best.col), None)
    if upper_idx is None:
        return best_idx
    boundary_y = best.bbox[1]
    if not (ocr_box[1] < boundary_y < ocr_box[3]):
        return best_idx
    if (_ioa_of(ocr_box, best.bbox) < OVERLAP_MIN
            or _ioa_of(ocr_box, cells[upper_idx].bbox) < OVERLAP_MIN):
        return best_idx
    upper_cost = next((c for i, c in candidate_costs if i == upper_idx),
                      None)
    if upper_cost is None or not (np.isfinite(upper_cost[0])
                                  and np.isfinite(upper_cost[1])):
        return best_idx
    return upper_idx if upper_cost[0] <= best_cost[0] + IOU_DELTA \
        else best_idx


def match_table_and_ocr_by_iou_distance(
        cells: Sequence[TableCell],
        ocr_boxes: Sequence[Tuple[float, float, float, float]],
        require_positive_iou: bool,
        use_paddlex_distance: bool
) -> Tuple[dict, set]:
    """Fallback OCR→cell matcher (stitching.rs:640): center-in-cell with
    IoA > 0.7 first, then (1−IoU, distance) cost with tie stability and
    the upper-boundary-row correction in the PaddleX-distance mode.
    Returns ({cell_idx: [ocr_idx,…]}, {matched ocr_idx})."""

    cell_to_ocr: dict = {}
    matched: set = set()
    if not cells or not ocr_boxes:
        return cell_to_ocr, matched
    for oi, ob in enumerate(ocr_boxes):
        cx, cy = (ob[0] + ob[2]) / 2, (ob[1] + ob[3]) / 2
        center_cell = next(
            (ci for ci, cell in enumerate(cells)
             if cell.bbox[0] <= cx <= cell.bbox[2]
             and cell.bbox[1] <= cy <= cell.bbox[3]
             and _ioa_of(ob, cell.bbox) > 0.7), None)
        if center_cell is not None:
            cell_to_ocr.setdefault(center_cell, []).append(oi)
            matched.add(oi)
            continue
        best_idx = None
        min_cost = (np.inf, np.inf)
        costs = []
        for ci, cell in enumerate(cells):
            iou = _iou(ob, cell.bbox)
            if require_positive_iou and iou <= 0.0:
                continue
            dist = (_paddlex_distance(cell.bbox, ob)
                    if use_paddlex_distance else _l1_distance(ob, cell.bbox))
            cost = (1.0 - iou, dist)
            costs.append((ci, cost))
            if _is_better_cost(cost, min_cost, ci, best_idx):
                min_cost, best_idx = cost, ci
        if best_idx is not None:
            if use_paddlex_distance:
                best_idx = _maybe_prefer_upper_boundary_cell(
                    cells, ob, best_idx, min_cost, costs)
            cell_to_ocr.setdefault(best_idx, []).append(oi)
            matched.add(oi)
    return cell_to_ocr, matched


def join_ocr_texts_paddlex_style(indices: Sequence[int],
                                 texts: Sequence[Optional[str]]) -> str:
    """PaddleX-style concatenation for one E2E-matched cell
    (stitching.rs:906 join_ocr_texts_paddlex_style). Differs from
    :func:`compose_matched_cell_text` (rs:1290): ``<b>`` is stripped only
    as a PREFIX and ``</b>`` only as a SUFFIX, empty fragments are
    skipped BEFORE stripping, and the result is not right-trimmed."""

    joined = ""
    n = len(indices)
    for i, oi in enumerate(indices):
        text = texts[oi] if 0 <= oi < len(texts) else None
        if text is None:
            continue
        content = text
        if n > 1:
            if not content:
                continue
            if content.startswith(" "):
                content = content[1:]
            if content.startswith("<b>"):
                content = content[3:]
            if content.endswith("</b>"):
                content = content[:-4]
            if not content:
                continue
            if i != n - 1 and not content.endswith(" "):
                content += "<br/>"
        joined += content
    return joined


def compose_matched_cell_text(indices: Sequence[int],
                              texts: Sequence[Optional[str]]
                              ) -> Optional[str]:
    """Merge OCR fragments for one cell (stitching.rs:1290, PaddleX
    merge: strip leading space and <b></b>, join with <br/>)."""
    if not indices:
        return None
    merged = ""
    n = len(indices)
    for i, oi in enumerate(indices):
        text = texts[oi] if oi < len(texts) else None
        if text is None:
            continue
        content = text
        if n > 1:
            if content.startswith(" "):
                content = content[1:]
            content = content.replace("<b>", "").replace("</b>", "")
            if not content:
                continue
            if i != n - 1 and not content.endswith(" "):
                content += "<br/>"
        merged += content
    merged = merged.rstrip()
    return merged or None


def match_table_cells_with_structure_rows(
        cells: List[TableCell],
        structure_tokens: Sequence[str],
        ocr_boxes: Sequence[Tuple[float, float, float, float]],
        ocr_texts: Sequence[Optional[str]],
        row_y_tolerance: float = 10.0,
        has_detected_cells: bool = False
) -> Optional[Tuple[List[Optional[int]], set]]:
    """PaddleX-style row-aware OCR→cell matching (stitching.rs:952).

    Writes matched text into ``cells`` and returns (td→cell mapping in
    structure order, matched ocr indices), or None when inputs are
    unusable. ``has_detected_cells`` enables cross-row deduplication (a
    detected cell spanning several structure rows must not duplicate its
    content into each row)."""

    if not cells or not structure_tokens or not ocr_boxes:
        return None
    sorted_idx, row_flags = sort_table_cells_boxes(cells, row_y_tolerance)
    if not sorted_idx or not row_flags:
        return None
    row_starts = find_row_start_index(structure_tokens)
    if not row_starts:
        return None
    aligned = map_and_get_max(row_flags, row_starts)
    aligned.append(len(sorted_idx))
    row_starts = list(row_starts)
    row_starts.append(sum(1 for t in structure_tokens
                          if is_td_end_token(t)))

    globally_matched: set = set()
    all_matched: List[dict] = []
    for k in range(len(aligned) - 1):
        rs = min(aligned[k], len(sorted_idx))
        re_ = min(aligned[k + 1], len(sorted_idx))
        matched_row: dict = {}
        for local_i, cell_idx in enumerate(sorted_idx[rs:re_]):
            cell_box = cells[min(cell_idx, len(cells) - 1)].bbox
            for oi, ob in enumerate(ocr_boxes):
                if has_detected_cells and oi in globally_matched:
                    continue
                if _ioa_of(ob, cell_box) > 0.7:
                    matched_row.setdefault(local_i, []).append(oi)
        if has_detected_cells:
            for v in matched_row.values():
                globally_matched.update(v)
        all_matched.append(matched_row)

    td_to_cell: List[Optional[int]] = []
    matched_ocr: set = set()
    td_index = td_count = matched_row_idx = 0
    for tok in structure_tokens:
        if tok == "<tr>":
            td_index = 0
            continue
        if not is_td_end_token(tok):
            continue
        row_matches = (all_matched[matched_row_idx]
                       if matched_row_idx < len(all_matched) else {})
        indices = row_matches.get(td_index)
        text = compose_matched_cell_text(indices, ocr_texts) \
            if indices else None
        if indices:
            matched_ocr.update(indices)
        mapped = None
        if matched_row_idx < len(aligned):
            pos = aligned[matched_row_idx] + td_index
            if pos < len(sorted_idx) and sorted_idx[pos] < len(cells):
                mapped = sorted_idx[pos]
        td_to_cell.append(mapped)
        if mapped is not None and text:
            cell = cells[mapped]
            if not (cell.text or "").strip():
                cell.text = text
        td_index += 1
        td_count += 1
        if (matched_row_idx + 1 < len(row_starts)
                and td_count >= row_starts[matched_row_idx + 1]):
            matched_row_idx += 1
    return (td_to_cell, matched_ocr) if td_to_cell else None


def collect_cell_texts_for_tokens(cells: Sequence[TableCell],
                                  tokens: Sequence[str]
                                  ) -> List[Optional[str]]:
    """Cell texts in structure-token order via (row, col) grid matching,
    index fallback (stitching.rs:1124)."""
    if not cells:
        return []
    grid = parse_cell_grid_info(tokens)
    lookup = {(c.row, c.col): i for i, c in enumerate(cells)
              if c.row is not None and c.col is not None}
    if lookup:
        return [cells[lookup[(g.row, g.col)]].text
                if (g.row, g.col) in lookup else None for g in grid]
    return [cells[i].text if i < len(cells) else None
            for i in range(len(grid))]


def normalize_tiny_symbol(text: Optional[str], confidence: Optional[float],
                          box) -> Optional[str]:
    """Low-confidence tiny-punctuation normalization
    (stitching.rs:831 normalize_tiny_symbol_for_paddlex). Returns the
    replacement text or the original."""
    if text is None or len(text) != 1 or confidence is None:
        return text
    w = max(box[2] - box[0], 0.0)
    h = max(box[3] - box[1], 0.0)
    if text == "=" and confidence < 0.45 and w <= 9.5 and h <= 7.5:
        return ","
    if text == "=" and confidence < 0.45 and w <= 12.5 and 7.5 < h <= 10.5:
        return "-"
    if text == "0" and confidence < 0.20 and w <= 14.5 and h <= 14.5:
        return ";"
    return text


_CHECK_POS = set("✓üÜL√☑")
_CHECK_NEG = set("✗Xx✕✖☒")


def normalize_checkbox_symbols(cells: Sequence[TableCell]) -> None:
    """✓/✗ normalization for checkbox-like tables (stitching.rs:860):
    unambiguous symbols always normalize; ambiguous L/X only when the
    table shows both positive and negative candidates."""
    has_pos = has_neg = False
    for cell in cells:
        t = (cell.text or "").strip()
        if len(t) != 1:
            continue
        if t in _CHECK_POS:
            has_pos = True
        if t in _CHECK_NEG:
            has_neg = True
    both = has_pos and has_neg
    for cell in cells:
        t = (cell.text or "").strip()
        if len(t) != 1:
            continue
        if t in "üÜ√☑":
            cell.text = "✓"
        elif t == "L" and both:
            cell.text = "✓"
        elif t in "✕✖☒":
            cell.text = "✗"
        elif t in "Xx" and both:
            cell.text = "✗"

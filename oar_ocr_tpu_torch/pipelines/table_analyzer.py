"""Table analysis: classification → cell detection / structure → HTML.

Counterpart of ``oar_ocr_tpu/pipelines/table_analyzer.py`` (:1-353),
line for line but for the device calls: per table region, crop,
classify wired/wireless (``table_classifier``), optionally classify the
orientation, run the structure model routed by kind (SLANet,
SLANet_plus or SLANeXt, each decoding through its CUDA graph on the
card), run the RT-DETR-L cell detector on the wired tables
(``LayoutDetector._step`` on crop matrices, :func:`TableAnalyzer.
_detect_cells`), then the reconcile/match ladder and the HTML; a
failure raises ``OCRError`` with the table's index. The JAX
``_detect_cells`` uploads its matrices with ``jax.numpy`` (:297, :321);
here ``LayoutDetector._step`` takes them as numpy and uploads them
itself. ``runtime.pad_batch`` (:320-323) pads for a mesh, whose
``data`` axis shards the JAX cells; the port's analyzer runs on the
Runtime's primary device, mesh or not (a later slice, ROADMAP queue
1).

Stage timers: ``table.classify``, ``table.orientation``, ``table.cells``
(host wall, the fetch included), and the structure model's
``slanet.device`` / ``slanet_exact.device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..domain.structure import TableResult
from ..errors import OCRError
from ..models.classification.pp_lcnet import ImageClassifier, table_classifier
from ..models.detection.layout import LayoutDetector
from ..models.recognition.slanet import (SLANetModel, derot_dims,
                                         rotate_boxes_back, rotation_matrix)
from ..processors.layout_utils import reconcile_table_cells
from ..processors.table import (TableCell, cell_aabbs,
                                collect_cell_texts_for_tokens,
                                compose_matched_cell_text,
                                join_ocr_texts_paddlex_style,
                                match_table_and_ocr_by_iou_distance,
                                match_table_cells_with_structure_rows,
                                normalize_checkbox_symbols,
                                normalize_tiny_symbol, parse_cell_grid_info,
                                table_cells_to_html_structure,
                                wrap_table_html)
from ..runtime.runtime import Runtime
from ..utils.tracing import stage_timer


@dataclass
class TableRegionInput:
    """One table to analyze: page index + xyxy box + that page's OCR."""

    page_index: int
    box: Tuple[float, float, float, float]
    ocr_boxes: Sequence[np.ndarray] = ()
    ocr_texts: Sequence[str] = ()


class TableAnalyzer:
    def __init__(self, *,
                 classifier: Optional[ImageClassifier] = None,
                 structure: Optional[SLANetModel] = None,
                 structure_model_type: str = "slanet",
                 cell_detector: Optional[LayoutDetector] = None,
                 use_cell_detection: bool = True,
                 orientation: Optional[ImageClassifier] = None,
                 wired_structure: Optional[SLANetModel] = None,
                 wireless_structure: Optional[SLANetModel] = None,
                 wireless_cell_detector: Optional[LayoutDetector] = None,
                 use_cells_to_html: bool = False,
                 runtime: Optional[Runtime] = None):
        self.runtime = runtime or Runtime()
        self.classifier = classifier or table_classifier(runtime=self.runtime)
        # optional table-orientation stage (structure.rs
        # with_table_orientation): a 4-class doc-orientation classifier
        # applied to the table crop; the structure decode then de-rotates
        # via its sampling matrix and maps cells back
        self.orientation = orientation
        if structure is None:
            if structure_model_type == "slanet-exact":
                # checkpoint-convertible topology (slanet_exact.py)
                from ..models.recognition.slanet_exact import SLANetExactModel
                structure = SLANetExactModel(runtime=self.runtime)
            elif structure_model_type in ("slanext-wired", "slanext-wireless",
                                          "slanext-exact"):
                # SLANeXt Vary-ViT-B topology (slanext_exact.py); wired
                # 512 / wireless 488 canvases (model_input.rs:322-360)
                from ..models.recognition.slanext_exact import \
                    SLANeXtExactModel
                size = 488 if structure_model_type == "slanext-wireless" \
                    else 512
                structure = SLANeXtExactModel(input_size=size,
                                              runtime=self.runtime)
            else:
                structure = SLANetModel(runtime=self.runtime)
        self.structure = structure
        # per-kind structure overrides (with_wired_table_structure /
        # with_wireless_table_structure — SLANeXt_wired/_wireless slots);
        # default: the shared model serves both kinds
        self.wired_structure = wired_structure or structure
        self.wireless_structure = wireless_structure or structure
        self.cell_detector = cell_detector if cell_detector is not None else (
            LayoutDetector("rt-detr-l_wired_table_cell_det",
                           score_thresh=0.3, runtime=self.runtime)
            if use_cell_detection else None)
        # wireless tables may get their own cell detector
        # (with_wireless_table_cell_detection); None = wired-only cells
        self.wireless_cell_detector = wireless_cell_detector
        # force DETECTED-cell grid reconstruction over the structure
        # decode's tokens (use_cells_trans_to_html,
        # table_analyzer.rs:684-710); the no-tokens fallback (:642-674)
        # is always on
        self.use_cells_to_html = use_cells_to_html

    def analyze_tables(self, pages_u8, tables: Sequence[TableRegionInput]
                       ) -> List[TableResult]:
        """Analyze all table regions (batched per stage across tables —
        the cross-page batching idea of structure.rs:3296)."""

        if not tables:
            return []
        results: List[Optional[TableResult]] = [None] * len(tables)

        # stage 1: wired/wireless classification on the table quads
        quads = []
        for t in tables:
            x0, y0, x1, y1 = t.box
            quads.append((t.page_index, np.array(
                [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)))
        with stage_timer("table.classify", batch=len(tables)):
            cls = self.classifier.classify_quads(pages_u8, quads)

        # stage 1.5: optional table orientation (0/90/180/270)
        angles = None
        if self.orientation is not None:
            with stage_timer("table.orientation", batch=len(tables)):
                ori = self.orientation.classify_quads(pages_u8, quads)
            # label k·90 uprights by rotating +k·90° CCW — same
            # convention as pipelines/preprocess.py (PaddleX np.rot90;
            # preprocess.rs:111-149)
            angles = [(int(c) * 90) % 360 for c, _s in ori]

        # stage 2: SLANet structure for every table, routed per table
        # kind when distinct wired/wireless models are configured
        regions = [(t.page_index,
                    (int(t.box[0]), int(t.box[1]),
                     int(t.box[2]), int(t.box[3]))) for t in tables]
        if self.wired_structure is self.wireless_structure:
            structures = self.wired_structure.recognize(
                pages_u8, regions, angles=angles)
        else:
            structures: List = [None] * len(tables)
            for model, kind in ((self.wired_structure, 0),
                                (self.wireless_structure, 1)):
                sel = [i for i, (c, _s) in enumerate(cls) if c == kind]
                if not sel:
                    continue
                got = model.recognize(
                    pages_u8, [regions[i] for i in sel],
                    angles=[angles[i] for i in sel] if angles else None)
                for i, st in zip(sel, got):
                    structures[i] = st

        # stage 3: wired tables also get cell detection (sharper cells)
        wired_idx = [i for i, (c, _s) in enumerate(cls) if c == 0]
        wireless_idx = [i for i, (c, _s) in enumerate(cls) if c == 1]
        cell_boxes_by_table: dict = {}
        if self.wireless_cell_detector is not None and wireless_idx:
            dets = self._detect_cells(pages_u8, tables, wireless_idx,
                                      detector=self.wireless_cell_detector,
                                      angles=angles)
            for i, boxes in zip(wireless_idx, dets):
                if len(boxes):
                    cell_boxes_by_table[i] = boxes
        if self.cell_detector is not None and wired_idx:
            dets = self._detect_cells(pages_u8, tables, wired_idx,
                                      angles=angles)
            for i, boxes in zip(wired_idx, dets):
                if len(boxes):
                    cell_boxes_by_table[i] = boxes

        # assemble per table — the reference's matching ladder
        # (stitching.rs:403 stitch_tables): reconcile detected cells with
        # the structure decode, normalize tiny OCR symbols, row-aware
        # matching when structure tokens exist, IoU+distance fallback,
        # checkbox normalization, then HTML in structure-token order.
        for i, t in enumerate(tables):
            try:
                st = structures[i]
                x0, y0 = t.box[0], t.box[1]
                off = np.array([x0, y0, x0, y0], np.float32)
                ab = cell_aabbs(st.cell_boxes)
                struct_xyxy = ab + off if len(ab) \
                    else np.zeros((0, 4), np.float32)
                has_detected = i in cell_boxes_by_table
                tokens = list(st.tokens)

                # DETECTED-cell grid reconstruction: forced by
                # use_cells_to_html, or the fallback when the structure
                # decode yielded no tokens (table_analyzer.rs:642-710) —
                # cluster cell edges in CROP coords, tolerance 5 px
                gen_grid = None
                if has_detected and (self.use_cells_to_html or not tokens):
                    det = np.asarray(cell_boxes_by_table[i],
                                     np.float32).reshape(-1, 4)
                    gen = table_cells_to_html_structure(det - off, 5.0)
                    if gen is not None:
                        tokens, order = gen
                        cells_xyxy = det[[s for s, _g in order]]
                        gen_grid = [g for _s, g in order]
                if gen_grid is None:
                    if has_detected:
                        # align detected geometry to the structure's N
                        # cells (layout_utils.rs:259 reconcile_table_cells)
                        cells_xyxy = reconcile_table_cells(
                            struct_xyxy, cell_boxes_by_table[i])
                    else:
                        cells_xyxy = struct_xyxy
                    grid = parse_cell_grid_info(tokens)
                else:
                    grid = gen_grid
                cells = [TableCell(tuple(map(float, b)),
                                   row=(grid[k].row if k < len(grid)
                                        else None),
                                   col=(grid[k].col if k < len(grid)
                                        else None))
                         for k, b in enumerate(cells_xyxy)]

                # Inline OCR matching is a STANDALONE convenience: the
                # pipeline path passes no OCR and the ResultStitcher's
                # stitch_tables does the matching after the cross-cell
                # split (table_analyzer.rs:12 — "this stage does not
                # match OCR text to cells"). cell_texts is per td CELL
                # (wrap_table_html insertion order), not per token.
                cell_texts: List[Optional[str]] = \
                    [None] * len(parse_cell_grid_info(tokens))
                if len(t.ocr_boxes):
                    ocr_boxes, ocr_texts = [], []
                    for box, text in zip(t.ocr_boxes, t.ocr_texts):
                        b = np.asarray(box, np.float32).reshape(-1, 2)
                        bb = (float(b[:, 0].min()), float(b[:, 1].min()),
                              float(b[:, 0].max()), float(b[:, 1].max()))
                        ocr_boxes.append(bb)
                        ocr_texts.append(normalize_tiny_symbol(text, 0.9,
                                                               bb))
                    # row-aware matching only for detection-backed cells
                    # (stitching.rs:511 gates on !e2e_like_cells)
                    td_mapping = None
                    if tokens and ocr_boxes and has_detected and cells:
                        got = match_table_cells_with_structure_rows(
                            cells, tokens, ocr_boxes, ocr_texts,
                            has_detected_cells=has_detected)
                        if got is not None:
                            td_mapping = got[0]
                    if td_mapping is None and cells and ocr_boxes:
                        cell_to_ocr, _m = \
                            match_table_and_ocr_by_iou_distance(
                                cells, ocr_boxes,
                                require_positive_iou=has_detected,
                                use_paddlex_distance=not has_detected)
                        for ci, indices in cell_to_ocr.items():
                            if not (cells[ci].text or "").strip():
                                cells[ci].text = (
                                    join_ocr_texts_paddlex_style(
                                        indices, ocr_texts) or None
                                    if not has_detected else
                                    compose_matched_cell_text(
                                        indices, ocr_texts))
                    normalize_checkbox_symbols(cells)

                    if td_mapping is not None:
                        cell_texts = [cells[ci].text if ci is not None
                                      else None for ci in td_mapping]
                    else:
                        cell_texts = collect_cell_texts_for_tokens(
                            cells, tokens)
                html = wrap_table_html(
                    tokens, [tx or "" for tx in cell_texts])
                results[i] = TableResult(
                    html=html, cell_boxes=cells_xyxy,
                    structure_score=st.score,
                    is_wired=(cls[i][0] == 0),
                    is_e2e=not has_detected,
                    structure_tokens=tokens,
                    cells=cells,
                    cell_texts=cell_texts)
            except Exception as e:  # surface, don't stub (contract :8)
                raise OCRError("table analysis failed", table_index=i) from e
        return [r for r in results if r is not None]

    def _detect_cells(self, pages_u8, tables, wired_idx,
                      detector: Optional[LayoutDetector] = None,
                      angles: Optional[Sequence[int]] = None
                      ) -> List[np.ndarray]:
        """Run the RT-DETR cell detector on each table region in
        ``wired_idx``; boxes returned in page coordinates.

        The detector samples the CROPPED table frame through its matrix
        (table_analyzer.rs:311 crops first); a table-orientation angle
        composes a k·90° de-rotation into the same matrix and the
        detected boxes are rotated back (:354-383, :560-572) — so a
        rotated table is detected upright, matching the reference."""
        from ..ops.warp import resize_matrix

        det = detector if detector is not None else self.cell_detector
        ih, iw = det.variant.input_hw
        mats, idxs, offsets, sizes = [], [], [], []
        angs = ([angles[i] for i in wired_idx] if angles is not None
                else [0] * len(wired_idx))
        for i, ang in zip(wired_idx, angs):
            t = tables[i]
            x0, y0, x1, y1 = t.box
            w, h = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
            dw, dh = derot_dims(ang, int(w), int(h))
            m = (rotation_matrix(ang, int(w), int(h))
                 @ resize_matrix(int(dh), int(dw), ih, iw).astype(np.float64))
            shift = np.array([[1, 0, x0], [0, 1, y0], [0, 0, 1]], np.float64)
            mats.append((shift @ m).astype(np.float32))
            idxs.append(t.page_index)
            offsets.append((x0, y0))
            sizes.append((dh, dw))
        n_req = len(mats)
        with stage_timer("table.cells", batch=n_req):
            (b, s, l, v), _span = det._step(
                pages_u8, np.stack(mats), np.asarray(idxs, np.int64),
                np.asarray(sizes, np.float32))
            b, s, v = (b.cpu().numpy(), s.cpu().numpy(),
                       v.cpu().numpy())
        out = []
        for k, i in enumerate(wired_idx):
            ox, oy = offsets[k]
            t = tables[i]
            w = max(t.box[2] - t.box[0], 1.0)
            h = max(t.box[3] - t.box[1], 1.0)
            boxes = b[k][v[k]]
            boxes = rotate_boxes_back(boxes, angs[k], int(w), int(h))
            boxes = boxes + np.array([ox, oy, ox, oy], np.float32)
            # rotation turns xyxy corners; re-normalize to min/max form
            if len(boxes):
                x_lo = np.minimum(boxes[:, 0], boxes[:, 2])
                x_hi = np.maximum(boxes[:, 0], boxes[:, 2])
                y_lo = np.minimum(boxes[:, 1], boxes[:, 3])
                y_hi = np.maximum(boxes[:, 1], boxes[:, 3])
                boxes = np.stack([x_lo, y_lo, x_hi, y_hi], axis=1)
            out.append(boxes)
        return out

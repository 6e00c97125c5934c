"""OARStructure: the document-structure pipeline.

Counterpart of ``oar_ocr_tpu/pipelines/structure.py`` (:43-719). One
``predict`` call:

1. validate the uint8 RGB pages; run the document chain
   (``pipelines/preprocess.DocumentPreprocessor``) when configured
   (:84-98);
2. upload the page batch ONCE, padded to the det side buckets (:100-105);
   every page-frame stage below reads this upload;
3. layout detection in chunks of ``image_batch_size`` with the
   reference's fallback ladder, batched → single page → empty page
   (:107-131); a device fault (``RuntimeError``) is not caught, as in the
   port's ``OAROCR``;
4. the coarse region blocks (``pp-docblocklayout``, one more RT-DETR-L
   ``LayoutDetector``) when configured (:133-145);
5. the layout elements per page: overlap removal, label fixes, region
   membership (:147-166);
6. formulas: every formula element's crop of its original page (integer
   ``xyxy``), batched across pages into one ``recognize`` call (stage
   ``structure.formulas``), which sets ``formula_latex`` (:168-182);
7. the overall OCR on the shared upload (``OAROCR.predict(pages_dev=)``)
   and its refinement against the layout blocks, two waves of one
   ``recognize_chunk`` each (:184-200, :302-472);
8. seal text: ``OAROCRBuilder("seal")`` on the seal crops (:202-219);
9. tables (:221-260): every table element of every page through one
   ``TableAnalyzer.analyze_tables`` call on the shared upload (stage
   ``structure.tables``), then, on each page with a table whose cells a
   detector backed, the OCR boxes split at the cell boundaries and the
   fragments recognized again in one ``recognize_chunk``
   (:meth:`OARStructure._split_regions_by_cells`, :496-554, stage
   ``structure.table_ocr_split``);
10. the stitch, which matches OCR text into the table cells first
    (``stitching.stitch_tables``), and the reading order per page
    (:261-269).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..domain.layout import LayoutBox
from ..domain.structure import (LayoutElement, LayoutElementType,
                                RegionBlock, StructureResult,
                                fix_element_labels,
                                remove_overlapping_elements)
from ..domain.text_region import TextRegion
from ..errors import InvalidInputError
from ..models.detection.layout import LayoutDetector
from ..models.recognition.recognizer import CropPlan
from ..processors.table import split_ocr_boxes_by_cells
from ..runtime.runtime import DET_SIDE_BUCKETS, Runtime
from ..utils.tracing import logger, stage_timer
from .ocr import OAROCR, OAROCRBuilder
from .stitching import ResultStitcher
from .table_analyzer import TableAnalyzer, TableRegionInput


@dataclass
class OARStructureConfig:
    """The JAX package's defaults (:43-56)."""

    layout_variant: str = "pp-doclayout_plus-l"
    layout_score_thresh: float = 0.5
    image_batch_size: int = 4
    use_tables: bool = True
    use_formulas: bool = True
    use_seals: bool = True
    use_overall_ocr: bool = True
    use_region_blocks: bool = False     # PP-DocBlockLayout coarse regions
    use_doc_orientation: bool = False   # with_document_orientation
    use_doc_rectification: bool = False  # with_document_rectification
    use_textline_orientation: bool = False  # with_text_line_orientation
    use_table_orientation: bool = False  # with_table_orientation


def bbox_iou(a, b) -> float:
    """xyxy IoU; copied from ``oar_ocr_tpu/processors/table.py:499-506``,
    the one helper of that module the refinement uses."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


class OARStructure:
    """The assembled pipeline (:59-77). Use :class:`OARStructureBuilder`,
    or pass the stages: ``layout`` (a ``LayoutDetector``), ``ocr`` (an
    ``OAROCR`` or None), ``tables`` (a ``TableAnalyzer`` or None),
    ``formulas`` (a recognizer with ``recognize(crops) →
    [FormulaResult]``, e.g. ``FormulaRecognizer``, or None),
    ``seal_ocr`` (an ``OAROCR`` of the ``"seal"`` preset or None),
    ``region_detector`` (a ``LayoutDetector`` or None), ``preprocessor``
    (a ``DocumentPreprocessor`` or None)."""

    def __init__(self, *, layout: LayoutDetector, ocr: Optional[OAROCR],
                 tables: Optional[TableAnalyzer] = None, formulas=None,
                 seal_ocr: Optional[OAROCR] = None,
                 region_detector: Optional[LayoutDetector] = None,
                 stitcher: Optional[ResultStitcher] = None,
                 preprocessor=None,
                 cfg: Optional[OARStructureConfig] = None,
                 runtime: Optional[Runtime] = None):
        self.layout = layout
        self.ocr = ocr
        self.tables = tables
        self.formulas = formulas
        self.seal_ocr = seal_ocr
        self.region_detector = region_detector
        self.stitcher = stitcher or ResultStitcher()
        self.preprocessor = preprocessor
        self.cfg = cfg or OARStructureConfig()
        self.runtime = runtime or Runtime()

    def predict(self, images: Sequence[np.ndarray]) -> List[StructureResult]:
        """Multi-page structure analysis (:80-269)."""
        if not images:
            return []
        for im in images:
            if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
                raise InvalidInputError("images must be HWC uint8 RGB",
                                        shape=getattr(im, "shape", None))

        # the document chain first; downstream geometry stays in its frame
        if self.preprocessor is not None:
            with stage_timer("structure.preprocess", batch=len(images)):
                prepped = self.preprocessor.preprocess(list(images))
            images = [p.image for p in prepped]

        shapes = [im.shape[:2] for im in images]
        ph = DET_SIDE_BUCKETS.bucket(max(s[0] for s in shapes))
        pw = DET_SIDE_BUCKETS.bucket(max(s[1] for s in shapes))
        with stage_timer("structure.upload"):
            pages = self.runtime.put_pages(list(images), (ph, pw))

        # layout in chunks, batched → single page → empty (:107-131). The
        # JAX package notes the first chunk's fetch as a link bandwidth
        # sample here (runtime.h2d_checkpoint, :118-122); that link
        # machinery is not ported (ROADMAP queue 1 item 11).
        layout_boxes: List[List[LayoutBox]] = []
        bs = self.cfg.image_batch_size
        for s in range(0, len(images), bs):
            idx = list(range(s, min(s + bs, len(images))))
            try:
                layout_boxes.extend(self.layout.detect(
                    pages, [shapes[i] for i in idx], page_indices=idx))
            except RuntimeError:
                raise
            except Exception:
                for page_i in idx:
                    try:
                        layout_boxes.extend(self.layout.detect(
                            pages, [shapes[page_i]], page_indices=[page_i]))
                    except RuntimeError:
                        raise
                    except Exception:
                        logger.warning("layout failed for page %d", page_i,
                                       exc_info=True)
                        layout_boxes.append([])

        # coarse region blocks (PP-DocBlockLayout, :133-145)
        page_regions: List[List[RegionBlock]] = [[] for _ in images]
        if self.region_detector is not None and self.cfg.use_region_blocks:
            for page_i in range(len(images)):
                det = self.region_detector.detect(
                    pages, [shapes[page_i]], page_indices=[page_i])[0]
                page_regions[page_i] = [RegionBlock(box=b.box) for b in det]

        # elements per page (:147-166)
        page_elements: List[List[LayoutElement]] = []
        for page_i, boxes in enumerate(layout_boxes):
            els = [LayoutElement(
                element_type=LayoutElementType.from_label(b.label),
                box=b.box, score=b.score, label=b.label,
                order_index=b.order_index)
                for b in boxes]
            els = remove_overlapping_elements(els)
            fix_element_labels(els)
            for region in page_regions[page_i]:
                rx0, ry0, rx1, ry1 = [float(v) for v in region.box[:4]]
                for ei, el in enumerate(els):
                    x0, y0, x1, y1 = el.xyxy
                    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                    if rx0 <= cx <= rx1 and ry0 <= cy <= ry1:
                        region.element_indices.append(ei)
            page_elements.append(els)

        # formulas batched across pages (:168-182)
        if self.formulas is not None and self.cfg.use_formulas:
            crops, owners = [], []
            for page_i, els in enumerate(page_elements):
                for el in els:
                    if el.element_type.is_formula:
                        x0, y0, x1, y1 = [int(v) for v in el.xyxy]
                        crop = images[page_i][max(y0, 0):y1, max(x0, 0):x1]
                        if crop.size:
                            crops.append(crop)
                            owners.append(el)
            if crops:
                with stage_timer("structure.formulas", batch=len(crops)):
                    for el, res in zip(owners,
                                       self.formulas.recognize(crops)):
                        el.formula_latex = res.latex

        # overall OCR on the shared upload, then its refinement against
        # the layout blocks (:184-200)
        ocr_regions: List[List[TextRegion]] = [[] for _ in images]
        if self.ocr is not None and self.cfg.use_overall_ocr:
            with stage_timer("structure.overall_ocr"):
                ocr_results = self.ocr.predict(list(images), pages_dev=pages)
            for page_i, r in enumerate(ocr_results):
                ocr_regions[page_i] = r.regions
            with stage_timer("structure.ocr_refine"):
                ocr_regions = self._refine_ocr_pages(
                    pages, shapes, ocr_regions, page_elements)

        # seal text, batched across pages (:202-219)
        if self.seal_ocr is not None and self.cfg.use_seals:
            seal_crops, seal_owners = [], []
            for page_i, els in enumerate(page_elements):
                for el in els:
                    if el.element_type != LayoutElementType.SEAL:
                        continue
                    x0, y0, x1, y1 = [int(v) for v in el.xyxy]
                    crop = images[page_i][max(y0, 0):y1, max(x0, 0):x1]
                    if crop.size:
                        seal_crops.append(np.ascontiguousarray(crop))
                        seal_owners.append(el)
            if seal_crops:
                with stage_timer("structure.seal", batch=len(seal_crops)):
                    res = self.seal_ocr.predict(seal_crops)
                for el, r in zip(seal_owners, res):
                    el.text = "\n".join(r.texts)

        # tables, batched across pages (:221-260); the analyzer matches no
        # OCR text here: the stitcher does, after the cross-cell split
        if self.tables is not None and self.cfg.use_tables:
            inputs, owners = [], []
            for page_i, els in enumerate(page_elements):
                for el in els:
                    if el.element_type == LayoutElementType.TABLE:
                        inputs.append(TableRegionInput(page_index=page_i,
                                                       box=el.xyxy))
                        owners.append((page_i, el))
            if inputs:
                with stage_timer("structure.tables", batch=len(inputs)):
                    for (_, el), tr in zip(owners, self.tables.analyze_tables(
                            pages, inputs)):
                        el.table = tr

            # OCR boxes split at the cells of detection-backed tables and
            # the fragments recognized again (:241-260)
            if self.ocr is not None:
                page_tables: List[list] = [[] for _ in images]
                for page_i, el in owners:
                    if el.table is not None:
                        page_tables[page_i].append(el.table)
                for page_i in range(len(images)):
                    trs = [t for t in page_tables[page_i] if not t.is_e2e]
                    if trs and ocr_regions[page_i]:
                        with stage_timer("structure.table_ocr_split",
                                         page=page_i):
                            ocr_regions[page_i] = \
                                self._split_regions_by_cells(
                                    pages, page_i, shapes[page_i],
                                    ocr_regions[page_i], trs)

        # the stitch, which sorts in reading order, per page (:261-269)
        results: List[StructureResult] = []
        with stage_timer("structure.stitch", batch=len(images)):
            for page_i, els in enumerate(page_elements):
                h, w = shapes[page_i]
                stitched = self.stitcher.stitch(els, ocr_regions[page_i],
                                                w, h)
                results.append(StructureResult(elements=stitched, width=w,
                                               height=h))
        return results

    def predict_image(self, image: np.ndarray) -> StructureResult:
        """Single-page convenience (:271-273)."""
        return self.predict([image])[0]

    def predict_paths(self, paths: Sequence[str]) -> List[StructureResult]:
        """Decode the image files to RGB (``utils/image.load_images``,
        ``FAIL_FAST``), then :meth:`predict`; each result carries its
        source path (:275-285). A file that does not decode raises
        ``ImageLoadError``."""
        from ..utils.image import load_images

        images, _loaded = load_images([str(p) for p in paths])
        results = self.predict(images)
        for r, p in zip(results, paths):
            r.source_path = str(p)
        return results

    def _refine_ocr_pages(self, pages, shapes,
                          ocr_regions: List[List[TextRegion]],
                          page_elements: List[List[LayoutElement]]
                          ) -> List[List[TextRegion]]:
        """Refine the overall OCR against the layout blocks (:302-472),
        two waves of one ``recognize_chunk`` each, pooled across pages:

        1. every OCR box overlapping more than one non-excluded layout
           block (intersection w and h > 3 px) is recognized again per
           intersection: the first valid crop replaces the region, the
           rest are appended; existing regions covered by one of its crops
           (IoU > 0.8) lose their text, replayed in the reference's order;
        2. non-excluded blocks other than image and chart still without
           text get a whole-block OCR, applied in order against the
           growing region list.

        A page without OCR regions or layout elements is untouched;
        regions whose text was suppressed stay with ``text=None``."""
        min_pixels = 3.0

        def excluded(t: LayoutElementType) -> bool:
            return (t.is_formula or t == LayoutElementType.FORMULA_NUMBER
                    or t == LayoutElementType.TABLE
                    or t == LayoutElementType.SEAL)

        def inter_wh(a, b):
            return (min(a[2], b[2]) - max(a[0], b[0]),
                    min(a[3], b[3]) - max(a[1], b[1]))

        active = [p for p in range(len(ocr_regions))
                  if ocr_regions[p] and page_elements[p]]

        # wave 1: OCR boxes over several layout blocks (:343-416)
        plans: List[CropPlan] = []
        page_work: dict = {}
        for p in active:
            regions = ocr_regions[p]
            elements = page_elements[p]
            el_boxes = [el.xyxy for el in elements]
            work = []
            for ri, r in enumerate(regions):
                rb = r.xyxy
                ids = []
                for li, eb in enumerate(el_boxes):
                    if excluded(elements[li].element_type):
                        continue
                    iw, ih = inter_wh(rb, eb)
                    if iw > min_pixels and ih > min_pixels:
                        ids.append(li)
                if len(ids) <= 1:
                    continue
                crops = []
                for j, li in enumerate(ids):
                    x0 = max(rb[0], el_boxes[li][0])
                    y0 = max(rb[1], el_boxes[li][1])
                    x1 = min(rb[2], el_boxes[li][2])
                    y1 = min(rb[3], el_boxes[li][3])
                    if x1 - x0 <= 1.0 or y1 - y0 <= 1.0:
                        continue
                    crop_box = (x0, y0, x1, y1)
                    plan = self._crop_plan(p, shapes[p], crop_box)
                    slot = None
                    if plan is not None:
                        slot = len(plans)
                        plans.append(plan)
                    crops.append((crop_box, slot, j == 0))
                if crops:
                    work.append((ri, crops))
            if work:
                page_work[p] = work

        decoded = []
        if plans:
            with stage_timer("structure.ocr_refine.multi",
                             batch=len(plans)):
                decoded = self.ocr.recognizer.recognize_chunk(pages, plans)

        for p, work in page_work.items():
            regions = ocr_regions[p]
            appended: List[TextRegion] = []
            for ri, crops in work:
                for crop_box, _slot, _first in crops:
                    for oi, other in enumerate(regions):
                        if oi != ri and bbox_iou(other.xyxy,
                                                 crop_box) > 0.8:
                            other.text = None
                for crop_box, slot, is_first in crops:
                    if slot is None:
                        continue
                    text, conf, _c = decoded[slot]
                    if not text:
                        continue
                    x0, y0, x1, y1 = crop_box
                    quad = np.array([[x0, y0], [x1, y0], [x1, y1],
                                     [x0, y1]], np.float32)
                    if is_first:
                        regions[ri].box = quad
                        regions[ri].text = text
                        regions[ri].confidence = conf
                    else:
                        appended.append(TextRegion(box=quad, text=text,
                                                   confidence=conf))
            ocr_regions[p] = list(regions) + appended

        # wave 2: whole-block OCR for blocks without text (:418-472)
        plans, owners = [], []
        for p in active:
            regions = ocr_regions[p]
            for el in page_elements[p]:
                t = el.element_type
                if excluded(t) or t in (LayoutElementType.IMAGE,
                                        LayoutElementType.CHART):
                    continue
                eb = el.xyxy
                has_text = False
                for r in regions:
                    if not (r.text or "").strip():
                        continue
                    iw, ih = inter_wh(r.xyxy, eb)
                    if iw > min_pixels and ih > min_pixels:
                        has_text = True
                        break
                if has_text:
                    continue
                plan = self._crop_plan(p, shapes[p], eb)
                if plan is None:
                    continue
                plans.append(plan)
                owners.append((p, eb))

        if plans:
            with stage_timer("structure.ocr_refine.fallback",
                             batch=len(plans)):
                decoded = self.ocr.recognizer.recognize_chunk(pages, plans)
            for (p, eb), (text, conf, _c) in zip(owners, decoded):
                if not text:
                    continue
                satisfied = False
                for r in ocr_regions[p]:
                    if not (r.text or "").strip():
                        continue
                    iw, ih = inter_wh(r.xyxy, eb)
                    if iw > min_pixels and ih > min_pixels:
                        satisfied = True
                        break
                if satisfied:
                    continue
                x0, y0, x1, y1 = eb
                ocr_regions[p].append(TextRegion(
                    box=np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]],
                                 np.float32),
                    text=text, confidence=conf))
        return ocr_regions

    def _split_regions_by_cells(self, pages, page_i: int, page_shape,
                                regions: List[TextRegion],
                                tables) -> List[TextRegion]:
        """Split the OCR boxes that cross table cells and recognize the
        fragments again, in one ``recognize_chunk`` for the page
        (:496-554). A fragment's crop is floor/ceil-clamped to integers
        (degenerate ones dropped); its region keeps the float split
        coordinates; a fragment without text is dropped."""
        cell_rows = [t.cell_boxes for t in tables
                     if t.cell_boxes is not None and len(t.cell_boxes)]
        if not cell_rows:
            return regions
        cells = np.concatenate([np.asarray(c, np.float32).reshape(-1, 4)
                                for c in cell_rows], axis=0)
        splits = split_ocr_boxes_by_cells([r.xyxy for r in regions], cells)

        plans: List[CropPlan] = []
        plan_boxes: List[np.ndarray] = []
        slots: List[int] = []           # position in new_regions per plan
        new_regions: List[Optional[TextRegion]] = []
        for region, segs in zip(regions, splits):
            if segs is None:
                new_regions.append(region)
                continue
            for (fx1, fy1, fx2, fy2) in segs:
                plan = self._crop_plan(page_i, page_shape,
                                       (fx1, fy1, fx2, fy2))
                if plan is None:
                    continue
                plans.append(plan)
                plan_boxes.append(np.array(
                    [[fx1, fy1], [fx2, fy1], [fx2, fy2], [fx1, fy2]],
                    np.float32))
                slots.append(len(new_regions))
                new_regions.append(None)

        if plans:
            decoded = self.ocr.recognizer.recognize_chunk(pages, plans)
            for slot, box, (text, conf, _cols) in zip(slots, plan_boxes,
                                                      decoded):
                if text:
                    new_regions[slot] = TextRegion(
                        box=box, text=text, confidence=conf)
        return [r for r in new_regions if r is not None]

    @staticmethod
    def _crop_plan(page_i: int, page_shape, box_xyxy) -> Optional[CropPlan]:
        """Integer-clamped ``CropPlan`` of an axis-aligned page box
        (floor/ceil and clamp); None for a degenerate crop (:474-493)."""
        img_h, img_w = int(page_shape[0]), int(page_shape[1])
        fx1, fy1, fx2, fy2 = box_xyxy
        x1 = min(max(int(math.floor(fx1)), 0), max(img_w - 1, 0))
        y1 = min(max(int(math.floor(fy1)), 0), max(img_h - 1, 0))
        x2 = min(max(int(math.ceil(fx2)), 0), img_w)
        y2 = min(max(int(math.ceil(fy2)), 0), img_h)
        if x2 - x1 <= 1 or y2 - y1 <= 1:
            return None
        quad = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]],
                        np.float32)
        return CropPlan.from_quad(page_i, quad)


class OARStructureBuilder:
    """Fluent builder (:557-719). Every stage runs seeded random weights,
    as the JAX builder's do; a caller with weights passes the stages to
    :class:`OARStructure` itself."""

    def __init__(self):
        self._cfg = OARStructureConfig()
        self._runtime: Optional[Runtime] = None
        self._table_kw: dict = {}       # per-kind TableAnalyzer overrides
        self._formula_model_type = "default"

    def with_layout_variant(self, name: str) -> "OARStructureBuilder":
        self._cfg.layout_variant = name
        return self

    def with_runtime(self, runtime: Runtime) -> "OARStructureBuilder":
        self._runtime = runtime
        return self

    def with_tables(self, enable: bool = True) -> "OARStructureBuilder":
        self._cfg.use_tables = enable
        return self

    def with_formulas(self, enable: bool = True) -> "OARStructureBuilder":
        self._cfg.use_formulas = enable
        return self

    def with_seals(self, enable: bool = True) -> "OARStructureBuilder":
        self._cfg.use_seals = enable
        return self

    def with_overall_ocr(self, enable: bool = True) -> "OARStructureBuilder":
        self._cfg.use_overall_ocr = enable
        return self

    def with_region_blocks(self, enable: bool = True) -> "OARStructureBuilder":
        self._cfg.use_region_blocks = enable
        return self

    def with_doc_orientation(self, enable: bool = True
                             ) -> "OARStructureBuilder":
        """Upright the pages before the analysis."""
        self._cfg.use_doc_orientation = enable
        return self

    def with_doc_rectification(self, enable: bool = True
                               ) -> "OARStructureBuilder":
        """UVDoc unwarp before the analysis; results stay in the
        rectified frame."""
        self._cfg.use_doc_rectification = enable
        return self

    def with_textline_orientation(self, enable: bool = True
                                  ) -> "OARStructureBuilder":
        """180° text-line correction inside the overall OCR."""
        self._cfg.use_textline_orientation = enable
        return self

    def with_table_orientation(self, enable: bool = True
                               ) -> "OARStructureBuilder":
        """Classify and de-rotate the table crops before the structure
        recognition."""
        self._cfg.use_table_orientation = enable
        return self

    def with_wired_table_structure(self, model) -> "OARStructureBuilder":
        """The structure model of wired tables alone."""
        self._table_kw["wired_structure"] = model
        return self

    def with_wireless_table_structure(self, model) -> "OARStructureBuilder":
        """The structure model of wireless tables alone."""
        self._table_kw["wireless_structure"] = model
        return self

    def with_wired_table_cell_detection(self, detector
                                        ) -> "OARStructureBuilder":
        """The cell detector of wired tables."""
        self._table_kw["cell_detector"] = detector
        return self

    def with_wireless_table_cell_detection(self, detector
                                           ) -> "OARStructureBuilder":
        """A cell detector for wireless tables (none by default)."""
        self._table_kw["wireless_cell_detector"] = detector
        return self

    def with_formula_model_type(self, model_type: str
                                ) -> "OARStructureBuilder":
        """``"default"`` (``models/recognition/formula.py``),
        ``"pp-formulanet-exact"`` (the -S topology) or
        ``"pp-formulanet-l-exact"`` (-L: Vary-ViT-B encoder +
        MBart-1024, ``pp_formulanet_exact.py``) (:643-649)."""
        self._formula_model_type = model_type
        return self

    def with_table_structure_model_type(self, model_type: str
                                        ) -> "OARStructureBuilder":
        """``"slanet"`` (default), ``"slanet-exact"`` (SLANet_plus),
        ``"slanext-wired"`` / ``"slanext-exact"`` (SLANeXt at 512) or
        ``"slanext-wireless"`` (SLANeXt at 488)."""
        self._table_kw["structure_model_type"] = model_type
        return self

    def with_cells_to_html(self, enable: bool = True
                           ) -> "OARStructureBuilder":
        """Rebuild the table HTML from the DETECTED cell boxes instead of
        the structure decode's tokens."""
        self._table_kw["use_cells_to_html"] = enable
        return self

    def build(self) -> OARStructure:
        """The pipeline (:667-719)."""
        runtime = self._runtime or Runtime()
        layout = LayoutDetector(self._cfg.layout_variant,
                                score_thresh=self._cfg.layout_score_thresh,
                                runtime=runtime)
        region_detector = (LayoutDetector("pp-docblocklayout",
                                          score_thresh=0.4, runtime=runtime)
                           if self._cfg.use_region_blocks else None)
        ocr = None
        if self._cfg.use_overall_ocr:
            ob = OAROCRBuilder("general").with_runtime(runtime)
            if self._cfg.use_textline_orientation:
                ob = ob.with_textline_orientation()
            ocr = ob.build()
        preprocessor = None
        if self._cfg.use_doc_orientation or self._cfg.use_doc_rectification:
            from .preprocess import DocumentPreprocessor

            preprocessor = DocumentPreprocessor(
                use_orientation=self._cfg.use_doc_orientation,
                use_rectification=self._cfg.use_doc_rectification,
                runtime=runtime)
        table_ori = None
        if self._cfg.use_table_orientation:
            from ..models.classification.pp_lcnet import \
                doc_orientation_classifier

            table_ori = doc_orientation_classifier(runtime=runtime)
        tables = (TableAnalyzer(runtime=runtime, orientation=table_ori,
                                **self._table_kw)
                  if self._cfg.use_tables else None)
        formulas = None
        if self._cfg.use_formulas:
            if self._formula_model_type.startswith("pp-formulanet"):
                from ..models.recognition.pp_formulanet_exact import (
                    PPFormulaNetConfig, PPFormulaNetExactAdapter)

                fcfg = (PPFormulaNetConfig().large()
                        if "-l-" in self._formula_model_type else None)
                formulas = PPFormulaNetExactAdapter(cfg=fcfg,
                                                    runtime=runtime)
            else:
                from ..models.recognition.formula import FormulaRecognizer

                formulas = FormulaRecognizer(runtime=runtime)
        seal_ocr = (OAROCRBuilder("seal").with_runtime(runtime).build()
                    if self._cfg.use_seals else None)
        return OARStructure(layout=layout, ocr=ocr, tables=tables,
                            formulas=formulas, seal_ocr=seal_ocr,
                            region_detector=region_detector,
                            preprocessor=preprocessor, cfg=self._cfg,
                            runtime=runtime)

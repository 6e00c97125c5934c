"""DocParser: layout-first document parsing over any VLM backend.

Counterpart of ``oar_ocr_tpu/vl/doc_parser.py``, line for line but for
the page upload: the layout model reads the page from the port's
``Runtime.put_pages`` (padded to the detector's side bucket), and its
input normalize is K1 (``ops/normalize.py``, caller ``layout``).

Re-expresses oar-ocr-vl/src/doc_parser.rs:33-391 — the pipeline that runs
the classic layout detector (L5 predictor), sorts elements, crops regions,
and recognizes each region with a pluggable ``RecognitionBackend`` (the
VLM), mapping the layout element type to a recognition task
(RecognitionTask :33, backend trait :45, parse :141, parse_to_markdown
:391) and converting OTSL table output to HTML when the backend needs it
(utils/table.rs).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Protocol, Sequence

import numpy as np

from ..domain.structure import (LayoutElement, LayoutElementType,
                                StructureResult, TableResult)
from ..models.detection.layout import LayoutDetector
from ..processors.layout_sorting import sort_layout_enhanced
from ..runtime.runtime import DET_SIDE_BUCKETS, Runtime
from ..utils.tracing import stage_timer
from .otsl import needs_table_postprocess, otsl_to_html


class RecognitionTask(enum.Enum):
    """doc_parser.rs:33 RecognitionTask."""

    TEXT = "ocr"
    TABLE = "table"
    FORMULA = "formula"
    CHART = "chart"
    SEAL = "seal"


def task_for_element(t: LayoutElementType) -> Optional[RecognitionTask]:
    """Element type → recognition task (doc_parser.rs parse mapping).
    None means the region is not recognized (plain image)."""

    if t == LayoutElementType.TABLE:
        return RecognitionTask.TABLE
    if t.is_formula:
        return RecognitionTask.FORMULA
    if t == LayoutElementType.CHART:
        return RecognitionTask.CHART
    if t == LayoutElementType.SEAL:
        return RecognitionTask.SEAL
    if t.is_image_like:
        return None
    return RecognitionTask.TEXT


class RecognitionBackend(Protocol):
    """doc_parser.rs:45 — anything that turns region crops into text.
    ``max_tokens`` is the parser's per-region generation budget
    (doc_parser.rs:56); None = the backend's own default."""

    def recognize(self, images: Sequence[np.ndarray],
                  task: RecognitionTask,
                  max_tokens: Optional[int] = None) -> List[str]:
        ...


class VLMBackend:
    """RecognitionBackend over PaddleOCRVL (or compatible .generate)."""

    # PaddleOCR-VL outputs HTML directly (doc_parser.rs:467-469) but
    # wants formula margins cropped before recognition (:471-473)
    needs_table_postprocess = False
    needs_formula_preprocess = True

    def __init__(self, vlm):
        self.vlm = vlm

    def recognize(self, images, task: RecognitionTask,
                  max_tokens: Optional[int] = None) -> List[str]:
        if not images:
            return []
        # truncate repetition on the RAW output, before per-task
        # postprocess (doc_parser.rs:458-464)
        from ..vl.paddleocr_vl import postprocess_task_output
        from .text_format import truncate_repetitive_content

        out = self.vlm.generate(list(images), task=task.value,
                                max_new_tokens=max_tokens or 512, raw=True)
        return [postprocess_task_output(
            truncate_repetitive_content(r.text, 10, 10, 10), task.value)
            for r in out]


# Official per-backend task→prompt maps (doc_parser.rs RecognitionBackend
# impls: Hunyuan :487-498, GLM :533-537, MinerU :573-578).
HUNYUAN_TASK_PROMPTS = {
    RecognitionTask.TEXT: "Detect and recognize text in the image, and "
                         "output the text coordinates in a formatted "
                         "manner.",
    RecognitionTask.TABLE: "Parse the table in the image into HTML.",
    RecognitionTask.FORMULA: "Identify the formula in the image and "
                             "represent it using LaTeX format.",
    RecognitionTask.CHART: "Parse the chart in the image; use Mermaid "
                           "format for flowcharts and Markdown for other "
                           "charts.",
}
GLM_TASK_PROMPTS = {
    RecognitionTask.TEXT: "Text Recognition:",
    RecognitionTask.TABLE: "Table Recognition:",
    RecognitionTask.FORMULA: "Formula Recognition:",
    RecognitionTask.CHART: "Text Recognition:",
}
MINERU_TASK_PROMPTS = {
    RecognitionTask.TEXT: "\nText Recognition:",
    RecognitionTask.TABLE: "\nTable Recognition:",
    RecognitionTask.FORMULA: "\nFormula Recognition:",
    RecognitionTask.CHART: "\nDocument Parsing:",
}


def resize_for_mineru(image: np.ndarray, min_edge: int = 28,
                      max_aspect_ratio: float = 50.0) -> np.ndarray:
    """MinerU crop preprocessing (utils/image.rs:312 resize_for_mineru):
    pad extreme aspect ratios onto a centered white canvas, then scale up
    so the minimum edge meets the ViT patch-factor floor."""
    import cv2

    h, w = image.shape[:2]
    ratio = max(h, w) / max(min(h, w), 1)
    if ratio > max_aspect_ratio:
        if w > h:
            nh, nw = int(np.ceil(w / max_aspect_ratio)), w
        else:
            nh, nw = h, int(np.ceil(h / max_aspect_ratio))
        canvas = np.full((nh, nw, 3), 255, image.dtype)
        y, x = (nh - h) // 2, (nw - w) // 2
        canvas[y : y + h, x : x + w] = image
        image, h, w = canvas, nh, nw
    if min(h, w) < min_edge:
        scale = min_edge / min(h, w)
        image = cv2.resize(image, (int(np.ceil(w * scale)),
                                   int(np.ceil(h * scale))),
                           interpolation=cv2.INTER_LINEAR)
    return image


class FamilyBackend:
    """RecognitionBackend over a VLMFamily with an OFFICIAL per-task
    prompt map; GLM/MinerU flavors apply the reference's in-backend
    repetition truncation, MinerU additionally the small-crop resize."""

    def __init__(self, family, prompts, *, pre_resize: bool = False,
                 truncate: bool = False, max_new_tokens: int = 256,
                 needs_table_postprocess: bool = False):
        self.family = family
        self.prompts = prompts
        self.pre_resize = pre_resize
        self.truncate = truncate
        self.max_new_tokens = max_new_tokens
        # per-backend flag (doc_parser.rs:61): MinerU emits OTSL (true,
        # :596); Hunyuan/GLM emit HTML directly (false, :513/:553)
        self.needs_table_postprocess = needs_table_postprocess

    def recognize(self, images, task: RecognitionTask,
                  max_tokens: Optional[int] = None) -> List[str]:
        if not images:
            return []
        prompt = self.prompts.get(task, self.prompts[RecognitionTask.TEXT])
        imgs = [resize_for_mineru(im) if self.pre_resize else im
                for im in images]
        outs = self.family.generate(imgs, self.family.cfg.tasks[0],
                                    max_new_tokens=(max_tokens
                                                    or self.max_new_tokens),
                                    prompt=prompt)
        if self.truncate:
            # in-backend truncation, before per-task postprocess
            # (doc_parser.rs:509-511 "handled inside recognize()")
            from .text_format import truncate_repetitive_content

            outs = [truncate_repetitive_content(t, 10, 10, 10).strip()
                    for t in outs]
        return outs


def glm_backend(family, **kw) -> FamilyBackend:
    """GLM-OCR DocParser backend (doc_parser.rs:525)."""
    return FamilyBackend(family, GLM_TASK_PROMPTS, truncate=True, **kw)


def mineru_backend(family, **kw) -> FamilyBackend:
    """MinerU2.5 DocParser backend (doc_parser.rs:565): official prompts
    + min-edge-28 crop resize + repetition truncation + OTSL table
    postprocess (doc_parser.rs:596)."""
    return FamilyBackend(family, MINERU_TASK_PROMPTS, pre_resize=True,
                         truncate=True, needs_table_postprocess=True, **kw)


def hunyuan_backend(family, **kw) -> FamilyBackend:
    """HunyuanOCR DocParser backend (doc_parser.rs:480) — like GLM it
    truncates degenerate repetition in-backend (:509-511)."""
    return FamilyBackend(family, HUNYUAN_TASK_PROMPTS, truncate=True, **kw)


@dataclasses.dataclass
class DocParserConfig:
    """doc_parser.rs:78-111 DocParserConfig.

    ``max_tokens`` diverges from the reference default (4096) on
    purpose: the reference decode is an EOS-early-exit step loop where
    a high cap is nearly free, while this runtime decodes a static-trip
    lax.scan whose cost IS the cap (plus one remote compile per new
    power-of-two KV bucket). None = each backend's tuned budget
    (VLMBackend 512, FamilyBackend 256); set it explicitly for regions
    that genuinely need long generations."""

    crop_pad_ratio: float = 0.0            # OpenOCR CropByBoxes adds none
    max_tokens: Optional[int] = None
    skip_auxiliary_regions: bool = True    # header/footer/aside/number
    skip_region_blocks: bool = True        # PP-DocBlockLayout regions
    markdown_ignore_labels: tuple = None   # default set from text_format

    def __post_init__(self):
        if self.markdown_ignore_labels is None:
            from .text_format import DEFAULT_MARKDOWN_IGNORE_LABELS

            self.markdown_ignore_labels = DEFAULT_MARKDOWN_IGNORE_LABELS


def is_auxiliary_element(t: LayoutElementType) -> bool:
    """doc_parser.rs:609 — regions skipped before recognition."""
    return t in (LayoutElementType.NUMBER, LayoutElementType.FOOTNOTE,
                 LayoutElementType.HEADER, LayoutElementType.HEADER_IMAGE,
                 LayoutElementType.FOOTER, LayoutElementType.FOOTER_IMAGE,
                 LayoutElementType.ASIDE_TEXT)


def filter_overlap_boxes(boxes, overlap_threshold: float = 0.7):
    """Drop "reference" boxes, then the smaller of any pair whose
    small-box overlap ratio exceeds the threshold — except image-vs-other
    pairs, which coexist (oar-ocr-vl/src/utils.rs:843-885)."""
    boxes = [b for b in boxes if b.label != "reference"]
    dropped: set = set()
    for i in range(len(boxes)):
        for j in range(i + 1, len(boxes)):
            if i in dropped or j in dropped:
                continue
            bi = np.asarray(boxes[i].box, np.float32).reshape(4)
            bj = np.asarray(boxes[j].box, np.float32).reshape(4)
            iw = max(0.0, min(bi[2], bj[2]) - max(bi[0], bj[0]))
            ih = max(0.0, min(bi[3], bj[3]) - max(bi[1], bj[1]))
            area_i = max((bi[2] - bi[0]) * (bi[3] - bi[1]), 0.0)
            area_j = max((bj[2] - bj[0]) * (bj[3] - bj[1]), 0.0)
            small = min(area_i, area_j)
            ratio = (iw * ih) / small if small > 0 else 0.0
            if ratio > overlap_threshold:
                if ((boxes[i].label == "image" or boxes[j].label == "image")
                        and boxes[i].label != boxes[j].label):
                    continue
                dropped.add(j if area_i >= area_j else i)
    return [b for k, b in enumerate(boxes) if k not in dropped]


def pad_bbox(xyxy, page_w: float, page_h: float, pad_ratio: float):
    """Expand a crop box by a fraction of its size, clamped to the page
    (doc_parser.rs:637)."""
    x1, y1, x2, y2 = xyxy
    w, h = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
    px, py = w * pad_ratio, h * pad_ratio
    return (max(x1 - px, 0.0), max(y1 - py, 0.0),
            min(x2 + px, page_w), min(y2 + py, page_h))


class DocParser:
    """Layout → crop → per-region VLM recognition → StructureResult."""

    def __init__(self, backend: RecognitionBackend, *,
                 layout: Optional[LayoutDetector] = None,
                 layout_variant: str = "pp-doclayout_plus-l",
                 config: Optional[DocParserConfig] = None,
                 runtime: Optional[Runtime] = None):
        self.runtime = runtime or Runtime()
        self.layout = layout or LayoutDetector(layout_variant,
                                               runtime=self.runtime)
        self.backend = backend
        self.config = config or DocParserConfig()

    def parse(self, image: np.ndarray) -> StructureResult:
        h, w = image.shape[:2]
        pages = self.runtime.put_pages(
            [image], (DET_SIDE_BUCKETS.bucket(h), DET_SIDE_BUCKETS.bucket(w)))
        with stage_timer("docparser.layout"):
            boxes = self.layout.detect(pages, [(h, w)])[0]
        boxes = filter_overlap_boxes(boxes, 0.7)

        # element filtering (doc_parser.rs:202-219): drop region blocks
        # and auxiliary regions; fall back to whole-page OCR when
        # nothing survives
        elements = []
        for b in boxes:
            t = LayoutElementType.from_label(b.label)
            if self.config.skip_region_blocks and t == LayoutElementType.REGION:
                continue
            if self.config.skip_auxiliary_regions and is_auxiliary_element(t):
                continue
            el = LayoutElement(element_type=t, box=b.box, score=b.score)
            el.label = b.label          # raw label for openocr markdown
            elements.append(el)
        if not elements:
            return self._parse_full_image(image)

        order = sort_layout_enhanced(elements, w, h)
        elements = [elements[i] for i in order]

        # group crops by task so each task is one batched VLM call
        by_task: dict = {}
        for idx, el in enumerate(elements):
            task = task_for_element(el.element_type)
            if task is None:
                continue
            bb = el.xyxy
            if self.config.crop_pad_ratio > 0.0:
                bb = pad_bbox(bb, float(w), float(h),
                              self.config.crop_pad_ratio)
            x0, y0, x1, y1 = [int(v) for v in bb]
            crop = image[max(y0, 0):max(y1, y0 + 1),
                         max(x0, 0):max(x1, x0 + 1)]
            if crop.size == 0:
                continue
            crop = np.ascontiguousarray(crop)
            # formula margin crop when the backend wants it
            # (doc_parser.rs:342 needs_formula_preprocess → crop_margin)
            if (task == RecognitionTask.FORMULA
                    and getattr(self.backend, "needs_formula_preprocess",
                                False)):
                from ..models.recognition.formula import crop_formula_margins

                crop = crop_formula_margins(crop)
            by_task.setdefault(task, []).append((idx, crop))

        for task, items in by_task.items():
            with stage_timer(f"docparser.recognize[{task.value}]",
                             batch=len(items)):
                texts = self.backend.recognize(
                    [c for _, c in items], task,
                    max_tokens=self.config.max_tokens)
            for (idx, _), text in zip(items, texts):
                self._apply_generated(elements[idx], task, text)
        return StructureResult(elements=elements, width=w, height=h)

    def _apply_generated(self, el: LayoutElement, task: RecognitionTask,
                         text: str) -> None:
        """Post-process one generation (doc_parser.rs:349-385): skip
        empties, optional repetition truncation, per-task formatting
        (tables stay markup — never through the text normalizer), and
        ``el.text`` always carries the processed content like the
        reference's ``element.text``."""
        from .text_format import (format_formula, format_text,
                                  truncate_repetitive_content)

        if not text or not text.strip():
            return
        if getattr(self.backend, "needs_repetition_truncation", False):
            text = truncate_repetitive_content(text, 10, 10, 10)
        if task == RecognitionTask.TABLE:
            flag = getattr(self.backend, "needs_table_postprocess", None)
            convert = (flag if flag is not None
                       else needs_table_postprocess(text))
            processed = otsl_to_html(text) if convert else text.strip()
            el.table = TableResult(html=processed)
        elif task == RecognitionTask.FORMULA:
            processed = format_formula(text)
            el.formula_latex = processed
        else:
            processed = format_text(text)
        el.text = processed

    def _parse_full_image(self, image: np.ndarray) -> StructureResult:
        """Whole-page OCR when layout finds nothing
        (doc_parser.rs:417 recognize_full_image)."""
        h, w = image.shape[:2]
        texts = self.backend.recognize([np.ascontiguousarray(image)],
                                       RecognitionTask.TEXT,
                                       max_tokens=self.config.max_tokens)
        el = LayoutElement(
            element_type=LayoutElementType.TEXT,
            box=np.array([0.0, 0.0, float(w), float(h)], np.float32),
            score=1.0)
        el.label = "text"
        if texts and texts[0].strip():
            self._apply_generated(el, RecognitionTask.TEXT, texts[0])
        return StructureResult(elements=[el], width=w, height=h)

    def parse_to_markdown(self, image: np.ndarray) -> str:
        """doc_parser.rs:391 — the VL markdown exporter with per-type
        formatting (utils.rs:474)."""
        from .text_format import to_markdown

        return to_markdown(self.parse(image).elements,
                           self.config.markdown_ignore_labels)

    def parse_to_markdown_openocr(self, image: np.ndarray,
                                  pretty: bool = True) -> str:
        """doc_parser.rs:404 — OpenOCR/PaddleX markdown compatibility
        (utils.rs:601)."""
        from .text_format import to_markdown_openocr

        return to_markdown_openocr(self.parse(image).elements,
                                   self.config.markdown_ignore_labels,
                                   pretty)

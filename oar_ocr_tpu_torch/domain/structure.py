"""Structure-analysis result types and export (markdown / HTML / JSON).

Re-expresses the reference's domain/structure.rs (2,799 LoC): LayoutElement
+ LayoutElementType taxonomy (:1873, :1983 — ~40 labels, from_label :2103,
should_ocr :2274), StructureResult (:374) with to_markdown (:471), to_html
(:903), to_json_value (:1052), save_results (:1072),
concatenate_markdown_pages (:1223), text/markdown postprocessing
(:1563, :1731), overlap removal (:2305), label fixes (:2343), TableResult
(:2393), RegionBlock (:311), PageContinuationFlags (:331).

Pure host code: assembly and serialization of pipeline outputs.

The port's copy of ``oar_ocr_tpu/domain/structure.py`` (:1-773), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import enum
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class LayoutElementType(enum.Enum):
    """Canonical layout element taxonomy (structure.rs:1983)."""

    TEXT = "text"
    PARAGRAPH_TITLE = "paragraph_title"
    DOC_TITLE = "doc_title"
    FIGURE_TITLE = "figure_title"
    TABLE_TITLE = "table_title"
    CHART_TITLE = "chart_title"
    # combined caption label ("figure_table_chart_title" | "caption",
    # structure.rs:2011/2124) — sorts and renders as a vision title
    FIGURE_TABLE_CHART_TITLE = "figure_table_chart_title"
    ABSTRACT = "abstract"
    CONTENT = "content"
    LIST = "list"
    NUMBER = "number"
    REFERENCE = "reference"
    REFERENCE_CONTENT = "reference_content"
    FOOTNOTE = "footnote"
    HEADER = "header"
    FOOTER = "footer"
    HEADER_IMAGE = "header_image"
    FOOTER_IMAGE = "footer_image"
    ALGORITHM = "algorithm"
    FORMULA = "formula"
    DISPLAY_FORMULA = "display_formula"
    INLINE_FORMULA = "inline_formula"
    FORMULA_NUMBER = "formula_number"
    IMAGE = "image"
    FIGURE = "figure"
    CHART = "chart"
    TABLE = "table"
    SEAL = "seal"
    ASIDE_TEXT = "aside_text"
    VERTICAL_TEXT = "vertical_text"
    VISION_FOOTNOTE = "vision_footnote"
    REGION = "region"
    TITLE = "title"
    UNKNOWN = "unknown"

    @classmethod
    def from_label(cls, label: str) -> "LayoutElementType":
        """structure.rs:2103 — tolerant label parsing."""
        norm = label.strip().lower().replace("-", "_").replace(" ", "_")
        if norm == "caption":                    # structure.rs:2124
            return cls.FIGURE_TABLE_CHART_TITLE
        for t in cls:
            if t.value == norm:
                return t
        return cls.UNKNOWN

    @property
    def is_title(self) -> bool:
        return self in (LayoutElementType.DOC_TITLE,
                        LayoutElementType.PARAGRAPH_TITLE,
                        LayoutElementType.TITLE)

    @property
    def is_formula(self) -> bool:
        return self in (LayoutElementType.FORMULA,
                        LayoutElementType.DISPLAY_FORMULA,
                        LayoutElementType.INLINE_FORMULA)

    @property
    def is_image_like(self) -> bool:
        return self in (LayoutElementType.IMAGE, LayoutElementType.FIGURE,
                        LayoutElementType.CHART,
                        LayoutElementType.HEADER_IMAGE,
                        LayoutElementType.FOOTER_IMAGE)

    @property
    def should_ocr(self) -> bool:
        """structure.rs:2274 — tables/images/seals/formulas skip overall OCR."""
        return not (self.is_image_like or self.is_formula or self in (
            LayoutElementType.TABLE, LayoutElementType.SEAL,
            LayoutElementType.REGION))

    @property
    def excluded_from_markdown(self) -> bool:
        # structure.rs:503-513 — PP-StructureV3 markdown ignores the
        # auxiliary labels, FOOTNOTE included (ASIDE_TEXT is filtered at
        # the same site in to_markdown)
        return self in (LayoutElementType.HEADER, LayoutElementType.FOOTER,
                        LayoutElementType.NUMBER,
                        LayoutElementType.FOOTNOTE,
                        LayoutElementType.HEADER_IMAGE,
                        LayoutElementType.FOOTER_IMAGE)

    @property
    def is_caption(self) -> bool:
        return self in (LayoutElementType.FIGURE_TITLE,
                        LayoutElementType.TABLE_TITLE,
                        LayoutElementType.CHART_TITLE,
                        LayoutElementType.FIGURE_TABLE_CHART_TITLE)

    @property
    def is_header(self) -> bool:
        return self in (LayoutElementType.HEADER,
                        LayoutElementType.HEADER_IMAGE)

    @property
    def is_footer(self) -> bool:
        return self in (LayoutElementType.FOOTER,
                        LayoutElementType.FOOTER_IMAGE,
                        LayoutElementType.FOOTNOTE)

    @property
    def semantic_category(self) -> str:
        """Coarse grouping for downstream consumers
        (structure.rs:2171-2222)."""
        T = LayoutElementType
        if self in (T.DOC_TITLE, T.PARAGRAPH_TITLE, T.TITLE):
            return "title"
        if self in (T.TEXT, T.CONTENT, T.ABSTRACT):
            return "text"
        if self in (T.IMAGE, T.CHART, T.FIGURE):
            return "visual"
        if self == T.TABLE:
            return "table"
        if self.is_caption:
            return "caption"
        if self.is_header:
            return "header"
        if self.is_footer:
            return "footer"
        if self in (T.FORMULA, T.DISPLAY_FORMULA, T.INLINE_FORMULA,
                    T.FORMULA_NUMBER):
            return "formula"
        if self == T.LIST:
            return "list"
        if self == T.REGION:
            return "region"
        if self in (T.SEAL, T.NUMBER, T.REFERENCE, T.REFERENCE_CONTENT,
                    T.ALGORITHM, T.ASIDE_TEXT, T.VERTICAL_TEXT):
            return "special"
        return "other"


@dataclass
class TableResult:
    """structure.rs:2393 — one analyzed table."""

    html: str
    cell_boxes: Optional[np.ndarray] = None       # (N, 4) xyxy page coords
    structure_score: float = 0.0
    is_wired: Optional[bool] = None
    # True when cells come only from the E2E structure decode; False when
    # a cell DETECTOR backed them (TableResult.is_e2e, structure.rs:2393;
    # gates OCR-box splitting, :2674 has_detection_backed_table_cells)
    is_e2e: bool = True
    # Stitcher inputs (structure.rs:2393 TableResult keeps cells +
    # structure_tokens so ResultStitcher.stitch_tables can match OCR text
    # into cells AFTER the table analyzer ran — the analyzer itself does
    # not match text, table_analyzer.rs:12). ``cells`` is a list of
    # processors.table.TableCell (page-coord bbox + grid row/col);
    # ``cell_texts`` is filled by the stitcher in structure-token order.
    structure_tokens: Optional[List[str]] = None
    cells: Optional[list] = None
    cell_texts: Optional[List[Optional[str]]] = None

    def to_json(self) -> dict:
        return {
            "html": self.html,
            "cell_boxes": self.cell_boxes.tolist()
            if self.cell_boxes is not None else None,
            "structure_score": self.structure_score,
            "is_wired": self.is_wired,
            "is_e2e": self.is_e2e,
            "cell_texts": self.cell_texts,
        }


@dataclass
class LayoutElement:
    """structure.rs:1873 — one layout region with recognized content."""

    element_type: LayoutElementType
    box: np.ndarray                               # (4,) xyxy
    score: float = 0.0
    # raw detector label (with_label, structure.rs:1924) — drives the
    # OpenOCR markdown dispatch and ignore lists; element_type is the
    # normalized taxonomy view of the same string
    label: Optional[str] = None
    text: Optional[str] = None
    table: Optional[TableResult] = None
    formula_latex: Optional[str] = None
    order_index: Optional[float] = None
    text_regions: List = field(default_factory=list)  # stitched TextRegions
    # stitch-derived segment metadata (stitching.rs seg_start_x/seg_end_x/
    # num_lines — feeds xycut_enhanced direction detection and the
    # page-continuation heuristics)
    num_lines: Optional[int] = None
    seg_start_x: Optional[float] = None
    seg_end_x: Optional[float] = None

    @property
    def xyxy(self) -> Tuple[float, float, float, float]:
        b = np.asarray(self.box, np.float32).reshape(4)
        return float(b[0]), float(b[1]), float(b[2]), float(b[3])

    def to_json(self) -> dict:
        return {
            "type": self.element_type.value,
            "box": np.asarray(self.box).reshape(4).tolist(),
            "score": self.score,
            "text": self.text,
            "table": self.table.to_json() if self.table else None,
            "formula": self.formula_latex,
            "order_index": self.order_index,
        }


@dataclass
class RegionBlock:
    """structure.rs:311 — coarse region grouping from PP-DocBlockLayout."""

    box: np.ndarray
    element_indices: List[int] = field(default_factory=list)


@dataclass
class PageContinuationFlags:
    """structure.rs:331 — hints for cross-page markdown concatenation."""

    starts_mid_paragraph: bool = False
    ends_mid_paragraph: bool = False


@dataclass
class StructureResult:
    """structure.rs:374 — full structure analysis of one page."""

    elements: List[LayoutElement] = field(default_factory=list)
    width: int = 0
    height: int = 0
    source_path: Optional[str] = None
    # None → compute from element geometry on demand (structure.rs:1240)
    continuation: Optional[PageContinuationFlags] = None
    error: Optional[str] = None

    def calculate_continuation_flags(self) -> PageContinuationFlags:
        """structure.rs:851-898 — infer whether this page starts/ends in
        the middle of a paragraph from its text elements' geometry: the
        first text element starting within 5% of the page width of the
        left edge marks a NEW paragraph start; the last one ending more
        than 10% short of the right edge marks a COMPLETE paragraph."""
        T = LayoutElementType
        text_kinds = (T.TEXT, T.DOC_TITLE, T.PARAGRAPH_TITLE, T.ABSTRACT,
                      T.REFERENCE)
        texts = [e for e in self.elements if e.element_type in text_kinds]
        if not texts:
            return PageContinuationFlags(starts_mid_paragraph=False,
                                         ends_mid_paragraph=False)
        page_width = float(self.width) if self.width else max(
            (e.xyxy[2] for e in self.elements), default=0.0)
        left_thresh = page_width * 0.05 if page_width else 50.0
        starts_new = texts[0].xyxy[0] <= left_thresh
        if page_width:
            ends_complete = texts[-1].xyxy[2] <= page_width * 0.9
        else:
            ends_complete = True
        return PageContinuationFlags(starts_mid_paragraph=not starts_new,
                                     ends_mid_paragraph=not ends_complete)

    def effective_continuation_flags(self) -> PageContinuationFlags:
        return (self.continuation if self.continuation is not None
                else self.calculate_continuation_flags())

    # ---------------- markdown (structure.rs:471-860) ----------------
    def to_markdown(self) -> str:
        """Full PaddleX-parity markdown rendering (domain/markdown.py holds
        the rule helpers; structure.rs:471 the original)."""
        from .markdown import (clean_ocr_text, format_as_bullet_list,
                               format_content_block, format_first_line,
                               format_text_block, format_title_with_level,
                               format_vision_footnote_block, get_seg_flag,
                               has_bullet_markers, image_markdown,
                               infer_paragraph_title_levels,
                               simplify_table_html)

        T = LayoutElementType
        els = self.elements
        table_boxes = [el.xyxy for el in els if el.element_type == T.TABLE]
        page_width = float(self.width or max(
            (el.xyxy[2] for el in els), default=1.0))
        title_levels = infer_paragraph_title_levels(els)
        parts: List[str] = []
        prev_text: Optional[LayoutElement] = None

        def _ioa(a, b) -> float:
            ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
            ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
            inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
            area = max((a[2] - a[0]) * (a[3] - a[1]), 1e-6)
            return inter / area

        for idx, el in enumerate(els):
            t = el.element_type
            if t.excluded_from_markdown or t in (T.ASIDE_TEXT,
                                                 T.FORMULA_NUMBER):
                continue
            # low-confidence text mostly inside a table is that table's
            # content, not body text (structure.rs:509-517)
            if t == T.TEXT and el.score < 0.7 and any(
                    _ioa(el.xyxy, tb) > 0.3 for tb in table_boxes):
                continue

            is_continuation = (t == T.TEXT and prev_text is not None
                               and not get_seg_flag(el, prev_text))

            if t == T.DOC_TITLE:
                if el.text is None:
                    # reference guards the whole branch on Some(text)
                    # (structure.rs:550-565) — no stray bare "# " heading
                    continue
                cleaned = clean_ocr_text(el.text)
                kw = cleaned.strip().rstrip(":").upper()
                prefix = "## " if kw in ("ABSTRACT", "INTRODUCTION",
                                         "REFERENCES", "REFERENCE") else "# "
                parts.append(prefix + cleaned)
            elif t in (T.PARAGRAPH_TITLE, T.TITLE):
                level, formatted = format_title_with_level(
                    el.text or "", title_levels.get(idx))
                parts.append("#" * level + " " + formatted)
            elif t == T.TABLE:
                if el.table is not None and el.table.html:
                    inner = simplify_table_html(el.table.html)
                    inner = inner.replace("<table>", '<table border="1">', 1)
                    parts.append('<div style="text-align: center;">'
                                 + clean_ocr_text(inner) + "</div>")
                else:
                    parts.append("[Table]")
            elif t.is_formula:
                raw = (el.formula_latex or el.text or "").strip()
                if not raw:
                    continue
                if raw.startswith("$$") and raw.endswith("$$"):
                    raw = raw[2:-2]
                elif raw.startswith("$") and raw.endswith("$"):
                    raw = raw[1:-1]
                # inline vs display (structure.rs:634-684): the nearest
                # non-formula neighbor on BOTH sides must be same-line
                # text — one-sided alignment is almost always a display
                # equation
                def _nearest(rng):
                    for j in rng:
                        tj = els[j].element_type
                        if not (tj.is_formula or tj == T.FORMULA_NUMBER):
                            return els[j]
                    return None

                def _inline_side(n):
                    return (n is not None
                            and n.element_type in (T.TEXT,
                                                   T.REFERENCE_CONTENT)
                            and _is_same_line(el.xyxy, n.xyxy))

                if (parts and _inline_side(_nearest(range(idx - 1, -1, -1)))
                        and _inline_side(_nearest(range(idx + 1, len(els))))):
                    parts[-1] = parts[-1] + f"${raw}$ "
                else:
                    parts.append(f"$${raw}$$")
            elif t in (T.IMAGE, T.FIGURE, T.CHART):
                kind = "chart" if t == T.CHART else "image"
                parts.append(image_markdown(kind, el.xyxy, page_width))
            elif t == T.SEAL:
                seal = "![Seal]"
                if el.text:
                    seal += "\n> " + el.text
                parts.append(seal)
            elif t.is_caption:
                if el.text:
                    parts.append('<div style="text-align: center;">'
                                 + clean_ocr_text(el.text) + " </div>")
            elif t == T.ABSTRACT:
                if el.text:
                    parts.append(format_first_line(
                        el.text, " ", ("abstract", "摘要"), "## "))
            elif t == T.REFERENCE:
                if el.text:
                    parts.append(format_first_line(
                        el.text, "\n", ("references", "参考文献"), "## "))
            elif t == T.CONTENT:
                if el.text:
                    parts.append(format_content_block(el.text))
            elif t == T.VISION_FOOTNOTE:
                if el.text:
                    parts.append(format_vision_footnote_block(el.text))
            elif t == T.LIST:
                if el.text:
                    lines = [ln.strip() for ln
                             in format_text_block(el.text).splitlines()
                             if ln.strip()]
                    parts.append("".join(f"- {ln}\n" for ln in lines))
            elif t == T.ALGORITHM:
                if el.text:
                    parts.append(el.text.strip("\n"))
            else:
                if not el.text:
                    continue
                cleaned = clean_ocr_text(el.text)
                if has_bullet_markers(cleaned):
                    parts.append(format_as_bullet_list(cleaned))
                elif is_continuation and parts:
                    # paragraph continuation: glue to the previous block
                    parts[-1] = parts[-1] + format_text_block(el.text)
                else:
                    parts.append(format_text_block(el.text))
            if t in (T.TEXT, T.REFERENCE_CONTENT):
                prev_text = el
        # single-page markdown is only trimmed (structure.rs:841); the
        # full postprocess_markdown pass is a separate public step users
        # apply to CONCATENATED documents (examples/utils/markdown.rs:103)
        return _finalize_markdown("\n\n".join(p for p in parts if p))

    # ---------------- html (structure.rs:903) ----------------
    def to_html(self) -> str:
        body: List[str] = []
        for el in self.elements:
            t = el.element_type
            if t == LayoutElementType.TABLE and el.table is not None:
                inner = _strip_html_wrapper(el.table.html)
                body.append(inner)
            elif t.is_formula and el.formula_latex:
                body.append(f"<div class='formula'>$${el.formula_latex}$$</div>")
            elif t == LayoutElementType.DOC_TITLE:
                body.append(f"<h1>{_escape(el.text)}</h1>")
            elif t.is_title:
                body.append(f"<h2>{_escape(el.text)}</h2>")
            elif t.is_image_like:
                body.append("<div class='image'><!-- image --></div>")
            elif el.text:
                body.append(f"<p>{_escape(el.text)}</p>")
        return ("<html><body>\n" + "\n".join(body) + "\n</body></html>")

    # ---------------- json (structure.rs:1052) ----------------
    def to_json_value(self) -> dict:
        return {
            "source_path": self.source_path,
            "width": self.width,
            "height": self.height,
            "error": self.error,
            "elements": [el.to_json() for el in self.elements],
        }

    def save_results(self, out_dir: str, stem: str = "page",
                     page_image=None) -> Dict[str, str]:
        """structure.rs:1072 — write markdown + html + json side by side.
        With ``page_image`` (HWC uint8) the image/chart crops referenced by
        the markdown's ``imgs/…`` links are extracted and saved too (the
        reference's imgs/ directory, structure.rs:690-713)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {}
        for ext, content in (("md", self.to_markdown()),
                             ("html", self.to_html()),
                             ("json", json.dumps(self.to_json_value(),
                                                 ensure_ascii=False, indent=2))):
            p = os.path.join(out_dir, f"{stem}.{ext}")
            with open(p, "w", encoding="utf-8") as f:
                f.write(content)
            paths[ext] = p
        if page_image is not None:
            n = self.extract_images(out_dir, page_image)
            if n:
                paths["imgs"] = os.path.join(out_dir, "imgs")
        return paths

    def extract_images(self, out_dir: str, page_image) -> int:
        """Crop every image/chart element into ``out_dir/imgs/`` under the
        exact names the markdown references. Returns crops written."""
        import cv2

        from .markdown import image_markdown_name

        T = LayoutElementType
        img_dir = os.path.join(out_dir, "imgs")
        count = 0
        h, w = page_image.shape[:2]
        for el in self.elements:
            if el.element_type not in (T.IMAGE, T.FIGURE, T.CHART):
                continue
            kind = "chart" if el.element_type == T.CHART else "image"
            x0, y0, x1, y1 = el.xyxy
            xi0, yi0 = max(int(x0), 0), max(int(y0), 0)
            xi1, yi1 = min(int(round(x1)), w), min(int(round(y1)), h)
            if xi1 <= xi0 or yi1 <= yi0:
                continue
            os.makedirs(img_dir, exist_ok=True)
            crop = page_image[yi0:yi1, xi0:xi1]
            name = image_markdown_name(kind, el.xyxy)
            path = os.path.join(out_dir, name)
            cv2.imwrite(path, crop[..., ::-1])
            count += 1
        return count


def _is_same_line(a, b) -> bool:
    """Vertical-overlap same-line test (structure.rs:1644-1662): overlap
    must exceed 50% of the shorter box's height."""
    overlap = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    min_h = min(a[3] - a[1], b[3] - b[1])
    return min_h > 0.0 and overlap / min_h > 0.5


def concatenate_markdown_pages(pages: Sequence[StructureResult]) -> str:
    """structure.rs:1223-1283 — join pages, gluing a paragraph split
    across a page break directly (no separator for Chinese text, one
    space otherwise).  Pages without explicit continuation flags get
    them computed from element geometry; empty pages are skipped but
    still propagate their end flag."""
    from .markdown import is_chinese_char

    out = ""
    prev_end = True                 # first page starts fresh
    for page in pages:
        flags = page.effective_continuation_flags()
        md = page.to_markdown().strip()
        if not md:
            prev_end = not flags.ends_mid_paragraph
            continue
        if flags.starts_mid_paragraph and not prev_end:
            joint_chinese = (bool(out) and is_chinese_char(out[-1])) or \
                (bool(md) and is_chinese_char(md[0]))
            out += ("" if joint_chinese else " ") + md.lstrip()
        else:
            out += ("\n\n" if out else "") + md
        prev_end = not flags.ends_mid_paragraph
    return out.strip()


def save_multi_page_results(pages: Sequence[StructureResult], out_dir: str,
                            base_name: str = "document",
                            page_images: Optional[Sequence] = None
                            ) -> Dict[str, str]:
    """structure.rs:1814-1868 StructureResultExt::save_multi_page_results
    — per-page ``page_{idx:03}/`` exports plus the concatenated
    ``{base_name}.md`` and ``{base_name}.json`` at the top level."""
    os.makedirs(out_dir, exist_ok=True)
    for idx, page in enumerate(pages):
        img = page_images[idx] if page_images is not None else None
        page.save_results(os.path.join(out_dir, f"page_{idx:03d}"),
                          page_image=img)
    paths: Dict[str, str] = {}
    md_path = os.path.join(out_dir, f"{base_name}.md")
    with open(md_path, "w", encoding="utf-8") as f:
        f.write(postprocess_markdown(concatenate_markdown_pages(pages)))
    paths["md"] = md_path
    json_path = os.path.join(out_dir, f"{base_name}.json")
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump([p.to_json_value() for p in pages], f,
                  ensure_ascii=False, indent=2)
    paths["json"] = json_path
    return paths


# ---------------- text postprocessing (structure.rs:1563,:1731) ----------------

_WS_RE = re.compile(r"[ \t]+")
_MULTI_NL_RE = re.compile(r"\n{3,}")
_CLOSE_PUNCT = set(".,!?;:)]}")


def _finalize_markdown(md: str) -> str:
    """Light single-page cleanup: collapse runs of blank lines + trim."""
    return _MULTI_NL_RE.sub("\n\n", md).strip() + ("\n" if md else "")


def postprocess_text(text: str) -> str:
    """OCR/PDF artifact cleanup (structure.rs:1563-1599): dehyphenate →
    fix merged words → whitespace normalization that collapses runs of
    whitespace to one space, drops a space preceding closing punctuation,
    and inserts the missing space at a "word.Next" sentence boundary.
    (The reference's period branch as written DELETES the space after a
    sentence-ending period — a transcription slip of PaddleX's intent its
    own comment states as "fix missing space after period"; we implement
    the stated intent.)"""
    from .markdown import dehyphenate, fix_merged_words

    text = fix_merged_words(dehyphenate(text))
    out: List[str] = []
    in_space = False
    n = len(text)
    for i, c in enumerate(text):
        if c.isspace():
            if not in_space and out:
                out.append(" ")
                in_space = True
            continue
        if in_space and c in _CLOSE_PUNCT and out:
            out[-1] = c             # drop the space before punctuation
            in_space = False
            continue
        if (c == "." and out and (out[-1].isalnum())
                and i + 1 < n and text[i + 1].isupper()
                and text[i + 1].isascii()):
            out.append(". ")
            in_space = True
            continue
        out.append(c)
        in_space = False
    return "".join(out).rstrip()


def deduplicate_sections(markdown: str) -> str:
    """Drop repeated ``**Section**`` header lines, keeping the first
    occurrence (structure.rs:1606-1638)."""
    seen = set()
    out: List[str] = []
    for line in markdown.splitlines():
        t = line.strip()
        if t.startswith("**") and t.endswith("**") and len(t) > 4:
            name = t[2:-2]
            if name in seen:
                continue
            seen.add(name)
        out.append(line)
    return "\n".join(out)


def filter_empty_formulas(markdown: str) -> str:
    """Remove ``$$ … $$`` blocks with no content (structure.rs:1667)."""
    lines = markdown.splitlines()
    out: List[str] = []
    i = 0
    while i < len(lines):
        if lines[i].strip() == "$$":
            # adjacent $$ pair → drop both (+ one following blank line)
            if i + 1 < len(lines) and lines[i + 1].strip() == "$$":
                i += 2
                if i < len(lines) and not lines[i].strip():
                    i += 1
                continue
            j = i + 1
            has_content = False
            while j < len(lines) and lines[j].strip() != "$$":
                if lines[j].strip():
                    has_content = True
                    break
                j += 1
            if not has_content:
                # skip opener, blanks, AND the closing $$ (the reference's
                # skip loop at structure.rs:1706-1714 starts ON the opener
                # and so drops only it, leaving an unmatched $$ that flips
                # every later line into math mode — fixed here)
                while j < len(lines) and lines[j].strip() != "$$":
                    j += 1
                i = j + 1
                continue
        out.append(lines[i])
        i += 1
    return "\n".join(out)


_MD_PREFIXES = ("#", "*", ">", "|", "-", "+")


def postprocess_markdown(md: str) -> str:
    """Full document-level cleanup for CONCATENATED markdown
    (structure.rs:1731-1807): filter empty formula blocks, deduplicate
    ``**Section**`` headers, escape bare ``$`` inside ``$$`` blocks (the
    KaTeX "can't use '$' in math mode" guard), and run
    :func:`postprocess_text` over plain prose lines — never inside code
    fences, formulas, headings, lists, quotes or tables."""
    md = deduplicate_sections(filter_empty_formulas(md))
    out: List[str] = []
    in_code = in_formula = False
    for line in md.splitlines():
        t = line.strip()
        if t.startswith("```"):
            in_code = not in_code
            out.append(line)
        elif t == "$$":
            in_formula = not in_formula
            out.append(line)
        elif in_code:
            out.append(line)
        elif in_formula:
            out.append(line.replace("$", r"\$") if "$" in line else line)
        elif t.startswith(_MD_PREFIXES):
            out.append(line)
        else:
            out.append(postprocess_text(line))
    return "\n".join(out) + ("\n" if out else "")


def remove_overlapping_elements(elements: List[LayoutElement],
                                ioa_thresh: float = 0.9) -> List[LayoutElement]:
    """structure.rs:2305 — drop an element mostly contained in a
    same-or-higher-score element of a comparable type."""

    keep = [True] * len(elements)
    for i, a in enumerate(elements):
        if not keep[i]:
            continue
        ax0, ay0, ax1, ay1 = a.xyxy
        area_a = max((ax1 - ax0) * (ay1 - ay0), 1e-6)
        for j, b in enumerate(elements):
            if i == j or not keep[j]:
                continue
            bx0, by0, bx1, by1 = b.xyxy
            iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
            ih = max(0.0, min(ay1, by1) - max(ay0, by0))
            ioa = iw * ih / area_a
            if ioa > ioa_thresh and b.score >= a.score:
                area_b = max((bx1 - bx0) * (by1 - by0), 1e-6)
                if area_b >= area_a:
                    keep[i] = False
                    break
    return [e for e, k in zip(elements, keep) if k]


def fix_element_labels(elements: List[LayoutElement]) -> None:
    """structure.rs:2343 — heuristic label fixes applied in place: a
    'title' directly above a table becomes table_title; the top-most large
    title becomes doc_title if none exists."""

    tables = [e for e in elements if e.element_type == LayoutElementType.TABLE]
    for el in elements:
        if el.element_type in (LayoutElementType.TITLE,
                               LayoutElementType.PARAGRAPH_TITLE):
            x0, y0, x1, y1 = el.xyxy
            for t in tables:
                tx0, ty0, tx1, ty1 = t.xyxy
                overlap_x = min(x1, tx1) - max(x0, tx0)
                if overlap_x > 0.5 * (x1 - x0) and 0 <= ty0 - y1 < 60:
                    el.element_type = LayoutElementType.TABLE_TITLE
                    break
    if not any(e.element_type == LayoutElementType.DOC_TITLE
               for e in elements):
        titles = [e for e in elements if e.element_type in (
            LayoutElementType.TITLE, LayoutElementType.PARAGRAPH_TITLE)]
        if titles:
            top = min(titles, key=lambda e: e.xyxy[1])
            page_top = min((e.xyxy[1] for e in elements), default=0.0)
            if top.xyxy[1] <= page_top + 5.0:
                top.element_type = LayoutElementType.DOC_TITLE


def _escape(text: Optional[str]) -> str:
    return ((text or "").replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _strip_html_wrapper(html: str) -> str:
    inner = html
    for tag in ("<html>", "</html>", "<body>", "</body>"):
        inner = inner.replace(tag, "")
    return inner.strip()

"""Source-aware matching from StructureResult candidates to benchmark
target regions (OmniDocBench-style evaluation).

Re-expresses oar-ocr-vl/examples/utils/structure_match.rs:1-197. Two-pass
policy per target region:

1. same-category pass — only candidates whose ``semantic_category``
   matches the target's, at the relaxed ``same_category_iou`` floor (the
   category pre-filter bounds poisoning risk, so the lower IoU is safe);
2. cross-category fallback — any candidate at the strict
   ``cross_category_iou`` floor ("max IoU wins" safety net for
   mis-typed regions).

Tables and formulas are pre-typed by the structure pipeline so they match
directly against table HTML / formula LaTeX at the same-category
threshold, optionally falling back to generic layout text when
``allow_generic_fallback`` is set. Targets whose category is "region" or
"other" skip the same-category pass (no useful signal); Image / Chart
targets never match (structure_match.rs:62-68).

The port's copy of ``oar_ocr_tpu/utils/structure_match.py`` (:1-148),
line for line; only this paragraph is new.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..domain.structure import (LayoutElement, LayoutElementType,
                                StructureResult)


@dataclass(frozen=True)
class MatchThresholds:
    """IoU floors for the two passes (structure_match.rs:28-47)."""

    same_category_iou: float = 0.5
    cross_category_iou: float = 0.7
    allow_generic_fallback: bool = False


@dataclass
class StructureMatch:
    """One matched candidate (structure_match.rs:49-54)."""

    source: str                 # "layout" | "table" | "formula"
    text: str
    iou: float
    same_category: bool


def _iou(a, b) -> float:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    union = ((ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0)
             - inter)
    return inter / union if union > 0 else 0.0


def match_region(result: StructureResult, target_box,
                 target_type: LayoutElementType,
                 th: MatchThresholds = MatchThresholds()
                 ) -> Optional[StructureMatch]:
    """Match one benchmark target region against ``result``'s candidates
    (structure_match.rs:56-70 dispatch)."""
    T = LayoutElementType
    target_box = tuple(np.asarray(target_box, np.float32).reshape(4))
    if target_type == T.TABLE:
        return _best_table(result, target_box, th)
    if target_type in (T.CHART, T.IMAGE, T.HEADER_IMAGE, T.FOOTER_IMAGE):
        return None
    if target_type.is_formula:
        return _best_formula(result, target_box, th)
    return _best_layout(result, target_box, target_type, th)


def _candidates(result: StructureResult) -> Sequence[LayoutElement]:
    return result.elements


def _best_layout(result, target_box, target_type, th
                 ) -> Optional[StructureMatch]:
    target_cat = target_type.semantic_category
    if target_cat not in ("region", "other"):
        best = None
        for c in _candidates(result):
            text = (c.text or "").strip()
            if not text:
                continue
            if c.element_type.semantic_category != target_cat:
                continue
            iou = _iou(target_box, c.xyxy)
            if iou >= th.same_category_iou and (
                    best is None or iou > best[0]):
                best = (iou, text)
        if best is not None:
            return StructureMatch("layout", best[1], best[0], True)

    best = None
    for c in _candidates(result):
        text = (c.text or "").strip()
        if not text:
            continue
        iou = _iou(target_box, c.xyxy)
        if iou >= th.cross_category_iou and (best is None or iou > best[0]):
            best = (iou, text)
    if best is not None:
        return StructureMatch("layout", best[1], best[0], False)
    return None


def _best_table(result, target_box, th) -> Optional[StructureMatch]:
    best = None
    for c in _candidates(result):
        if c.element_type != LayoutElementType.TABLE or c.table is None:
            continue
        html = (c.table.html or "").strip()
        if not html:
            continue
        iou = _iou(target_box, c.xyxy)
        if iou >= th.same_category_iou and (best is None or iou > best[0]):
            best = (iou, html)
    if best is not None:
        return StructureMatch("table", best[1], best[0], True)
    if not th.allow_generic_fallback:
        return None
    return _best_layout(result, target_box, LayoutElementType.TABLE, th)


def _best_formula(result, target_box, th) -> Optional[StructureMatch]:
    best = None
    for c in _candidates(result):
        if not c.element_type.is_formula:
            continue
        latex = (c.formula_latex or "").strip()
        if not latex:
            continue
        iou = _iou(target_box, c.xyxy)
        if iou >= th.same_category_iou and (best is None or iou > best[0]):
            best = (iou, latex)
    if best is not None:
        return StructureMatch("formula", best[1], best[0], True)
    if not th.allow_generic_fallback:
        return None
    return _best_layout(result, target_box, LayoutElementType.FORMULA, th)

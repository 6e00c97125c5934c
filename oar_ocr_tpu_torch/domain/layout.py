"""Layout model variants: label maps, input sizes, preprocessing.

Re-expresses the variant registry of the reference's LayoutDetectionAdapter
(oar-ocr-core/src/domain/adapters/layout_detection_adapter.rs:24-470 —
model-type dispatch picodet / rtdetr / pp-doclayout, per-variant class
label tables and input sizes) plus the layout element taxonomy
(domain/structure.rs:1983 LayoutElementType, ~40 labels; should_ocr
:2274).

The port's copy of ``oar_ocr_tpu/domain/layout.py`` (:1-144), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

_17CLS = ["paragraph_title", "image", "text", "number", "abstract",
          "content", "figure_title", "formula", "table", "table_title",
          "reference", "doc_title", "footnote", "header", "algorithm",
          "footer", "seal"]

_DOCLAYOUT_23 = _17CLS + ["chart_title", "chart", "formula_number",
                          "header_image", "footer_image", "aside_text"]

_DOCLAYOUT_PLUS_20 = ["paragraph_title", "image", "text", "number",
                      "abstract", "content", "figure_title", "formula",
                      "table", "reference", "doc_title", "footnote",
                      "header", "algorithm", "footer", "seal", "chart",
                      "formula_number", "aside_text", "reference_content"]

_DOCLAYOUT_V2_25 = ["abstract", "algorithm", "aside_text", "chart",
                    "content", "display_formula", "doc_title",
                    "figure_title", "footer", "footer_image", "footnote",
                    "formula_number", "header", "header_image", "image",
                    "inline_formula", "number", "paragraph_title",
                    "reference", "reference_content", "seal", "table",
                    "text", "vertical_text", "vision_footnote"]


@dataclass(frozen=True)
class LayoutVariant:
    """One deployable layout model configuration."""

    name: str
    model_type: str                 # picodet | rtdetr | pp-doclayout
    labels: Tuple[str, ...]
    input_hw: Tuple[int, int]
    # preprocessing (scale_aware_detector.rs:55-80)
    bgr: bool = False
    imagenet_norm: bool = True      # else mean 0 / std 1 (scale only)
    # actual network inside the deploy graph: "picodet" or "rtdetr-{L,X}"
    # (PP-DocLayout-S is PicoDet-S; -M is PicoDet-L; -L / plus-L / V2 / V3 /
    # BlockLayout are RT-DETR-L; the table-cell dets are RT-DETR-L)
    net: str = "picodet"
    # PicoDet dims (picodet_exact.PicoDetExact): (LCNet width scale,
    # CSP-PAN out channels, PicoFeat conv count). 1x follows
    # picodet_lcnet_x1_0_layout.yml exactly; -S/-L follow the published
    # PicoDet-S/L recipes — conversion validates against the real
    # checkpoint config (docs/ROADMAP.md exactness inventory).
    picodet_dims: Tuple[float, int, int] = (1.0, 128, 4)

    @property
    def num_classes(self) -> int:
        return len(self.labels)


LAYOUT_VARIANTS: Dict[str, LayoutVariant] = {
    v.name: v for v in [
        LayoutVariant("picodet_layout_1x", "picodet",
                      ("text", "title", "list", "table", "figure"),
                      (800, 608), bgr=True),
        LayoutVariant("picodet_layout_1x_table", "picodet",
                      ("table",), (800, 608), bgr=True),
        LayoutVariant("picodet-s_layout_3cls", "picodet",
                      ("image", "table", "seal"), (480, 480), bgr=True,
                      picodet_dims=(0.75, 96, 2)),
        LayoutVariant("picodet-l_layout_3cls", "picodet",
                      ("image", "table", "seal"), (640, 640), bgr=True,
                      picodet_dims=(2.0, 160, 4)),
        LayoutVariant("picodet-s_layout_17cls", "picodet",
                      tuple(_17CLS), (480, 480), bgr=True,
                      picodet_dims=(0.75, 96, 2)),
        LayoutVariant("picodet-l_layout_17cls", "picodet",
                      tuple(_17CLS), (640, 640), bgr=True,
                      picodet_dims=(2.0, 160, 4)),
        LayoutVariant("rt-detr-h_layout_3cls", "rtdetr",
                      ("figure", "table", "seal"), (640, 640), net="rtdetr-X"),
        LayoutVariant("rt-detr-h_layout_17cls", "rtdetr",
                      tuple(_17CLS), (640, 640), net="rtdetr-X"),
        LayoutVariant("pp-docblocklayout", "pp-doclayout",
                      ("region",), (640, 640), imagenet_norm=False,
                      net="rtdetr-L"),
        LayoutVariant("pp-doclayout-s", "pp-doclayout",
                      tuple(_DOCLAYOUT_23), (480, 480), imagenet_norm=False,
                      picodet_dims=(0.75, 96, 2)),
        LayoutVariant("pp-doclayout-m", "pp-doclayout",
                      tuple(_DOCLAYOUT_23), (640, 640), imagenet_norm=False,
                      picodet_dims=(2.0, 160, 4)),
        LayoutVariant("pp-doclayout-l", "pp-doclayout",
                      tuple(_DOCLAYOUT_23), (800, 800), imagenet_norm=False,
                      net="rtdetr-L"),
        LayoutVariant("pp-doclayout_plus-l", "pp-doclayout",
                      tuple(_DOCLAYOUT_PLUS_20), (800, 800),
                      imagenet_norm=False, net="rtdetr-L"),
        LayoutVariant("pp-doclayoutv2", "pp-doclayout",
                      tuple(_DOCLAYOUT_V2_25), (800, 800),
                      imagenet_norm=False, net="rtdetr-L"),
        LayoutVariant("pp-doclayoutv3", "pp-doclayout",
                      tuple(_DOCLAYOUT_V2_25), (800, 800),
                      imagenet_norm=False, net="rtdetr-L"),
        # table cell detectors (task TableCellDetection; RT-DETR based)
        LayoutVariant("rt-detr-l_wired_table_cell_det", "rtdetr",
                      ("cell",), (640, 640), net="rtdetr-L"),
        LayoutVariant("rt-detr-l_wireless_table_cell_det", "rtdetr",
                      ("cell",), (640, 640), net="rtdetr-L"),
    ]
}

# Labels whose regions get OCR'd during structure analysis
# (domain/structure.rs:2274 should_ocr — tables/images/seals/formulas are
# handled by their own subsystems).
NO_OCR_LABELS = frozenset({
    "table", "image", "figure", "seal", "formula", "display_formula",
    "inline_formula", "chart", "header_image", "footer_image", "region",
})


@dataclass
class LayoutBox:
    """One detected layout element (pre-stitching)."""

    label: str
    score: float
    box: np.ndarray               # (4,) xyxy in page coords
    order_index: Optional[float] = None   # V2 pointer-network reading order

    @property
    def xyxy(self) -> Tuple[float, float, float, float]:
        b = self.box
        return float(b[0]), float(b[1]), float(b[2]), float(b[3])

    def should_ocr(self) -> bool:
        return self.label not in NO_OCR_LABELS

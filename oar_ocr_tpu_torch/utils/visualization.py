"""Annotated visualization — the examples' visualization.rs analog.

Re-expresses examples/utils/visualization.rs (DetectionVisConfig, corner
markers, labeled boxes, side-by-side text panels) with cv2 primitives:

- ``draw_detections``: boxes/polygons + score/label captions with the
  config knobs of DetectionVisConfig (:80-124);
- ``draw_ocr_canvas``: the classic annotated-page + text-panel pair the
  reference's ocr example saves (examples/ocr.rs:188);
- ``draw_layout``: per-label colors + reading-order indices for
  layout/structure results;
- ``draw_structure``: one call for a StructureResult page.

The port's copy of ``oar_ocr_tpu/utils/visualization.py`` (:1-150), line
for line; only this paragraph is new.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np


def _cv2():
    import cv2
    return cv2


@dataclass
class DetectionVisConfig:
    """visualization.rs DetectionVisConfig."""

    box_color: Tuple[int, int, int] = (0, 200, 0)
    label_color: Tuple[int, int, int] = (220, 0, 0)
    font_scale: float = 0.5
    thickness: int = 2
    draw_corners: bool = True
    draw_polygon: bool = True


@dataclass
class Detection:
    """One box to draw (visualization.rs Detection)."""

    box: np.ndarray                   # (N≥2, 2) polygon or (4,) xyxy
    score: Optional[float] = None
    label: Optional[str] = None


def _as_poly(box: np.ndarray) -> np.ndarray:
    b = np.asarray(box, np.float32)
    if b.ndim == 1:                   # xyxy
        x0, y0, x1, y1 = b[:4]
        b = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)
    return np.round(b.reshape(-1, 2)).astype(np.int32)


def draw_detections(img: np.ndarray, detections: Sequence[Detection],
                    cfg: Optional[DetectionVisConfig] = None) -> np.ndarray:
    cv2 = _cv2()
    cfg = cfg or DetectionVisConfig()
    out = np.ascontiguousarray(img.copy())
    for det in detections:
        pts = _as_poly(det.box)
        if cfg.draw_polygon:
            cv2.polylines(out, [pts], True, cfg.box_color, cfg.thickness)
        if cfg.draw_corners:
            for p in pts:
                cv2.circle(out, tuple(p), cfg.thickness + 2,
                           cfg.box_color, -1)
        caption = ""
        if det.label:
            caption = det.label
        if det.score is not None:
            caption = (caption + f" {det.score:.2f}").strip()
        if caption:
            cv2.putText(out, caption[:48], tuple(pts[0] + (0, -4)),
                        cv2.FONT_HERSHEY_SIMPLEX, cfg.font_scale,
                        cfg.label_color, 1, cv2.LINE_AA)
    return out


def draw_ocr_canvas(img: np.ndarray, boxes: Sequence[np.ndarray],
                    texts: Sequence[str],
                    scores: Optional[Sequence[float]] = None) -> np.ndarray:
    """Side-by-side canvas: annotated page left, recognized text panel
    right (examples/ocr.rs output layout)."""
    cv2 = _cv2()
    left = draw_detections(
        img, [Detection(b, None if scores is None else scores[i])
              for i, b in enumerate(boxes)])
    h, w = img.shape[:2]
    panel = np.full((h, max(320, w // 2), 3), 255, np.uint8)
    y = 24
    for i, t in enumerate(texts):
        line = f"{i + 1}. {t}"
        cv2.putText(panel, line[:60], (8, y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.45, (20, 20, 20), 1, cv2.LINE_AA)
        y += 20
        if y > h - 8:
            break
    return np.concatenate([left, panel], axis=1)


# stable per-label colors (hash → hue)
def _label_color(label: str) -> Tuple[int, int, int]:
    cv2 = _cv2()
    hue = (hash(label) % 180 + 180) % 180
    hsv = np.uint8([[[hue, 200, 230]]])
    b, g, r = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0, 0]
    return int(b), int(g), int(r)


def draw_layout(img: np.ndarray, boxes, *, show_order: bool = True
                ) -> np.ndarray:
    """Layout elements colored per label with optional reading-order
    indices (structure example output)."""
    cv2 = _cv2()
    out = np.ascontiguousarray(img.copy())
    for i, lb in enumerate(boxes):
        label = getattr(lb, "label", None)
        if label is None:
            et = getattr(lb, "element_type", None)
            label = et.value if et is not None else "region"
        color = _label_color(label)
        x0, y0, x1, y1 = [int(round(v)) for v in np.asarray(
            getattr(lb, "box", lb), np.float32)[:4]]
        cv2.rectangle(out, (x0, y0), (x1, y1), color, 2)
        caption = f"{i if show_order else ''} {label}".strip()
        score = getattr(lb, "score", None)
        if score is not None:
            caption += f" {score:.2f}"
        cv2.rectangle(out, (x0, max(0, y0 - 18)),
                      (x0 + 8 * len(caption), y0), color, -1)
        cv2.putText(out, caption, (x0 + 2, max(10, y0 - 5)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1,
                    cv2.LINE_AA)
    return out


def draw_structure(img: np.ndarray, result) -> np.ndarray:
    """Annotated StructureResult page (domain/structure.py): elements by
    type, reading order as indices."""
    elements = getattr(result, "elements", None) or []
    return draw_layout(img, elements, show_order=True)


def save_image(path: str, img: np.ndarray) -> None:
    cv2 = _cv2()
    if not cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img):
        raise IOError(f"failed to write {path}")

"""The OCR pipeline's result types.

Copied value for value from ``oar_ocr_tpu/domain/text_region.py:16-120``
(``TextRegion``, ``OAROCRResult``), fields and accessors alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class TextRegion:
    """One detected + recognized text region."""

    box: np.ndarray                      # (4,2) quad or (N,2) poly, image coords
    text: Optional[str] = None
    confidence: Optional[float] = None
    det_score: Optional[float] = None
    orientation_angle: Optional[int] = None   # 0 or 180 (line orientation)
    word_boxes: Optional[List[np.ndarray]] = None
    word_texts: Optional[List[str]] = None
    label: Optional[str] = None          # "formula" marks injected formula spans

    @property
    def is_formula(self) -> bool:
        return self.label == "formula"

    @property
    def xyxy(self):
        b = np.asarray(self.box, np.float32).reshape(-1, 2)
        return (float(b[:, 0].min()), float(b[:, 1].min()),
                float(b[:, 0].max()), float(b[:, 1].max()))

    def to_dict(self) -> dict:
        return {
            "box": np.asarray(self.box).tolist(),
            "text": self.text,
            "confidence": self.confidence,
            "det_score": self.det_score,
            "orientation_angle": self.orientation_angle,
            "word_boxes": [np.asarray(b).tolist() for b in self.word_boxes]
            if self.word_boxes else None,
            "word_texts": self.word_texts,
        }


@dataclass
class OAROCRResult:
    """Full-pipeline result for one input image."""

    regions: List[TextRegion] = field(default_factory=list)
    source_path: Optional[str] = None
    width: int = 0
    height: int = 0
    orientation_angle: Optional[int] = None   # applied doc rotation
    rectified: bool = False
    error: Optional[str] = None

    @property
    def texts(self) -> List[str]:
        return [r.text or "" for r in self.regions]

    def recognized_text_regions(self) -> List[TextRegion]:
        """Regions that carry a recognition result (an empty recognized
        string still counts)."""
        return [r for r in self.regions if r.text is not None]

    def confident_text_regions(self) -> List[TextRegion]:
        """Regions with both text and a confidence score."""
        return [r for r in self.regions
                if r.text is not None and r.confidence is not None]

    def all_text(self) -> List[str]:
        """All recognized text strings."""
        return [r.text for r in self.regions if r.text is not None]

    def concatenated_text(self, separator: str = "\n") -> str:
        """Recognized text joined with ``separator``."""
        return separator.join(self.all_text())

    def recognized_text_count(self) -> int:
        return len(self.recognized_text_regions())

    def average_confidence(self) -> Optional[float]:
        """Mean confidence over confident regions; None if none."""
        regions = self.confident_text_regions()
        if not regions:
            return None
        return sum(r.confidence for r in regions) / len(regions)

    def __str__(self) -> str:
        lines = [f"Input path: {self.source_path or '<memory>'}",
                 f"Image dimensions: [{self.width}, {self.height}]",
                 f"Text regions: {len(self.regions)}"]
        for i, r in enumerate(self.regions):
            conf = (f" ({r.confidence:.3f})"
                    if r.confidence is not None else "")
            lines.append(f"  {i}: {r.text!r}{conf}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "source_path": self.source_path,
            "width": self.width,
            "height": self.height,
            "orientation_angle": self.orientation_angle,
            "rectified": self.rectified,
            "error": self.error,
            "regions": [r.to_dict() for r in self.regions],
        }

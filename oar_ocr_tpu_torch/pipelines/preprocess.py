"""Document preprocessing chain: orientation → rotation → rectification.

Counterpart of ``oar_ocr_tpu/pipelines/preprocess.py``: classify each
page's orientation (4 classes) on its device upload, rotate the page
upright on the host, optionally rectify it with UVDoc. Carries the
back-mapping metadata (``OrientationCorrection``) with the invariant
that results cannot be mapped back once rectification ran.

``OrientationCorrection``, ``PreprocessedPage`` and ``rotate_image`` are
host copies (``preprocess.py:27-57``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..core.types import Rotation
from ..models.classification.pp_lcnet import (ImageClassifier,
                                              doc_orientation_classifier)
from ..models.rectification.uvdoc import UVDocRectifier
from ..runtime.runtime import DET_SIDE_BUCKETS, Runtime
from ..utils.tracing import stage_timer


@dataclass
class OrientationCorrection:
    """Rotation applied to upright the page.

    ``angle`` is the detected orientation class in degrees (the amount the
    original was rotated by); uprighting rotates by -angle. ``rotated_w/h``
    are the dimensions of the corrected image."""

    angle: int
    rotated_w: int
    rotated_h: int


@dataclass
class PreprocessedPage:
    image: np.ndarray
    orientation: Optional[OrientationCorrection] = None
    rectified: bool = False

    @property
    def can_map_back(self) -> bool:
        """Geometry can be mapped to the ORIGINAL input only if no
        rectification happened."""
        return not self.rectified


def rotate_image(image: np.ndarray, angle_ccw: int) -> np.ndarray:
    """Rotate an HWC image by a multiple of 90° CCW."""
    k = (angle_ccw // 90) % 4
    return np.ascontiguousarray(np.rot90(image, k))


class DocumentPreprocessor:
    """Orientation + rectification chain over host images."""

    def __init__(self, *,
                 orientation: Optional[ImageClassifier] = None,
                 rectifier: Optional[UVDocRectifier] = None,
                 use_orientation: bool = True,
                 use_rectification: bool = False,
                 runtime: Optional[Runtime] = None):
        self.runtime = runtime or Runtime()
        self.orientation = (orientation or doc_orientation_classifier(
            runtime=self.runtime)) if use_orientation else None
        self.rectifier = (rectifier or UVDocRectifier(
            runtime=self.runtime)) if use_rectification else None

    def preprocess(self, images: Sequence[np.ndarray]) -> List[PreprocessedPage]:
        pages = [PreprocessedPage(image=img) for img in images]

        if self.orientation is not None and images:
            shapes = [img.shape[:2] for img in images]
            bh = DET_SIDE_BUCKETS.bucket(max(s[0] for s in shapes))
            bw = DET_SIDE_BUCKETS.bucket(max(s[1] for s in shapes))
            with stage_timer("preprocess.orientation", batch=len(images)):
                dev = self.runtime.put_pages(list(images), (bh, bw))
                results = self.orientation.classify_pages(dev, shapes)
            for page, (cls, _score) in zip(pages, results):
                angle = int(Rotation.from_class(cls))
                if angle != 0:
                    # label k·90 uprights by rotating +angle CCW
                    # (PaddleX's np.rot90(img, k=angle//90))
                    page.image = rotate_image(page.image, angle)
                h, w = page.image.shape[:2]
                page.orientation = OrientationCorrection(angle, w, h)

        if self.rectifier is not None:
            for page in pages:
                with stage_timer("preprocess.rectify"):
                    page.image = self.rectifier.rectify(page.image)
                page.rectified = True

        return pages

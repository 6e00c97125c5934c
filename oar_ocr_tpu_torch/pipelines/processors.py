"""Edge processors: composable pre/post transforms.

Re-expresses oar-ocr/src/oarocr/processors.rs:80-256 —
``TextCroppingProcessor`` (crop detected regions), ``ImageRotationProcessor``
(rotate by a class-derived angle), ``ChainProcessor`` (compose). In the TPU
build the hot pipeline crops on device (ops/warp), so these host processors
serve the standalone/composable API surface.

The port's copy of ``oar_ocr_tpu/pipelines/processors.py`` (:1-61), line
for line; only this paragraph is new.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import cv2
import numpy as np

from ..processors.geometry import order_quad_points
from ..ops.warp import crop_geometry


class TextCroppingProcessor:
    """Perspective-crop quads out of a host image (processors.rs:80;
    semantics of get_rotate_crop_image incl. the tall-crop rotation)."""

    def process(self, image: np.ndarray,
                quads: Sequence[np.ndarray]) -> List[np.ndarray]:
        crops = []
        for quad in quads:
            q = order_quad_points(np.asarray(quad, np.float32))
            cw, ch, rot = crop_geometry(q)
            dst = np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]], np.float32)
            m = cv2.getPerspectiveTransform(q, dst)
            crop = cv2.warpPerspective(image, m, (cw, ch))
            if rot:
                crop = np.ascontiguousarray(np.rot90(crop, 1))  # 90° CCW
            crops.append(crop)
        return crops


class ImageRotationProcessor:
    """Rotate an image by an orientation class (processors.rs:129)."""

    def __init__(self, angle_ccw: int):
        if angle_ccw % 90 != 0:
            raise ValueError("angle must be a multiple of 90")
        self.angle = angle_ccw % 360

    def process(self, image: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.rot90(image, self.angle // 90))


class ChainProcessor:
    """Compose single-image processors (processors.rs:190)."""

    def __init__(self, *stages: Callable[[np.ndarray], np.ndarray]):
        self.stages = stages

    def process(self, image: np.ndarray) -> np.ndarray:
        for stage in self.stages:
            image = stage(image)
        return image

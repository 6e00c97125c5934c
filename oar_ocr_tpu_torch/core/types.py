"""Shared enums and small value types.

Re-expresses oar-ocr-core/src/processors/types.rs:11-135 (CropMode, LimitType,
TensorLayout, ColorOrder, BoxType, ScoreMode, ImageScaleInfo, ResizeType) as
Python enums/dataclasses. These flow through preprocessing configs and the
postprocessing geometry.

The port's copy of ``oar_ocr_tpu/core/types.py`` (:1-111), line for
line; only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class LimitType(enum.Enum):
    """How ``limit_side_len`` constrains detector input resizing.

    reference: processors/types.rs + resize_detection.rs:31-123.
    MAX: longest side must not exceed the limit (shrink only).
    MIN: shortest side must be at least the limit (grow only).
    RESIZE_LONG: longest side is scaled exactly to the limit.
    """

    MAX = "max"
    MIN = "min"
    RESIZE_LONG = "resize_long"


class ResizeType(enum.Enum):
    """Detector resize strategies (resize_detection.rs:31-65)."""

    TYPE0_LIMIT = 0          # limit_side_len + LimitType, round /32
    TYPE1_FIXED = 1          # fixed (h, w) target
    TYPE2_LONG_SIDE = 2      # scale so the long side == resize_long
    TYPE3_WIDTH_MULT = 3     # fixed h, width rounded to multiple of 32


class TensorLayout(enum.Enum):
    CHW = "chw"
    HWC = "hwc"


class ColorOrder(enum.Enum):
    RGB = "rgb"
    BGR = "bgr"


class BoxType(enum.Enum):
    """DB postprocess output geometry (db_postprocess.rs Quad/Poly)."""

    QUAD = "quad"
    POLY = "poly"


class ScoreMode(enum.Enum):
    """DB box scoring (db_postprocess.rs ScoreMode Fast/Slow).

    FAST scores the mean probability inside the box's axis-aligned bbox mask
    (db_score.rs:34 box_score_fast); SLOW scores inside the exact polygon.
    """

    FAST = "fast"
    SLOW = "slow"


class CropMode(enum.Enum):
    """Center-crop modes for classifier preprocessing (utils/crop.rs:13)."""

    CENTER = "center"
    TOP_LEFT = "top_left"


@dataclass(frozen=True)
class ImageScaleInfo:
    """Original vs. model-input geometry for mapping predictions back.

    reference: processors/types.rs ImageScaleInfo. ``ratio_h/ratio_w`` are
    resized/original ratios.
    """

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int

    @property
    def ratio_h(self) -> float:
        return self.dst_h / float(self.src_h)

    @property
    def ratio_w(self) -> float:
        return self.dst_w / float(self.src_w)


class Rotation(enum.IntEnum):
    """Document orientation classes → upright correction angle.

    reference: src/oarocr/preprocess.rs:111-149 — label k·90 uprights by
    rotating +k·90° CCW (PaddleX ``np.rot90(img, k)``; the reference's
    class1→rotate270 / class3→rotate90 in the image crate's CLOCKWISE
    naming are 90° CCW / 90° CW respectively).
    """

    DEG_0 = 0
    DEG_90 = 90
    DEG_180 = 180
    DEG_270 = 270

    @classmethod
    def from_class(cls, class_id: int) -> "Rotation":
        return {0: cls.DEG_0, 1: cls.DEG_90, 2: cls.DEG_180, 3: cls.DEG_270}[class_id]

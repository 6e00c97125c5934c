"""Shared enums of the detection configs.

Copied value for value from ``oar_ocr_tpu/core/types.py``: ``LimitType``
(:15-26), ``BoxType`` and ``ScoreMode`` (:48-63), ``Rotation`` (:95-111).
"""

from __future__ import annotations

import enum


class LimitType(enum.Enum):
    """How ``limit_side_len`` constrains detector input resizing.

    MAX: longest side must not exceed the limit (shrink only).
    MIN: shortest side must be at least the limit (grow only).
    RESIZE_LONG: longest side is scaled exactly to the limit.
    """

    MAX = "max"
    MIN = "min"
    RESIZE_LONG = "resize_long"


class BoxType(enum.Enum):
    """DB postprocess output geometry."""

    QUAD = "quad"
    POLY = "poly"


class ScoreMode(enum.Enum):
    """DB box scoring: FAST scores the mean probability inside the box,
    SLOW inside the exact polygon."""

    FAST = "fast"
    SLOW = "slow"


class Rotation(enum.IntEnum):
    """Document orientation classes → upright correction angle: label
    k·90 uprights by rotating +k·90° counter-clockwise (PaddleX
    ``np.rot90(img, k)``)."""

    DEG_0 = 0
    DEG_90 = 90
    DEG_180 = 180
    DEG_270 = 270

    @classmethod
    def from_class(cls, class_id: int) -> "Rotation":
        return {0: cls.DEG_0, 1: cls.DEG_90, 2: cls.DEG_180, 3: cls.DEG_270}[class_id]

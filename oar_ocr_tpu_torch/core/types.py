"""Shared enums of the detection configs.

Copied value for value from ``oar_ocr_tpu/core/types.py``: ``LimitType``
(:15-26), ``BoxType`` and ``ScoreMode`` (:48-63).
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

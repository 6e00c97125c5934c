"""Detector resize planning.

Copied value for value from ``oar_ocr_tpu/ops/resize.py:31-70``
(``DetResizeConfig``, ``det_target_size``), with its float32 ratio math.
The port resizes on the device (``ops/det_device.py``), so the host
resize execution of that module is not copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core.constants import DET_LIMIT_SIDE_LEN, DET_MAX_SIDE_LEN
from ..core.types import LimitType


@dataclass(frozen=True)
class DetResizeConfig:
    """Type0 resize parameters."""

    limit_side_len: int = DET_LIMIT_SIDE_LEN
    limit_type: LimitType = LimitType.MAX
    max_side_limit: int = DET_MAX_SIDE_LEN


def det_target_size(h: int, w: int, cfg: DetResizeConfig) -> Tuple[int, int]:
    """Target (h, w) for the Type0 det resize: ratio by limit type,
    max-side clamp, then round-to-nearest multiple of 32 via
    (x+16)//32*32 with a 32 floor."""
    # All ratio math in f32: f64 can differ by 1 px near integer
    # boundaries, which the +16 rounding then amplifies to a whole
    # 32-px bucket.
    f32 = np.float32
    lt = cfg.limit_type
    if lt == LimitType.MAX:
        ratio = (f32(cfg.limit_side_len) / f32(max(h, w))
                 if max(h, w) > cfg.limit_side_len else f32(1.0))
    elif lt == LimitType.MIN:
        ratio = (f32(cfg.limit_side_len) / f32(min(h, w))
                 if min(h, w) < cfg.limit_side_len else f32(1.0))
    else:  # RESIZE_LONG
        ratio = f32(cfg.limit_side_len) / f32(max(h, w))

    resize_h = int(f32(h) * ratio)
    resize_w = int(f32(w) * ratio)
    if max(resize_h, resize_w) > cfg.max_side_limit:
        lr = f32(cfg.max_side_limit) / f32(max(resize_h, resize_w))
        resize_h = int(f32(resize_h) * lr)
        resize_w = int(f32(resize_w) * lr)
    resize_h = max((resize_h + 16) // 32 * 32, 32)
    resize_w = max((resize_w + 16) // 32 * 32, 32)
    return resize_h, resize_w

"""VLM image processing: smart resize, the HunyuanOCR token limit and
clamp, and the Spotting preprocess plan.

Counterpart of ``oar_ocr_tpu/vl/processing.py:19-120``, copied value for
value (the port imports nothing of the JAX package).

``smart_resize`` rounds H/W to multiples of factor = patch·merge, shrinks
an image whose area exceeds ``max_pixels`` (flooring to the factor) and
grows one under ``min_pixels`` (ceiling to it); aspect ratios above 200
are refused. HunyuanOCR's V1 preprocess then applies
``smart_resize_token_limited`` and ``clamp_to_max_image_size``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

from ..errors import InvalidInputError

# Spotting preprocess constants (paddleocr_vl/model.rs:55-56)
SPOTTING_UPSCALE_THRESHOLD = 1500
SPOTTING_MAX_LONG_SIDE = 2048


@dataclass(frozen=True)
class VisionProcessorConfig:
    patch_size: int = 14
    merge_size: int = 2
    min_pixels: int = 56 * 56
    max_pixels: int = 28 * 28 * 1280

    @property
    def factor(self) -> int:
        return self.patch_size * self.merge_size


def smart_resize(h: int, w: int, cfg: VisionProcessorConfig
                 ) -> Tuple[int, int]:
    """Target (h, w) for the vision encoder (``processing.py:31-49``)."""
    if max(h, w) / max(min(h, w), 1) > 200:
        raise InvalidInputError("aspect ratio > 200 unsupported", h=h, w=w)
    factor = cfg.factor
    hb = max(factor, round(h / factor) * factor)
    wb = max(factor, round(w / factor) * factor)
    if hb * wb > cfg.max_pixels:
        beta = math.sqrt((h * w) / cfg.max_pixels)
        hb = max(factor, math.floor(h / beta / factor) * factor)
        wb = max(factor, math.floor(w / beta / factor) * factor)
    elif hb * wb < cfg.min_pixels:
        beta = math.sqrt(cfg.min_pixels / (h * w))
        hb = math.ceil(h * beta / factor) * factor
        wb = math.ceil(w * beta / factor) * factor
    return hb, wb


def smart_resize_token_limited(h: int, w: int, cfg: VisionProcessorConfig,
                               max_tokens: int) -> Tuple[int, int]:
    """HunyuanOCR V1 resize (``processing.py:52-75``): smart_resize, then
    shrink the larger merged-grid axis one factor at a time until
    ``Hm·(Wm+1) ≤ max_tokens`` (the +1 is the per-row newline token)."""
    rh, rw = smart_resize(h, w, cfg)
    factor = cfg.factor
    while True:
        hm, wm = rh // factor, rw // factor
        if hm * (wm + 1) <= max_tokens:
            return rh, rw
        if wm >= hm:
            if rw <= factor:
                raise InvalidInputError(
                    "cannot satisfy img_max_token_num", h=h, w=w,
                    max_tokens=max_tokens)
            rw -= factor
        else:
            if rh <= factor:
                raise InvalidInputError(
                    "cannot satisfy img_max_token_num", h=h, w=w,
                    max_tokens=max_tokens)
            rh -= factor


def clamp_to_max_image_size(h: int, w: int, factor: int,
                            max_image_size: int) -> Tuple[int, int]:
    """Scale (h, w) down so the longer side fits ``max_image_size``,
    flooring to factor multiples with a factor floor
    (``processing.py:78-91``)."""
    if factor <= 0 or max_image_size < factor:
        raise InvalidInputError("bad clamp config", factor=factor,
                                max_image_size=max_image_size)
    if max(h, w) <= max_image_size:
        return h, w
    scale = max_image_size / max(h, w)
    nh = int(math.floor(h * scale / factor) * factor)
    nw = int(math.floor(w * scale / factor) * factor)
    return max(nh, factor), max(nw, factor)


def spotting_preprocess_plan(h: int, w: int, cfg: VisionProcessorConfig
                             ) -> Tuple[Tuple[int, int],
                                        VisionProcessorConfig]:
    """The Spotting task's preprocess deltas (``processing.py:99-120``):
    a page with BOTH sides under SPOTTING_UPSCALE_THRESHOLD is first
    upscaled 2× (Lanczos), and ``max_pixels`` widens to
    max(cfg.max_pixels, SPOTTING_MAX_LONG_SIDE·factor²). Returns
    ((pre-resize h, w), the widened config)."""
    if h < SPOTTING_UPSCALE_THRESHOLD and w < SPOTTING_UPSCALE_THRESHOLD:
        h, w = h * 2, w * 2
    factor = cfg.factor
    widened = dataclasses.replace(cfg, max_pixels=max(
        cfg.max_pixels, SPOTTING_MAX_LONG_SIDE * factor * factor))
    return (h, w), widened

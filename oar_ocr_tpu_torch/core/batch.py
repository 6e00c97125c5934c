"""Dynamic batching: grouping variable-size inputs into compatible batches.

Re-expresses the reference's public dynamic-batching API
(oar-ocr-core/src/core/batch/dynamic/processor.rs:10-38, config.rs:7-121 —
`DynamicBatcher`, `ShapeCompatibilityStrategy` Exact/AspectRatio/
MaxDimension/Custom, `PaddingStrategy` Zero/Center/Edge/Smart — and
`AspectRatioBucketing`, processors/aspect_ratio_bucketing.rs:15-147).

In the TPU pipeline this machinery is the host-side planner that feeds
fixed-shape jit entries (SURVEY §2.1 calls it "the core of the TPU
dynamic-shape strategy"): group images whose padded shapes can share one
compiled executable, then pad each group to its bucket.

The port's copy of ``oar_ocr_tpu/core/batch.py`` (:1-185), line for
line; only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config.runtime import BucketTable


class ShapeCompatibilityStrategy(enum.Enum):
    EXACT = "exact"                 # identical shapes only
    ASPECT_RATIO = "aspect_ratio"   # similar w/h ratio
    MAX_DIMENSION = "max_dimension" # same padded bucket
    CUSTOM = "custom"


class PaddingStrategy(enum.Enum):
    ZERO = "zero"          # pad bottom/right with 0
    CENTER = "center"      # center content, pad border
    EDGE = "edge"          # replicate edge pixels
    SMART = "smart"        # edge for photos, zero for binary-ish content


@dataclass(frozen=True)
class AspectRatioBucket:
    """One named bucket (aspect_ratio_bucketing.rs defaults :40-77)."""

    name: str
    height: int
    width: int

    @property
    def ratio(self) -> float:
        return self.width / self.height


DEFAULT_ASPECT_BUCKETS: Tuple[AspectRatioBucket, ...] = (
    AspectRatioBucket("tall", 64, 32),
    AspectRatioBucket("square", 48, 48),
    AspectRatioBucket("wide", 48, 96),
    AspectRatioBucket("very_wide", 40, 160),
    AspectRatioBucket("ultra_wide", 32, 320),
)


@dataclass
class DynamicBatcherConfig:
    strategy: ShapeCompatibilityStrategy = ShapeCompatibilityStrategy.MAX_DIMENSION
    padding: PaddingStrategy = PaddingStrategy.ZERO
    max_batch_size: int = 32
    ratio_tolerance: float = 0.25          # ASPECT_RATIO grouping window
    side_buckets: BucketTable = field(
        default_factory=lambda: BucketTable((64, 128, 256, 512, 1024, 2048)))
    custom_key: Optional[Callable[[Tuple[int, int]], object]] = None


@dataclass
class DynamicBatch:
    indices: List[int]
    target_hw: Tuple[int, int]
    images: np.ndarray                     # (N, H, W, C) padded
    offsets: List[Tuple[int, int]]         # content (y, x) inside each slot


class DynamicBatcher:
    """Group + pad variable-size images into jit-compatible batches."""

    def __init__(self, cfg: DynamicBatcherConfig = DynamicBatcherConfig()):
        self.cfg = cfg

    # ------------------------ grouping ------------------------
    def group(self, shapes: Sequence[Tuple[int, int]]) -> List[List[int]]:
        cfg = self.cfg
        keys: Dict[object, List[int]] = {}
        for i, (h, w) in enumerate(shapes):
            if cfg.strategy == ShapeCompatibilityStrategy.EXACT:
                key = (h, w)
            elif cfg.strategy == ShapeCompatibilityStrategy.ASPECT_RATIO:
                ratio = w / max(h, 1)
                key = round(np.log(max(ratio, 1e-6))
                            / np.log1p(cfg.ratio_tolerance))
            elif cfg.strategy == ShapeCompatibilityStrategy.MAX_DIMENSION:
                key = (cfg.side_buckets.bucket(h), cfg.side_buckets.bucket(w))
            else:
                assert cfg.custom_key is not None, "CUSTOM needs custom_key"
                key = cfg.custom_key((h, w))
            keys.setdefault(key, []).append(i)
        out: List[List[int]] = []
        for members in keys.values():
            for s in range(0, len(members), cfg.max_batch_size):
                out.append(members[s : s + cfg.max_batch_size])
        return out

    # ------------------------ padding ------------------------
    def _pad_one(self, img: np.ndarray, th: int, tw: int
                 ) -> Tuple[np.ndarray, Tuple[int, int]]:
        h, w = img.shape[:2]
        cfg = self.cfg
        strategy = cfg.padding
        if strategy == PaddingStrategy.SMART:
            # binary-ish (few distinct values) → zero; photographic → edge
            sample = img[:: max(h // 16, 1), :: max(w // 16, 1)]
            strategy = (PaddingStrategy.ZERO
                        if len(np.unique(sample)) <= 16
                        else PaddingStrategy.EDGE)
        if strategy == PaddingStrategy.CENTER:
            oy, ox = (th - h) // 2, (tw - w) // 2
        else:
            oy, ox = 0, 0
        if strategy == PaddingStrategy.EDGE:
            out = np.pad(img, ((oy, th - h - oy), (ox, tw - w - ox), (0, 0)),
                         mode="edge")
        else:
            out = np.zeros((th, tw) + img.shape[2:], img.dtype)
            out[oy : oy + h, ox : ox + w] = img
        return out, (oy, ox)

    def batch(self, images: Sequence[np.ndarray]) -> List[DynamicBatch]:
        shapes = [im.shape[:2] for im in images]
        out = []
        for group in self.group(shapes):
            th = max(shapes[i][0] for i in group)
            tw = max(shapes[i][1] for i in group)
            if self.cfg.strategy == ShapeCompatibilityStrategy.MAX_DIMENSION:
                th = self.cfg.side_buckets.bucket(th)
                tw = self.cfg.side_buckets.bucket(tw)
            padded, offsets = [], []
            for i in group:
                p, off = self._pad_one(images[i], th, tw)
                padded.append(p)
                offsets.append(off)
            out.append(DynamicBatch(indices=list(group), target_hw=(th, tw),
                                    images=np.stack(padded), offsets=offsets))
        return out


class AspectRatioBucketing:
    """Named-bucket grouping + resize_and_pad for recognizer-style inputs
    (aspect_ratio_bucketing.rs:83-147)."""

    def __init__(self, buckets: Sequence[AspectRatioBucket] = DEFAULT_ASPECT_BUCKETS):
        self.buckets = sorted(buckets, key=lambda b: b.ratio)

    def bucket_for(self, h: int, w: int) -> AspectRatioBucket:
        ratio = w / max(h, 1)
        best = min(self.buckets, key=lambda b: abs(np.log(b.ratio)
                                                   - np.log(max(ratio, 1e-6))))
        return best

    def group(self, shapes: Sequence[Tuple[int, int]]
              ) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for i, (h, w) in enumerate(shapes):
            out.setdefault(self.bucket_for(h, w).name, []).append(i)
        return out

    def resize_and_pad(self, img: np.ndarray,
                       bucket: Optional[AspectRatioBucket] = None
                       ) -> np.ndarray:
        import cv2

        h, w = img.shape[:2]
        b = bucket or self.bucket_for(h, w)
        scale = min(b.height / h, b.width / w)
        nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
        r = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        out = np.zeros((b.height, b.width) + img.shape[2:], img.dtype)
        out[:nh, :nw] = r
        return out

"""Host image utilities: loading, padding, masking, visualization.

Re-expresses oar-ocr-core/src/utils/image.rs:27-551 (load / resize_and_pad
/ ocr_resize_and_pad / mask regions / batch loading with error policy) and
core/image_reader.rs on OpenCV+NumPy. Device-path resizes live in
ops/det_device.py; these helpers serve host-side workflows (CLI, masking,
debugging).

The port's copy of ``oar_ocr_tpu/utils/image.py`` (:1-128), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

from ..errors import ImageLoadError


def load_image(path: str) -> np.ndarray:
    """Read an image file → HWC uint8 RGB (image_reader.rs)."""
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise ImageLoadError("cannot read image", path=path)
    return np.ascontiguousarray(img[:, :, ::-1])


class BatchLoadPolicy(enum.Enum):
    """utils/image.rs batch loading policies."""

    FAIL_FAST = "fail_fast"
    SKIP_ERRORS = "skip_errors"


def load_images(paths: Sequence[str],
                policy: BatchLoadPolicy = BatchLoadPolicy.FAIL_FAST,
                *, parallel: Optional["ParallelPolicy"] = None
                ) -> Tuple[List[np.ndarray], List[str]]:
    """Load a batch; returns (images, loaded_paths).

    Decode is the one host stage worth threading (SURVEY §2.1 — the
    reference's global thread pool maps to "host threadpool for image
    decode only"); gated by ParallelPolicy like the reference gates rayon.
    """

    from ..config.runtime import ParallelPolicy

    parallel = parallel or ParallelPolicy()
    results: List[Optional[np.ndarray]] = [None] * len(paths)
    errors: List[Optional[Exception]] = [None] * len(paths)

    def _load(i: int):
        try:
            results[i] = load_image(paths[i])
        except ImageLoadError as e:
            errors[i] = e

    if len(paths) > 1 and parallel.max_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(parallel.max_workers, len(paths))) as pool:
            list(pool.map(_load, range(len(paths))))
    else:
        for i in range(len(paths)):
            _load(i)

    images, ok = [], []
    for i, p in enumerate(paths):
        if errors[i] is not None:
            if policy == BatchLoadPolicy.FAIL_FAST:
                raise errors[i]
            continue
        images.append(results[i])
        ok.append(p)
    return images, ok


def resize_and_pad(img: np.ndarray, target_h: int, target_w: int,
                   pad_value: int = 0) -> Tuple[np.ndarray, float]:
    """Aspect-preserving resize into a padded (target_h, target_w) canvas
    (utils/image.rs:439). Returns (canvas, scale)."""

    h, w = img.shape[:2]
    scale = min(target_h / h, target_w / w)
    nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((target_h, target_w) + img.shape[2:], pad_value, img.dtype)
    out[:nh, :nw] = resized
    return out, scale


def mask_regions(img: np.ndarray, boxes: Sequence[np.ndarray],
                 value: int = 255) -> np.ndarray:
    """Fill polygonal regions with a constant (utils/image.rs mask
    regions — used to hide already-processed elements)."""

    out = img.copy()
    for box in boxes:
        pts = np.round(np.asarray(box, np.float32).reshape(-1, 2)).astype(np.int32)
        cv2.fillPoly(out, [pts], (value,) * (img.shape[2] if img.ndim == 3 else 1))
    return out


def crop_bounding_box(img: np.ndarray, x0: float, y0: float,
                      x1: float, y1: float) -> np.ndarray:
    """Clamped AABB crop (utils/bbox_crop.rs:9 crop_bounding_box)."""
    h, w = img.shape[:2]
    xi0 = int(np.clip(np.floor(x0), 0, w - 1))
    yi0 = int(np.clip(np.floor(y0), 0, h - 1))
    xi1 = int(np.clip(np.ceil(x1), xi0 + 1, w))
    yi1 = int(np.clip(np.ceil(y1), yi0 + 1, h))
    return img[yi0:yi1, xi0:xi1]


def draw_ocr_results(img: np.ndarray, boxes: Sequence[np.ndarray],
                     texts: Optional[Sequence[str]] = None,
                     color=(255, 0, 0)) -> np.ndarray:
    """Simple visualization (the examples' utils/visualization analog)."""
    out = img.copy()
    for i, box in enumerate(boxes):
        pts = np.round(np.asarray(box, np.float32).reshape(-1, 2)).astype(np.int32)
        cv2.polylines(out, [pts], True, color, 2)
        if texts and i < len(texts) and texts[i]:
            cv2.putText(out, texts[i][:30], tuple(pts[0]),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return out

"""Static-shape bucket tables and the host parallelism policy.

The port's copies from ``oar_ocr_tpu/config/runtime.py``, line for line:
``BucketTable`` and ``pow2_buckets`` (:23-62; ``core/batch.py`` and
``runtime/runtime.py`` use them) and ``ParallelPolicy`` (:225-239;
``utils/image.load_images``). The rest of the module configures the TPU
mesh and imports jax; ``MeshConfig`` and ``RuntimeConfig`` are not ported
(ROADMAP item 11), and the port's device and its bucket tables are in
``runtime/runtime.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .validation import Rule


@dataclass(frozen=True)
class BucketTable:
    """Sorted static-shape buckets with recompile-on-miss semantics.

    Every distinct padded shape is one compiled executable; the table bounds
    the compile count while limiting padding waste. Replaces the reference's
    per-batch ad-hoc pad-to-max (core/batch/mod.rs:215-453) and
    ``AspectRatioBucketing`` (processors/aspect_ratio_bucketing.rs:15-147).
    """

    sizes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(sorted(set(int(s) for s in self.sizes))))
        if not self.sizes:
            raise ValueError("BucketTable needs at least one size")

    def bucket(self, value: int) -> int:
        """Smallest bucket >= value; the largest bucket if none fits."""
        for s in self.sizes:
            if value <= s:
                return s
        return self.sizes[-1]

    def bucket_index(self, value: int) -> int:
        for i, s in enumerate(self.sizes):
            if value <= s:
                return i
        return len(self.sizes) - 1


def pow2_buckets(lo: int, hi: int) -> BucketTable:
    """Power-of-two buckets in [lo, hi] (decoder_graph.rs:14 KV buckets)."""
    sizes = []
    s = lo
    while s < hi:
        sizes.append(s)
        s *= 2
    sizes.append(hi)
    return BucketTable(tuple(sizes))


@dataclass(frozen=True)
class ParallelPolicy:
    """Host-side parallelism thresholds (core/config/parallel.rs:11-27).

    The reference gates rayon by element counts; we gate the host thread pool
    used for image decode / geometry the same way.
    """

    min_elements: int = 1 << 20  # ~1 MiB of pixels before threading
    max_workers: int = 8

    RULES = {
        "min_elements": Rule(min=0),
        "max_workers": Rule(min=1, max=256),
    }

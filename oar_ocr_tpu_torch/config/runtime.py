"""Host parallelism policy.

The port's copy of ``ParallelPolicy`` from ``oar_ocr_tpu/config/
runtime.py:225-239``, the one part of that module the port's host code
uses (``utils/image.load_images``); the rest of the module configures
the TPU mesh and imports jax (the port's device and bucket settings are
in ``runtime/runtime.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .validation import Rule


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

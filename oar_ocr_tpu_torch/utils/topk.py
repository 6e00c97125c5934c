"""Top-k classification postprocess (oar-ocr-core/src/utils/topk.rs:29,120).

The port's copy of ``oar_ocr_tpu/utils/topk.py`` (:1-33), line for line
but for this docstring. ``tests/test_torch_host_copies.py`` holds it to
the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TopkResult:
    indices: Tuple[int, ...]
    scores: Tuple[float, ...]
    labels: Optional[Tuple[str, ...]] = None


def topk(probs: np.ndarray, k: int = 5,
         labels: Optional[Sequence[str]] = None) -> List[TopkResult]:
    """(N, C) class probabilities → per-sample top-k results, descending."""

    probs = np.asarray(probs, np.float32)
    if probs.ndim == 1:
        probs = probs[None]
    k = min(k, probs.shape[1])
    out = []
    for row in probs:
        idx = np.argsort(-row, kind="stable")[:k]
        out.append(TopkResult(
            indices=tuple(int(i) for i in idx),
            scores=tuple(float(row[i]) for i in idx),
            labels=tuple(labels[i] for i in idx) if labels else None))
    return out

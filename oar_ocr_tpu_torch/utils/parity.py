"""Compare two OCR results region by region (the port's accuracy gate).

The gate is the one of ``tools/bench_accuracy.py:38`` and the roadmap's
slice-done rule: the same region count per page, quad IoU ≥ 0.95 for
every matched region, identical texts, confidence Δ ≤ 2e-2. Regions are
matched to the nearest reference region by centre.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

IOU_GATE = 0.95
CONF_GATE = 2e-2


def quad_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Exact IoU of two convex quads."""
    import cv2

    a = np.asarray(a, np.float32).reshape(4, 2)
    b = np.asarray(b, np.float32).reshape(4, 2)
    inter, _ = cv2.intersectConvexConvex(a, b)
    union = cv2.contourArea(a) + cv2.contourArea(b) - inter
    return float(inter / union) if union > 0 else 0.0


def compare_results(ours: Sequence, ref: Sequence) -> dict:
    """Match every page's regions and summarise: region counts, minimum
    and mean IoU, text mismatches, maximum confidence delta, and ``ok``
    under the gate."""
    counts_equal = len(ours) == len(ref) and all(
        len(o.regions) == len(r.regions) for o, r in zip(ours, ref))
    ious, deltas, mismatches = [], [], []
    for page_i, (o, r) in enumerate(zip(ours, ref)):
        if not r.regions:
            continue
        centers = np.array([np.mean(np.asarray(x.box, np.float32), axis=0)
                            for x in r.regions])
        for region in o.regions:
            c = np.mean(np.asarray(region.box, np.float32), axis=0)
            match = r.regions[int(np.argmin(
                np.linalg.norm(centers - c, axis=1)))]
            ious.append(quad_iou(region.box, match.box))
            deltas.append(abs(float(region.confidence)
                              - float(match.confidence)))
            if region.text != match.text:
                mismatches.append((page_i, region.text, match.text))
    out = {
        "regions": sum(len(o.regions) for o in ours),
        "ref_regions": sum(len(r.regions) for r in ref),
        "counts_equal": counts_equal,
        "min_iou": min(ious) if ious else None,
        "mean_iou": float(np.mean(ious)) if ious else None,
        "text_mismatches": len(mismatches),
        "max_conf_delta": max(deltas) if deltas else None,
    }
    out["ok"] = bool(counts_equal and ious and min(ious) >= IOU_GATE
                     and not mismatches and max(deltas) <= CONF_GATE)
    out["first_mismatches"] = mismatches[:3]
    return out

"""Fixed-size class-aware NMS and top-k candidates, on the device.

Counterpart of ``oar_ocr_tpu/ops/nms.py`` in plain PyTorch (no Pallas
kernel lies behind it in the JAX package). Every function takes leading
batch dimensions, so one call serves a whole page batch where the JAX
package ``vmap``s over the pages (``layout.py:337-344``).

- Order among equal values is the JAX order: ``lax.top_k`` returns the
  lower index first among ties and ``jnp.argsort`` is stable
  (``nms.py:49, 71, 85``). ``torch.topk`` promises no order among ties on
  CUDA, so :func:`topk_stable` takes a stable descending sort instead.
- The greedy suppression (``nms.py:62-68``, a ``lax.scan`` over the K
  ranks) is run as its fixed point: ``keep[i] = init[i] and no kept
  j < i suppresses i`` depends only on lower ranks, so iterating
  ``keep ← init ∧ ¬any(suppress ∧ keep)`` from ``keep = init`` settles
  rank by rank and its first repeat is the scan's result, exactly. Each
  iteration is one batched pass over the (K, K) suppression matrix of
  every page; the loop ends at the first iteration that changes nothing,
  which the chains of suppression in the data decide (at most K + 1).
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, largest
    first, the lower index first among equal values (``lax.top_k``)."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy → (..., K, K) pairwise IoU (``nms.py:20-30``)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    area = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    ix0 = torch.maximum(x0[..., :, None], x0[..., None, :])
    iy0 = torch.maximum(y0[..., :, None], y0[..., None, :])
    ix1 = torch.minimum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.minimum(y1[..., :, None], y1[..., None, :])
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              labels: torch.Tensor, *, iou_thresh: float,
              score_thresh: float, max_det: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Class-aware greedy NMS over K candidates (``nms.py:33-76``).

    boxes (..., K, 4) xyxy, scores (..., K), labels (..., K) integer.
    Returns (boxes (..., max_det, 4), scores, labels, valid) sorted by
    score: a box is kept iff no higher-ranked *kept* box of its class
    overlaps it above ``iou_thresh``; slots beyond the kept count have
    valid False, score −1, label −1 and a zero box."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    scores = torch.gather(scores, -1, order)
    labels = torch.gather(labels, -1, order)

    k = scores.shape[-1]
    same = labels[..., :, None] == labels[..., None, :]
    overlap = (iou_matrix(boxes) > iou_thresh) & same
    rank = torch.arange(k, device=scores.device)
    upper = rank[None, :] < rank[:, None]       # (i, j): j ranks above i
    suppress = overlap & upper

    init = scores > score_thresh
    keep = init
    for _ in range(k + 1):
        nxt = init & ~(suppress & keep[..., None, :]).any(-1)
        if torch.equal(nxt, keep):
            break
        keep = nxt

    neg = torch.where(keep, scores, torch.full_like(scores, -1.0))
    top = torch.argsort(-neg, dim=-1, stable=True)[..., :max_det]
    valid = torch.gather(keep, -1, top) & (torch.gather(neg, -1, top) > -1.0)
    out_boxes = torch.where(
        valid[..., None],
        torch.gather(boxes, -2, top[..., None].expand(
            *top.shape, 4)), torch.zeros((), dtype=boxes.dtype,
                                         device=boxes.device))
    out_scores = torch.where(valid, torch.gather(scores, -1, top),
                             torch.full_like(neg[..., :top.shape[-1]], -1.0))
    out_labels = torch.where(valid, torch.gather(labels, -1, top),
                             torch.full_like(top, -1).to(labels.dtype))
    return out_boxes, out_scores, out_labels, valid


def topk_candidates(cls_scores: torch.Tensor, boxes: torch.Tensor, *,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Flatten (..., A, C) class scores to the top-k (box, score, label)
    candidates (``nms.py:79-88``); boxes (..., A, 4)."""
    c = cls_scores.shape[-1]
    flat = cls_scores.reshape(*cls_scores.shape[:-2], -1)
    scores, idx = topk_stable(flat, k)
    anchor = idx // c
    label = (idx % c).to(torch.int32)
    sel = torch.gather(boxes, -2, anchor[..., None].expand(*anchor.shape, 4))
    return sel, scores, label

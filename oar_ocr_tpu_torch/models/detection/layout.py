"""Layout detection: the variant-dispatching detector over exact PicoDet
and exact RT-DETR.

Counterpart of ``oar_ocr_tpu/models/detection/layout.py`` (:45-162). One
``detect`` call on a chunk of pages:

1. the input: ``ops/warp.sample_transform`` of each page to the variant's
   fixed input size (the gather, then K1 with the variant's
   normalization and R/B swap, counted under the caller ``"layout"``),
   in the runtime's compute dtype (:87-105);
2. the network (``rtdetr.RTDETRExact`` or ``picodet_exact.PicoDetExact``);
3. RT-DETR: ``rtdetr_postprocess`` (top 100 over queries × classes),
   boxes scaled by the source page size, valid where the score is above
   ``score_thresh`` (:111-122); PicoDet: ``ops/nms.topk_candidates``
   (top 400) and ``ops/nms.nms_fixed`` (100 kept) for the whole chunk at
   once, boxes scaled per page (:124-131). The device time of the NMS is
   recorded as the stage ``layout.nms`` (CUDA events, read after the
   fetch, so no extra sync);
4. one device→host fetch per chunk, then the ``LayoutBox`` list per page
   on the host (:151-162).

The JAX ``runtime.pad_batch`` (:145) pads the chunk for a mesh and shards
it over ``data``; the port's layout runs every chunk on the Runtime's
primary device, mesh or not (its data-parallel form is a later slice,
ROADMAP queue 1).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...domain.layout import LAYOUT_VARIANTS, LayoutBox, LayoutVariant
from ...ops.nms import nms_fixed, topk_candidates
from ...ops.warp import NormSpec, resize_matrix, sample_transform
from ...runtime.runtime import HostFetch, Runtime
from ...utils.tracing import METRICS, stage_timer
from ..layers import init_state_dict, load_weights
from .picodet_exact import PicoDetExact
from .rtdetr import RTDETRExact, rtdetr_postprocess


class _DeviceSpan:
    """The device time between two points of the stream: CUDA events on
    the card, the host clock on the CPU (where the work is synchronous).
    :meth:`record` stores it under ``stage`` once the events have passed,
    which the caller's fetch guarantees."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.seconds = time.perf_counter() - self.t0

    def record(self, stage: str) -> None:
        if self.cuda:
            self.end.synchronize()
            self.seconds = self.start.elapsed_time(self.end) / 1e3
        METRICS.record(stage, self.seconds)


class LayoutDetector:
    """Variant-dispatching layout detector with fixed-size outputs
    (:45-162). ``state_dict``: port weights (``params_from_jax``); seeded
    random weights when None."""

    MAX_DET = 100
    TOPK = 400

    def __init__(self, variant: str = "pp-doclayout_plus-l",
                 state_dict=None, *, score_thresh: float = 0.5,
                 nms_iou: float = 0.6, runtime: Optional[Runtime] = None,
                 net_overrides: Optional[dict] = None):
        self.variant: LayoutVariant = LAYOUT_VARIANTS[variant]
        self.runtime = runtime or Runtime()
        self.score_thresh = score_thresh
        self.nms_iou = nms_iou
        v = self.variant
        self._is_detr = v.net.startswith("rtdetr")
        if self._is_detr:
            kw = dict(num_classes=v.num_classes, arch=v.net.split("-")[1])
            kw.update(net_overrides or {})
            model = RTDETRExact(**kw)
        else:
            scale, neck_feat, head_convs = v.picodet_dims
            kw = dict(num_classes=v.num_classes, scale=scale,
                      neck_feat=neck_feat, head_convs=head_convs)
            kw.update(net_overrides or {})
            model = PicoDetExact(**kw)
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(0))
        self.model = load_weights(model, state_dict,
                                  dtype=self.runtime.compute_dtype,
                                  device=self.runtime.device)

    @property
    def _norm(self) -> NormSpec:
        """ImageNet statistics or x/255, R/B swapped for the ``bgr``
        variants (:87-94)."""
        v = self.variant
        if v.imagenet_norm:
            base = NormSpec.imagenet_rgb()
            return NormSpec(base.alpha, base.beta, swap_rb=v.bgr)
        return NormSpec(alpha=(1 / 255.0,) * 3, beta=(0.0,) * 3,
                        swap_rb=v.bgr)

    @torch.no_grad()
    def _step(self, pages_u8: torch.Tensor, mats: np.ndarray,
              img_idx: np.ndarray, src_hw: np.ndarray):
        """(boxes (N, 100, 4) page px, scores, labels, valid) on the
        device, and the NMS span (None for RT-DETR) (:96-131)."""
        ih, iw = self.variant.input_hw
        n = mats.shape[0]
        put = self.runtime.put
        dev = self.runtime.device
        full_w = torch.full((n,), iw, dtype=torch.int32, device=dev)
        full_h = torch.full((n,), ih, dtype=torch.int32, device=dev)
        x = sample_transform(pages_u8, put(mats), put(img_idx), full_w,
                             full_h, out_h=ih, out_w=iw, norm=self._norm,
                             out_dtype=self.runtime.compute_dtype,
                             caller="layout")
        scores, boxes = self.model(x)
        src_hw = put(src_hw)
        if self._is_detr:
            # DETRPostProcess: sigmoid → top-k over Q·C → normalized xyxy
            # scaled by the ORIGINAL page size (no NMS)
            top_sc, labels, xyxy = rtdetr_postprocess(scores, boxes,
                                                      num_top=self.MAX_DET)
            src = torch.stack([src_hw[:, 1], src_hw[:, 0], src_hw[:, 1],
                               src_hw[:, 0]], -1)
            return (xyxy * src[:, None, :], top_sc, labels,
                    top_sc > self.score_thresh), None
        scale = torch.stack([src_hw[:, 1] / iw, src_hw[:, 0] / ih,
                             src_hw[:, 1] / iw, src_hw[:, 0] / ih], -1)
        span = _DeviceSpan(dev)
        cand_b, cand_s, cand_l = topk_candidates(scores, boxes, k=self.TOPK)
        ob, os_, ol, ov = nms_fixed(cand_b, cand_s, cand_l,
                                    iou_thresh=self.nms_iou,
                                    score_thresh=self.score_thresh,
                                    max_det=self.MAX_DET)
        span.stop()
        return (ob * scale[:, None, :], os_, ol, ov), span

    def detect(self, pages_u8: torch.Tensor,
               shapes: Sequence[Tuple[int, int]],
               page_indices: Optional[Sequence[int]] = None
               ) -> List[List[LayoutBox]]:
        """Layout boxes of ``shapes``' pages, which lie at
        ``page_indices`` (default 0..n−1) in the uploaded batch
        ``pages_u8``."""
        n = len(shapes)
        ih, iw = self.variant.input_hw
        mats = np.stack([resize_matrix(h, w, ih, iw) for h, w in shapes])
        idx = np.asarray(page_indices if page_indices is not None
                         else np.arange(n), np.int32)
        src_hw = np.asarray(shapes, np.float32)
        with stage_timer(f"layout.device[{self.variant.name}]", batch=n):
            (b, s, l, v), span = self._step(pages_u8, mats, idx, src_hw)
            packed = torch.cat([b, s[..., None], l[..., None].float(),
                                v[..., None].float()], -1)
            out = HostFetch(packed).result()
        if span is not None:
            span.record("layout.nms")
        b, s, l, v = (out[..., :4], out[..., 4], out[..., 5].astype(np.int64),
                      out[..., 6] > 0)
        boxes: List[List[LayoutBox]] = []
        labels = self.variant.labels
        for i in range(n):
            items = []
            for j in range(b.shape[1]):
                if not v[i, j]:
                    continue
                li = int(l[i, j])
                items.append(LayoutBox(
                    label=labels[li] if 0 <= li < len(labels) else str(li),
                    score=float(s[i, j]), box=b[i, j].copy()))
            boxes.append(items)
        return boxes

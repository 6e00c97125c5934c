"""DB detector wrapper: plan (host) → device step → geometry (host).

Counterpart of ``oar_ocr_tpu/models/detection/detector.py`` with its
plan → dispatch → collect → finalize shape:

- dispatch: resize+normalize (``ops/det_device.separable_resize_normalize``,
  the K1 kernel inside), DBNet, threshold (+ optional 2×2 dilation) and
  bit-packing, then a device→host copy of the packed bitmap started at
  once (``runtime.HostFetch``);
- collect: host contours on the bitmap (the port's native C++
  candidates extension, ``native.py``, or its Python fallback), then
  device quad scores against the resident probability map;
- finalize: score filter, unclip and scale back on the host
  (``processors/db_postprocess.py``).

The POLY (seal) path (``detector.py:595-650``) takes host contours
simplified to polygons, scores them on the device against the resident
probability map (``ops/det_device.poly_scores``, at most
``MAX_POLY_VERTS`` vertices each) and unclips them on the host. The
slow-score mode (``detector.py:447-453, 652-665``) fetches the float32
map and runs the whole host post-processing, as the JAX package does.

With a mesh (``Runtime.mesh``) the det batch, padded to a multiple of
the ``data`` axis (``round_batch``), is split over the ``data`` devices,
each shard running the device half on its card with that card's replica
of DBNet (``Runtime.run_sharded``, ``detector.py:85-93``): the packed
bitmap stays per shard and is fetched shard by shard, and the
probability map is gathered on the primary device for the candidate
scoring, as the JAX ``out_spec=("replicated", "data")`` does.

Left out: the sparse bitmap fetch (``detector.py:194-244``, a remedy for
the TPU's remote link) — collect always fetches the whole packed
bitmap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import native as native_mod
from ...core.constants import IMAGENET_MEAN, IMAGENET_STD
from ...core.types import BoxType, ScoreMode
from ...ops.det_device import (dilate2x2, pack_bits, poly_scores,
                               quad_scores, separable_resize_normalize)
from ...ops.normalize import coefficients
from ...ops.resize import DetResizeConfig, det_target_size
from ...processors.db_postprocess import (DBPostProcess, DBPostProcessConfig,
                                          order_mini_box_points)
from ...runtime.runtime import (DET_BATCH_BUCKETS, DET_SIDE_BUCKETS,
                               HostFetch, Runtime)
from ...utils.tracing import stage_timer
from ..layers import init_state_dict, load_weights
from .db import DBNet

# the det preprocess's normalization (ImageNet mean/std on x/255)
DET_MEAN, DET_STD = IMAGENET_MEAN, IMAGENET_STD
DET_ALPHA, DET_BETA = coefficients(DET_MEAN, DET_STD)


@dataclass
class DetPlan:
    """Host-computed plan for one image in a detection batch."""

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int


class DBDetector:
    """Batched DB text detection over uint8 page images."""

    def __init__(self, state_dict=None, *,
                 resize_cfg: DetResizeConfig = DetResizeConfig(),
                 post_cfg: DBPostProcessConfig = DBPostProcessConfig(),
                 backbone_scale: float = 0.75, backbone: str = "lcnet",
                 runtime: Optional[Runtime] = None):
        """``state_dict``: port weights (``params_from_jax``); seeded
        random weights when None. ``backbone``: ``"lcnet"`` (mobile,
        PP-LCNetV3 × ``backbone_scale``) or ``"hgnet"`` (server,
        PP-HGNetV2; ``detector.py:66-80``)."""
        self.runtime = runtime or Runtime()
        self.resize_cfg = resize_cfg
        self.postprocess = DBPostProcess(post_cfg)
        model = DBNet(backbone_scale=backbone_scale, backbone=backbone)
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(0))
        self.model = load_weights(model, state_dict,
                                  dtype=self.runtime.compute_dtype,
                                  device=self.runtime.device)
        self._replicas = (None, None)

    def replicas(self) -> list:
        """DBNet on every ``data`` device (``Runtime.put_params``), made
        once a model."""
        if self._replicas[0] is not self.model:
            self._replicas = (self.model,
                              self.runtime.put_params(self.model))
        return self._replicas[1]

    def plan(self, shapes: Sequence[Tuple[int, int]]) -> List[DetPlan]:
        """Per-image det resize targets (exact reference math)."""
        return [DetPlan(h, w, *det_target_size(h, w, self.resize_cfg))
                for (h, w) in shapes]

    @torch.no_grad()
    def step(self, pages_u8: torch.Tensor, src_h, src_w, dst_h, dst_w, *,
             out_h: int, out_w: int, thresh: float, dilate: bool,
             model=None):
        """Device half: (prob (B, out_h, out_w) f32, packed bitmap
        (B, out_h, out_w/8) uint8), on ``model`` (a shard's replica;
        default the detector's)."""
        x = separable_resize_normalize(
            pages_u8, src_h, src_w, dst_h, dst_w, DET_ALPHA, DET_BETA,
            out_h=out_h, out_w=out_w, out_dtype=self.runtime.compute_dtype)
        prob = (model or self.model)(x).float()
        bitmap = prob > thresh
        if dilate:
            bitmap = dilate2x2(bitmap)
        return prob, pack_bits(bitmap)

    def dispatch(self, pages_u8: torch.Tensor,
                 shapes: Sequence[Tuple[int, int]],
                 page_indices: Optional[Sequence[int]] = None):
        """Queue the device half; returns a handle for :meth:`collect`."""
        plans = self.plan(shapes)
        n = len(plans)
        out_h = DET_SIDE_BUCKETS.bucket(max(p.dst_h for p in plans))
        out_w = DET_SIDE_BUCKETS.bucket(max(p.dst_w for p in plans))
        nb = self.runtime.round_batch(DET_BATCH_BUCKETS.bucket(n))
        # a contiguous batch of the bucketed size; pads repeat page 0
        src_idx = (list(page_indices) if page_indices is not None
                   else list(range(n)))
        idx = src_idx + [src_idx[0]] * (nb - n)
        if idx == list(range(pages_u8.shape[0])):
            batch = pages_u8
        else:
            # the index goes up through pinned memory: a pageable copy
            # would block the host until the stream's queued work is done
            batch = pages_u8[self.runtime.put(np.asarray(idx, np.int64))]

        def col(attr, fill=1):
            return self.runtime.put(np.array(
                [getattr(p, attr) for p in plans] + [fill] * (nb - n),
                np.int32))

        pp_cfg = self.postprocess.cfg

        def shard(model, *arrays):
            return self.step(*arrays, out_h=out_h, out_w=out_w,
                             thresh=pp_cfg.thresh,
                             dilate=pp_cfg.use_dilation, model=model)

        with stage_timer("det.dispatch", batch=nb, hw=(out_h, out_w)):
            prob, packed = self.runtime.run_sharded(
                shard, self.replicas(),
                (batch, col("src_h"), col("src_w"), col("dst_h"),
                 col("dst_w")), out_spec=("replicated", "data"))
            fetch = HostFetch(packed)
        return plans, prob, out_w, fetch

    def detect(self, pages_u8: torch.Tensor,
               shapes: Sequence[Tuple[int, int]],
               page_indices: Optional[Sequence[int]] = None
               ) -> List[Tuple[List[np.ndarray], List[float]]]:
        """[(boxes, scores)] per page, in original-image coordinates."""
        return self.finalize(self.collect_candidates(
            self.dispatch(pages_u8, shapes, page_indices)))

    def detect_images(self, images: Sequence[np.ndarray]
                      ) -> List[Tuple[List[np.ndarray], List[float]]]:
        """Host HWC uint8 RGB images → [(boxes, scores)] per image: one
        upload of the batch padded to the det side buckets, then
        :meth:`detect` (``detector.py:670-677``)."""
        shapes = [im.shape[:2] for im in images]
        h = DET_SIDE_BUCKETS.bucket(max(s[0] for s in shapes))
        w = DET_SIDE_BUCKETS.bucket(max(s[1] for s in shapes))
        return self.detect(self.runtime.put_pages(list(images), (h, w)),
                           shapes)

    def collect_candidates(self, handle):
        """Join the bitmap copy, extract quad candidates on the host and
        queue the device scoring of every candidate. The POLY and
        slow-score paths finish here: they return ``("done", results)``."""
        plans, prob, out_w, fetch = handle
        n = len(plans)
        with stage_timer("det.wait", batch=n):
            packed_np = fetch.result()
        cfg = self.postprocess.cfg
        if cfg.score_mode == ScoreMode.SLOW:
            return ("done", self._host_path(prob, packed_np, plans, out_w))
        if cfg.box_type == BoxType.POLY:
            return ("done", self._poly_path(prob, packed_np, plans, out_w))
        with stage_timer("det.candidates", batch=n):
            use_native = native_mod.available()
            bitmap_all = None
            if not use_native:
                bitmap_all = np.unpackbits(
                    packed_np, axis=-1, count=out_w).astype(np.uint8)
            cand_boxes: List[np.ndarray] = []
            raw_minis: List[np.ndarray] = []
            cand_img: List[int] = []
            per_page_count = []
            for i, p in enumerate(plans):
                if use_native:
                    cands = native_mod.db_candidates(
                        packed_np[i, : p.dst_h], p.dst_h, p.dst_w,
                        cfg.min_size, cfg.max_candidates)
                    minis = [order_mini_box_points(q) for q, _side in cands]
                else:
                    minis = self.postprocess.quad_candidates(
                        bitmap_all[i, : p.dst_h, : p.dst_w])
                per_page_count.append(len(minis))
                for mb in minis:
                    # score on the rounded+clamped quad (db_score.rs
                    # floor/ceil clamp); unclip later uses the raw box
                    q = np.round(mb)
                    q[:, 0] = np.clip(q[:, 0], 0, p.dst_w - 1)
                    q[:, 1] = np.clip(q[:, 1], 0, p.dst_h - 1)
                    cand_boxes.append(q.astype(np.float32))
                    raw_minis.append(mb.astype(np.float32))
                    cand_img.append(i)
        scores = None
        if cand_boxes:
            with torch.no_grad():
                dev_scores = quad_scores(
                    prob, self.runtime.put(np.stack(cand_boxes)),
                    self.runtime.put(np.asarray(cand_img, np.int64)))
            scores = HostFetch(dev_scores)
        return ("pending", plans, raw_minis, per_page_count, scores)

    def finalize(self, pending
                 ) -> List[Tuple[List[np.ndarray], List[float]]]:
        """Join the scores and build each page's (boxes, scores)."""
        if pending[0] == "done":
            return pending[1]
        _, plans, raw_minis, per_page_count, scores_fetch = pending
        results: List[Tuple[List[np.ndarray], List[float]]] = [
            ([], []) for _ in plans]
        if scores_fetch is None:
            return results
        with stage_timer("det.scores_wait", k=len(raw_minis)):
            scores = scores_fetch.result()
        box_thresh = self.postprocess.cfg.box_thresh
        with stage_timer("det.finalize", k=len(raw_minis)):
            ci = 0
            for i, p in enumerate(plans):
                keep_minis, keep_scores = [], []
                for _ in range(per_page_count[i]):
                    s = float(scores[ci])
                    if s >= box_thresh:
                        keep_minis.append(raw_minis[ci])
                        keep_scores.append(s)
                    ci += 1
                geoms = self.postprocess.finalize_quads_batch(
                    keep_minis, p.src_w / float(p.dst_w),
                    p.src_h / float(p.dst_h), p.src_w, p.src_h)
                results[i] = ([g for g in geoms if g is not None],
                              [s for g, s in zip(geoms, keep_scores)
                               if g is not None])
        return results

    MAX_POLY_VERTS = 32

    def _poly_path(self, prob, packed_np, plans, out_w):
        """Seal/POLY path: host contours simplified to polygons, device
        ray-casting scores over the resident probability map (the float32
        map stays on the device), host unclip."""
        n = len(plans)
        with stage_timer("det.candidates", batch=n):
            bitmap_all = np.unpackbits(
                packed_np, axis=-1, count=out_w).astype(np.uint8)
            cand_polys: List[np.ndarray] = []
            cand_img: List[int] = []
            per_page_count = []
            for i, p in enumerate(plans):
                approxes = self.postprocess.poly_candidates(
                    bitmap_all[i, : p.dst_h, : p.dst_w])
                per_page_count.append(len(approxes))
                cand_polys.extend(approxes)
                cand_img.extend([i] * len(approxes))

        results: List[Tuple[List[np.ndarray], List[float]]] = [
            ([], []) for _ in plans]
        if not cand_polys:
            return results
        k, pv = len(cand_polys), self.MAX_POLY_VERTS
        polys = np.zeros((k, pv, 2), np.float32)
        for ci, a in enumerate(cand_polys):
            if len(a) > pv:
                # decimate evenly to the vertex cap (scores only; the
                # unclip still uses the full polygon)
                a = a[np.linspace(0, len(a) - 1, pv).astype(int)]
            polys[ci, : len(a)] = a
            polys[ci, len(a):] = a[0]          # pad = vertex 0
        with stage_timer("det.poly_scores", k=k):
            with torch.no_grad():
                scores = poly_scores(
                    prob, self.runtime.put(polys),
                    self.runtime.put(np.asarray(cand_img, np.int64)))
            scores = scores.cpu().numpy()
        with stage_timer("det.finalize", k=k):
            ci = 0
            for i, p in enumerate(plans):
                boxes, bscores = [], []
                for _ in range(per_page_count[i]):
                    out = self.postprocess.finalize_poly(
                        cand_polys[ci], float(scores[ci]),
                        p.src_w / float(p.dst_w),
                        p.src_h / float(p.dst_h), p.src_w, p.src_h)
                    ci += 1
                    if out is not None:
                        boxes.append(out[0])
                        bscores.append(out[1])
                results[i] = (boxes, bscores)
        return results

    def _host_path(self, prob, packed_np, plans, out_w):
        """Slow-score path: fetch the float32 map and run the whole host
        post-processing (exact contour scoring)."""
        with stage_timer("det.prob_fetch", batch=len(plans)):
            prob_np = prob.cpu().numpy()
        results = []
        with stage_timer("det.postprocess_host", batch=len(plans)):
            bitmap_all = np.unpackbits(
                packed_np, axis=-1, count=out_w).astype(np.uint8)
            for i, p in enumerate(plans):
                pred = prob_np[i, : p.dst_h, : p.dst_w]
                bitmap = bitmap_all[i, : p.dst_h, : p.dst_w]
                results.append(self.postprocess(pred, bitmap, p.src_w,
                                                p.src_h))
        return results

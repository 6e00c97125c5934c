"""CTC recognizer wrapper: crop plans → warped tiles → probs → CTC.

Counterpart of ``oar_ocr_tpu/models/recognition/recognizer.py``. Each
ratio-sorted chunk splits into sub-batches (``dispatch_chunk``):

- axis-aligned crops (direct group) and axis-swapped crops (the
  rotate270 fold, run on the transposed pages) take the separable
  matmul warp (``ops/warp.warp_rec_tiles_separable``, K1 inside);
- slanted crops take the gather warp at native resolution
  (``ops/warp.sample_pixels``) followed by
  ``ops/det_device.separable_resize_normalize`` (``recognizer.py:151-176``).

Every sub-batch ends in SVTR, greedy CTC and ``pack_ctc_raw`` on the
device; the sub-batches of one det batch are merged into one array and
fetched with one device→host copy. Left out: the kept-only CTC fetch and
the host-warp mode (both remedies for the TPU's remote link).

With a mesh (``Runtime.mesh``) each sub-batch, padded to a multiple of
the ``data`` axis, is split over the ``data`` devices
(``Runtime.run_sharded``, ``recognizer.py:118-149``): each card holds
the page batch (``Runtime.replicated``, one copy a card, which the
caller keeps while the det batch's chunks read it), so every crop's page gather stays on
its card, and runs the warp, K1, its replica of SVTR and the CTC; the
packed CTC rows are gathered on the primary device, where the merged
collect folds them into one fetch.

``recognize_chunk`` runs one list of plans outside the OCR pipeline's
pooling (``OARStructure``'s refinement waves, ``recognizer.py:600-630``).
It cuts the list into pieces of at most the largest batch bucket (128)
and fetches them with one copy: the JAX ``recognize_chunk`` dispatches
the list whole, and a group of more than 128 plans overflows its bucket
(an ``IndexError`` there); at 128 plans or fewer the two are the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.constants import REC_IMAGE_SHAPE, REC_MAX_WIDTH
from ...ops.ctc import (CTCLabelDecoder, ctc_greedy_decode, default_charset,
                        pack_ctc_raw, unpack_ctc_raw)
from ...ops.det_device import separable_resize_normalize
from ...ops.warp import (NormSpec, band_origin, build_native_crop_matrix,
                         resize_matrix, sample_pixels, separable_coefs,
                         warp_rec_tiles_separable)
from ...runtime.runtime import (REC_BATCH_BUCKETS, REC_NATIVE_H_BUCKETS,
                               REC_NATIVE_W_BUCKETS, REC_WIDTH_BUCKETS,
                               HostFetch, Runtime)
from ...utils.tracing import stage_timer
from ..layers import init_state_dict, load_weights
from .svtr import SVTRRecognizer

REC_H = REC_IMAGE_SHAPE[1]  # 48


@dataclass
class CropPlan:
    """One text region scheduled for recognition (``recognizer.py:34-83``)."""

    page_index: int
    quad: np.ndarray          # (4,2) TL,TR,BR,BL in page coords
    width: int                # resized width at h=48
    matrix: np.ndarray        # (3,3) NATIVE crop px → page px
    native_w: int             # crop size after rotation
    native_h: int
    flip180: bool = False     # text-line orientation's 180° turn

    MAX_NATIVE_H = 192
    MAX_NATIVE_W = 1920

    @staticmethod
    def from_quad(page_index: int, quad: np.ndarray) -> "CropPlan":
        mat, rw, rh = build_native_crop_matrix(quad)
        ratio = rw / float(rh) if rh > 0 else 1.0
        width = max(1, min(int(math.ceil(REC_H * ratio)), REC_MAX_WIDTH))
        if rw > CropPlan.MAX_NATIVE_W or rh > CropPlan.MAX_NATIVE_H:
            scale = min(CropPlan.MAX_NATIVE_W / rw, CropPlan.MAX_NATIVE_H / rh)
            nw, nh = max(int(rw * scale), 1), max(int(rh * scale), 1)
            mat = (mat.astype(np.float64)
                   @ resize_matrix(rh, rw, nh, nw).astype(np.float64)
                   ).astype(np.float32)
            rw, rh = nw, nh
        return CropPlan(page_index, np.asarray(quad, np.float32), width,
                        mat, rw, rh)

    @property
    def wh_ratio(self) -> float:
        return self.width / float(REC_H)


class CTCRecognizer:
    """Batched text recognition over pre-planned crops."""

    def __init__(self, state_dict=None, *,
                 charset: Optional[Sequence[str]] = None,
                 use_space_char: bool = True, reverse: bool = False,
                 backbone_scale: float = 0.95, backbone: str = "lcnet",
                 runtime: Optional[Runtime] = None):
        """``state_dict``: port weights (``params_from_jax``); seeded
        random weights when None. ``charset`` (default printable ASCII),
        ``use_space_char`` and ``reverse`` (RTL) set the dictionary, whose
        size sets the model's vocabulary; ``backbone``: ``"lcnet"``
        (mobile, PP-LCNetV3 × ``backbone_scale``) or ``"hgnet"`` (server,
        PP-HGNetV2; ``recognizer.py:99-117``)."""
        self.runtime = runtime or Runtime()
        self.decoder = CTCLabelDecoder(charset or default_charset(),
                                       use_space_char=use_space_char,
                                       reverse=reverse)
        model = SVTRRecognizer(self.decoder.vocab_size,
                               backbone_scale=backbone_scale,
                               backbone=backbone)
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(0))
        self.model = load_weights(model, state_dict,
                                  dtype=self.runtime.compute_dtype,
                                  device=self.runtime.device)
        self._pages_t = None
        self._replicas = (None, None)

    def replicas(self) -> list:
        """SVTR on every ``data`` device (``Runtime.put_params``), made
        once a model."""
        if self._replicas[0] is not self.model:
            self._replicas = (self.model,
                              self.runtime.put_params(self.model))
        return self._replicas[1]

    def _finish(self, tiles: torch.Tensor, model=None) -> torch.Tensor:
        """SVTR (``model``, a shard's replica; default the recognizer's)
        → greedy CTC → packed (B, T, 6) uint8."""
        return pack_ctc_raw(ctc_greedy_decode((model or self.model)(tiles)))

    def _sharded(self, fn, src, batch, copies: dict, key: str):
        """``fn(model, pages, *rows)`` over the ``data`` shards of
        ``batch``, each card with its model replica and its copy of the
        pages ``src`` (``copies[key]``, made on first use and kept in the
        caller's ``copies`` for the page batch's life: ``dispatch_chunk``);
        the packed CTC gathered on the primary device."""
        if key not in copies:
            copies[key] = self.runtime.replicated(src)
        reps = list(zip(self.replicas(), copies[key]))
        return self.runtime.run_sharded(
            lambda rep, *rows: fn(rep[0], rep[1], *rows), reps, batch,
            out_spec="replicated")

    def _pages_transposed(self, pages_u8: torch.Tensor) -> torch.Tensor:
        cached = self._pages_t
        if cached is not None and cached[0] is pages_u8:
            return cached[1]
        pt = pages_u8.transpose(1, 2).contiguous()
        self._pages_t = (pages_u8, pt)
        return pt

    @torch.no_grad()
    def _dispatch_separable(self, pages_u8, plans: Sequence[CropPlan],
                            coefs, copies: dict, *,
                            swapped_group: bool) -> torch.Tensor:
        src = (self._pages_transposed(pages_u8) if swapped_group
               else pages_u8)
        src_h = src.shape[1]
        n = len(plans)
        nb = self.runtime.round_batch(REC_BATCH_BUCKETS.bucket(n))
        out_w = REC_WIDTH_BUCKETS.bucket(max(p.width for p in plans))
        nat_hb = REC_NATIVE_H_BUCKETS.bucket(max(p.native_h for p in plans))
        nat_wb = REC_NATIVE_W_BUCKETS.bucket(max(p.native_w for p in plans))
        band_h = REC_NATIVE_H_BUCKETS.bucket(int(max(
            abs(rc[0]) * (min(p.native_h, nat_hb) - 1) + 4
            for p, (_, rc, _) in zip(plans, coefs))))

        row_c = np.zeros((nb, 2), np.float32)
        col_c = np.zeros((nb, 2), np.float32)
        row_c[:, 0] = col_c[:, 0] = 1.0
        img_idx = np.zeros((nb,), np.int32)
        band_y0 = np.zeros((nb,), np.int32)
        valid_w = np.zeros((nb,), np.int32)
        nat_h = np.ones((nb,), np.int32)
        nat_w = np.ones((nb,), np.int32)
        for i, (p, (_sw, rc, cc)) in enumerate(zip(plans, coefs)):
            row_c[i] = rc
            col_c[i] = cc
            img_idx[i] = p.page_index
            band_y0[i] = band_origin(rc, min(p.native_h, nat_hb), src_h,
                                     band_h)
            valid_w[i] = min(p.width, out_w)
            nat_h[i] = min(p.native_h, nat_hb)
            nat_w[i] = min(p.native_w, nat_wb)

        def shard(model, pages, *rows):
            tiles = warp_rec_tiles_separable(
                pages, *rows, out_h=REC_H, out_w=out_w, nat_h_bucket=nat_hb,
                nat_w_bucket=nat_wb, band_h=band_h, norm=NormSpec.rec_bgr(),
                out_dtype=self.runtime.compute_dtype)
            return self._finish(tiles, model)

        with stage_timer("rec.dispatch_sep", batch=nb, width=out_w,
                         native=(nat_hb, nat_wb)):
            return self._sharded(shard, src, [self.runtime.put(a) for a in (
                row_c, col_c, img_idx, band_y0, nat_h, nat_w, valid_w)],
                copies, "swapped" if swapped_group else "direct")

    @torch.no_grad()
    def _dispatch_device_warp(self, pages_u8, plans: Sequence[CropPlan],
                              copies: dict) -> torch.Tensor:
        """Slanted crops: gather warp at native resolution, then the
        separable resize with the rec normalize (BGR, x·2/255 − 1, pad −1)."""
        n = len(plans)
        nb = self.runtime.round_batch(REC_BATCH_BUCKETS.bucket(n))
        out_w = REC_WIDTH_BUCKETS.bucket(max(p.width for p in plans))
        nat_h = REC_NATIVE_H_BUCKETS.bucket(max(p.native_h for p in plans))
        nat_w = REC_NATIVE_W_BUCKETS.bucket(max(p.native_w for p in plans))

        mats = np.zeros((nb, 3, 3), np.float32)
        mats[:, 0, 0] = mats[:, 1, 1] = mats[:, 2, 2] = 1.0
        img_idx = np.zeros((nb,), np.int32)
        valid_w = np.zeros((nb,), np.int32)
        native_w = np.ones((nb,), np.int32)
        native_h = np.ones((nb,), np.int32)
        for i, p in enumerate(plans):
            mats[i] = p.matrix
            img_idx[i] = p.page_index
            valid_w[i] = min(p.width, out_w)
            native_w[i] = min(p.native_w, nat_w)
            native_h[i] = min(p.native_h, nat_h)

        def shard(model, pages, mats_d, idx_d, nh, nw, rec_h, vw):
            native = sample_pixels(pages, mats_d, idx_d, out_h=nat_h,
                                   out_w=nat_w)
            tiles = separable_resize_normalize(
                native, nh, nw, rec_h, vw, (2.0 / 255.0,) * 3,
                (-1.0,) * 3, out_h=REC_H, out_w=out_w, swap_rb=True,
                out_dtype=self.runtime.compute_dtype, pad_value=-1.0,
                caller="rec")
            return self._finish(tiles, model)

        with stage_timer("rec.dispatch", batch=nb, width=out_w,
                         native=(nat_h, nat_w)):
            return self._sharded(shard, pages_u8, [
                self.runtime.put(a) for a in (
                    mats, img_idx, native_h, native_w,
                    np.full((nb,), REC_H, np.int32), valid_w)],
                copies, "direct")

    def dispatch_chunk(self, pages_u8: torch.Tensor,
                       plans: Sequence[CropPlan],
                       copies: Optional[dict] = None):
        """Queue one ratio-sorted chunk. Returns a list of
        (positions-within-chunk, packed CTC device array) sub-batches.
        ``copies``: a dict the caller keeps while it reads ``pages_u8``
        (the OCR pipeline: one a det batch), so the chunks that read the
        batch share one copy of it a ``data`` device; None: this chunk's
        own."""
        copies = {} if copies is None else copies
        max_band = REC_NATIVE_H_BUCKETS.sizes[-1]
        groups = {"direct": ([], [], []), "swapped": ([], [], [])}
        gat_pos, gat_plans = [], []
        for i, p in enumerate(plans):
            got = separable_coefs(p.matrix)
            if got is not None and abs(got[1][0]) * (p.native_h - 1) + 4 > max_band:
                got = None
            if got is not None:
                key = "swapped" if got[0] else "direct"
                groups[key][0].append(i)
                groups[key][1].append(p)
                groups[key][2].append(got)
            else:
                gat_pos.append(i)
                gat_plans.append(p)
        out = []
        for key, (pos, ps, coefs) in groups.items():
            if ps:
                out.append((pos, self._dispatch_separable(
                    pages_u8, ps, coefs, copies,
                    swapped_group=key == "swapped")))
        if gat_plans:
            out.append((gat_pos, self._dispatch_device_warp(
                pages_u8, gat_plans, copies)))
        return out

    def collect_chunk(self, handle, plans: Sequence[CropPlan]
                      ) -> List[Tuple[str, float, List[int]]]:
        """Fetch and dictionary-decode one dispatched chunk
        (``recognizer.py:600-614``): (text, confidence, kept columns) per
        plan, in plan order. One device→host copy for all its
        sub-batches."""
        merged = self.collect_merged(self.merge_dispatched(
            [(None, plans, handle)]))
        return merged[0][2] if merged else []

    def recognize_chunk(self, pages_u8: torch.Tensor,
                        plans: Sequence[CropPlan]
                        ) -> List[Tuple[str, float, List[int]]]:
        """Recognize ``plans`` on ``pages_u8`` (``recognizer.py:616-627``):
        (text, confidence, kept columns) per plan, in plan order."""
        if not plans:
            return []
        cap = REC_BATCH_BUCKETS.sizes[-1]
        copies: dict = {}
        pending = [(None, plans[s:s + cap],
                    self.dispatch_chunk(pages_u8, plans[s:s + cap], copies))
                   for s in range(0, len(plans), cap)]
        return [d for _, _, decoded in self.collect_merged(
            self.merge_dispatched(pending)) for d in decoded]

    def merge_dispatched(self, pending):
        """Fold every sub-batch of several dispatched chunks into ONE
        device array — live rows only, right-padded to the widest
        timestep count with 0xFF (index −1 ⇒ not kept) — and start its
        device→host copy. ``pending``: [(tag, plans, dispatch_chunk
        handle)]. Returns a handle for :meth:`collect_merged`."""
        tmax = max((packed.shape[1] for _, _, handle in pending
                    for _, packed in handle), default=0)
        parts, arrs, row = [], [], 0
        for tag, plans, handle in pending:
            subs = []
            for positions, packed in handle:
                n = len(positions)
                a = packed[:n]
                if a.shape[1] < tmax:
                    a = torch.nn.functional.pad(
                        a, (0, 0, 0, tmax - a.shape[1]), value=255)
                arrs.append(a)
                subs.append((positions, row, n, packed.shape[1]))
                row += n
            parts.append((tag, plans, subs))
        if not arrs:
            return None, parts
        return HostFetch(torch.cat(arrs, 0)), parts

    def collect_merged(self, merged_handle):
        """Join one merged copy and dictionary-decode every chunk in it.
        Returns [(tag, plans, decoded)] with ``decoded`` in plan order."""
        fetch, parts = merged_handle
        if fetch is None:
            return []
        with stage_timer("rec.wait"):
            packed_np = fetch.result()
        out = []
        for tag, plans, subs in parts:
            results: List = [None] * len(plans)
            with stage_timer("rec.decode", batch=len(plans)):
                for positions, row, n, t in subs:
                    raw = unpack_ctc_raw(packed_np[row : row + n, :t])
                    for pos, d in zip(positions,
                                      self.decoder.decode_with_positions(raw)):
                        results[pos] = d
            out.append((tag, plans, results))
        return out

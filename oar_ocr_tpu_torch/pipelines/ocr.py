"""OAROCR: the det→rec pipeline with its builder API.

Counterpart of ``oar_ocr_tpu/pipelines/ocr.py``. One ``predict`` call:

1. validate the uint8 RGB pages, downscale any page over
   ``max_side_len`` on the host;
2. per det batch of ``image_batch_size`` pages: upload the padded pages
   (``Runtime.put_pages``), or slice them from the caller's upload
   (``pages_dev``, ``OARStructure``'s), and queue detection
   (``DBDetector.dispatch``);
3. per det batch, in order: collect the bitmap, host contours, device
   quad scores, finalize; pool the page's crops in reading order,
   ratio-sort them, and queue recognition in ``region_batch_size`` chunks
   (flushing at ``MAX_POOLED_CROPS``), merged into one fetch per det batch;
4. decode the CTC results on the host and assemble the per-page results.

The builder's options (``ocr.py:560-656``) are all ported, the charset
and weight-source options included (a path, a ``ModelSource`` or a
registry name, resolved by ``registry/models.resolve_model_path``):
the document chain (``pipelines/preprocess.DocumentPreprocessor``: page
orientation, then UVDoc rectification) runs before step 1 and its pages
are uploaded afresh; text-line orientation classifies each crop pool on
the det batch's resident upload and folds a 180° turn into the crop matrix
(``ocr.py:239-252``); word boxes come from the CTC columns
(``processors/word_boxes``, ``ocr.py:372-386``); the ``"seal"`` preset
and ``BoxType.POLY`` crop each polygon through its min-area quad; boxes
and word boxes map back through the orientation correction when no
rectification ran (``ocr.py:440-470``).

Only the non-speculative consume path of the JAX pipeline is ported
(``ocr.py:311-354``), the reference's order: filter by ``box_thresh``,
then recognize. The speculative path hides a remote-link round trip by
recognizing every candidate before the scores are back and dropping the
low ones at assembly (``ocr.py:227-236, 394-438``); those extra crops
share the kept ones' chunks, change their width buckets and so SVTR's
attention over the padded timesteps, and a text can differ (the JAX
package's ``OAR_TPU_NO_SPEC_REC`` turns it off;
``tests/test_torch_rec_options.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.runtime import RuntimeConfig
from ..core.constants import MAX_POOLED_CROPS
from ..core.types import BoxType, LimitType
from ..domain.text_region import OAROCRResult, TextRegion
from ..errors import (InvalidInputError, batch_item_error,
                      format_batch_error_message)
from ..models.detection.detector import DBDetector
from ..models.recognition.recognizer import CropPlan, CTCRecognizer
from ..ops.resize import DetResizeConfig
from ..processors.db_postprocess import DBPostProcessConfig
from ..processors.geometry import order_quad_points, rotate_points_back
from ..processors.sorting import (sort_poly_boxes_indices,
                                  sort_quad_boxes_indices)
from ..processors.word_boxes import word_boxes
from ..runtime.runtime import DET_SIDE_BUCKETS, Runtime
from ..utils.tracing import logger, stage_timer

# Detection presets per text type (ocr.rs:314-366): (thresh, box_thresh,
# unclip_ratio, limit_side_len, limit_type, box_type).
TEXT_TYPE_PRESETS = {
    "general": (0.3, 0.6, 2.0, 960, LimitType.MAX, BoxType.QUAD),
    "table": (0.3, 0.4, 2.0, 960, LimitType.MAX, BoxType.QUAD),
    "seal": (0.2, 0.6, 0.5, 736, LimitType.MIN, BoxType.POLY),
}


@dataclass
class OAROCRConfig:
    image_batch_size: int = 8
    region_batch_size: int = 64
    max_side_len: int = 4000
    return_word_boxes: bool = False


@dataclass
class _PredictState:
    """In-flight state between :meth:`OAROCR.predict_dispatch` and
    :meth:`OAROCR.predict_collect`."""

    images: Sequence[np.ndarray]
    results: List[OAROCRResult]
    shapes: List = None
    unscaled_shapes: List = None
    orig_shapes: List = None
    page_scales: List = None
    pre_pages: Optional[List] = None
    det_pending: List = dataclasses.field(default_factory=list)


class OAROCR:
    """The assembled pipeline. Use :class:`OAROCRBuilder` to construct.
    ``preprocessor``: a ``DocumentPreprocessor`` run on the pages first;
    ``line_orienter``: a 2-class text-line ``ImageClassifier``."""

    def __init__(self, detector: DBDetector, recognizer: CTCRecognizer,
                 cfg: OAROCRConfig, runtime: Optional[Runtime] = None,
                 preprocessor=None, line_orienter=None):
        """``runtime``: the detector's when None (the JAX pipeline takes
        ``Runtime.default()``, ``ocr.py:83-90``; here the stages carry
        theirs)."""
        self.detector = detector
        self.recognizer = recognizer
        self.cfg = cfg
        self.runtime = runtime or detector.runtime
        self.preprocessor = preprocessor
        self.line_orienter = line_orienter

    def predict_paths(self, paths: Sequence[str]) -> List[OAROCRResult]:
        """Decode the image files (``utils/image.load_images``, threaded,
        ``FAIL_FAST``), then :meth:`predict`; each result carries its
        source path (``ocr.py:92-102``)."""
        from ..utils.image import load_images

        images, loaded = load_images(list(paths))
        results = self.predict(images)
        for r, p in zip(results, loaded):
            r.source_path = p
        return results

    def predict(self, images: Sequence[np.ndarray], *,
                pages_dev: Optional[torch.Tensor] = None
                ) -> List[OAROCRResult]:
        """Run det+rec on a list of HWC uint8 RGB images.

        ``pages_dev``: an already uploaded, zero-padded (B, H, W, 3) uint8
        batch of ``images`` in order (``OARStructure`` shares its page
        upload this way, ``ocr.py:104-116``); each det batch is then a
        slice of it instead of a fresh upload. It is dropped, and the
        pages uploaded afresh, where the pixels or the bucket differ from
        the caller's: after the document chain, after a downscale, or
        when its (H, W) is not this call's det bucket."""
        return self.predict_collect(self.predict_dispatch(
            images, pages_dev=pages_dev))

    def predict_dispatch(self, images: Sequence[np.ndarray], *,
                         pages_dev: Optional[torch.Tensor] = None
                         ) -> _PredictState:
        """Phase 1: validate, run the document chain, downscale, upload
        each det batch (or slice it from ``pages_dev``) and queue its
        detection."""
        if not images:
            return _PredictState(images=[], results=[])
        for im in images:
            if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
                raise InvalidInputError(
                    "images must be HWC uint8 RGB",
                    shape=getattr(im, "shape", None),
                    dtype=str(getattr(im, "dtype", None)))

        # the document chain: its pages are uploaded afresh below
        orig_shapes = [im.shape[:2] for im in images]
        pre_pages = None
        if self.preprocessor is not None:
            pre_pages = self.preprocessor.preprocess(images)
            images = [p.image for p in pre_pages]
            pages_dev = None        # the chain changed the pixels

        # max_side_len: downscale on the host; boxes scale back at assembly
        unscaled_shapes = [im.shape[:2] for im in images]
        page_scales = [1.0] * len(images)
        limit = self.cfg.max_side_len
        if any(max(s) > limit for s in unscaled_shapes):
            import cv2

            pages_dev = None        # the downscale changes the pixels
            scaled = []
            for i, im in enumerate(images):
                side = max(im.shape[:2])
                if side > limit:
                    s = limit / side
                    nh = max(1, int(round(im.shape[0] * s)))
                    nw = max(1, int(round(im.shape[1] * s)))
                    im = cv2.resize(im, (nw, nh),
                                    interpolation=cv2.INTER_AREA)
                    page_scales[i] = s
                scaled.append(im)
            images = scaled

        shapes = [im.shape[:2] for im in images]
        page_h = DET_SIDE_BUCKETS.bucket(max(s[0] for s in shapes))
        page_w = DET_SIDE_BUCKETS.bucket(max(s[1] for s in shapes))
        results = [OAROCRResult(width=s[1], height=s[0])
                   for s in unscaled_shapes]
        bs = self.cfg.image_batch_size
        if pages_dev is not None and tuple(pages_dev.shape[1:3]) != (
                page_h, page_w):
            pages_dev = None        # the caller's bucket disagrees
        det_pending = []   # (chunk page ids, pages_dev, det handle)
        for start in range(0, len(images), bs):
            chunk = list(range(start, min(start + bs, len(images))))
            if pages_dev is not None:
                # a slice of the shared upload: no host bytes move
                chunk_dev = pages_dev[start:start + len(chunk)]
            else:
                with stage_timer("ocr.upload", pages=len(chunk)):
                    chunk_dev = self.runtime.put_pages(
                        [images[i] for i in chunk], (page_h, page_w))
            det_pending.append((chunk, chunk_dev, self.detector.dispatch(
                chunk_dev, [shapes[i] for i in chunk])))
        return _PredictState(images=images, results=results, shapes=shapes,
                             unscaled_shapes=unscaled_shapes,
                             orig_shapes=orig_shapes, page_scales=page_scales,
                             pre_pages=pre_pages, det_pending=det_pending)

    def predict_collect(self, state: _PredictState) -> List[OAROCRResult]:
        """Phase 2: collect detection, pool + queue + collect recognition,
        assemble results."""
        if not state.images:
            return state.results
        shapes = state.shapes
        per_page_boxes: List[List[np.ndarray]] = [[] for _ in state.images]
        per_page_scores: List[List[float]] = [[] for _ in state.images]
        rec_merged = []
        line_angles: dict = {}

        def dispatch_pool(pool, pages_dev, copies):
            # text-line orientation of the pool on the det batch's upload;
            # crop plans index pages LOCAL to it (ocr.py:239-252)
            if self.line_orienter is not None and pool:
                cls = self.line_orienter.classify_quads(
                    pages_dev, [(p.page_index, p.quad) for _, _, p in pool])
                for (page_i, region_i, plan), (c, _score) in zip(pool, cls):
                    if c == 1:
                        plan.matrix = _compose_rot180(
                            plan.matrix, plan.native_w, plan.native_h)
                        plan.flip180 = True
                    line_angles[(page_i, region_i)] = 180 if c == 1 else 0
            # ratio sort (ocr.rs:811) + fixed-size chunks (:827)
            order = sorted(range(len(pool)), key=lambda i: pool[i][2].wh_ratio)
            rbs = self.cfg.region_batch_size
            pending = []
            for cs in range(0, len(order), rbs):
                chunk_ids = [pool[i] for i in order[cs : cs + rbs]]
                plans = [entry[2] for entry in chunk_ids]
                pending.append((chunk_ids, plans,
                                self.recognizer.dispatch_chunk(
                                    pages_dev, plans, copies)))
            if pending:
                rec_merged.append(self.recognizer.merge_dispatched(pending))

        def consume(chunk, pages_dev, handle):
            base = chunk[0]
            pool: List[Tuple[int, int, CropPlan]] = []
            # A failure of the host post-processing degrades: batched
            # detection falls back to per-image (ocr.rs:576-588) and a
            # page that fails alone yields an empty result. Device faults
            # do not: torch raises CUDA errors, failed kernel launches and
            # device out-of-memory as RuntimeError, and they propagate.
            try:
                det_out = self.detector.finalize(
                    self.detector.collect_candidates(handle))
            except RuntimeError:
                raise
            except Exception:
                det_out, failures = [], []
                for page_i in chunk:
                    try:
                        det_out.extend(self.detector.detect(
                            pages_dev, [shapes[page_i]],
                            page_indices=[page_i - base]))
                    except RuntimeError:
                        raise
                    except Exception as exc:
                        failures.append((page_i, batch_item_error(
                            "detection", page_i, len(chunk), exc)))
                        det_out.append(([], []))
                if failures:
                    logger.warning(format_batch_error_message(
                        "detection", failures, len(chunk)))
            quad_boxes = (self.detector.postprocess.cfg.box_type
                          == BoxType.QUAD)
            for local_i, page_i in enumerate(chunk):
                boxes, scores = det_out[local_i]
                order = (sort_quad_boxes_indices(boxes) if quad_boxes
                         else sort_poly_boxes_indices(boxes))
                per_page_boxes[page_i] = [boxes[i] for i in order]
                per_page_scores[page_i] = [scores[i] for i in order]
                for region_i, box in enumerate(per_page_boxes[page_i]):
                    quad = box if box.shape == (4, 2) else _poly_to_quad(box)
                    pool.append((page_i, region_i, CropPlan.from_quad(
                        local_i, order_quad_points(quad))))
            # the det batch's pages on every data device, made once for
            # all its chunks (Runtime.replicated)
            copies: dict = {}
            while len(pool) > MAX_POOLED_CROPS:
                dispatch_pool(pool[:MAX_POOLED_CROPS], pages_dev, copies)
                pool = pool[MAX_POOLED_CROPS:]
            if pool:
                dispatch_pool(pool, pages_dev, copies)

        for chunk, pages_dev, handle in state.det_pending:
            consume(chunk, pages_dev, handle)

        texts, word_box_map = {}, {}
        for merged in rec_merged:
            for chunk_ids, plans, decoded in self.recognizer.collect_merged(
                    merged):
                for (page_i, region_i, _), plan, (text, conf, cols) in zip(
                        chunk_ids, plans, decoded):
                    texts[(page_i, region_i)] = (text, conf)
                    if self.cfg.return_word_boxes and text:
                        word_box_map[(page_i, region_i)] = word_boxes(
                            plan.matrix, plan.native_w, plan.native_h,
                            plan.width, max((plan.width + 7) // 8, 1),
                            cols, text)

        # assemble; map geometry back to the ORIGINAL frame when an
        # orientation correction was applied and no rectification broke
        # the mapping (ocr.py:440-470)
        for page_i, res in enumerate(state.results):
            back_angle = None
            if state.pre_pages is not None:
                page = state.pre_pages[page_i]
                if page.orientation is not None:
                    res.orientation_angle = page.orientation.angle
                res.rectified = page.rectified
                if (page.orientation is not None
                        and page.orientation.angle != 0 and page.can_map_back):
                    # the CCW rotation that uprighted the page, inverted
                    back_angle = page.orientation.angle % 360
                    res.height, res.width = state.orig_shapes[page_i]
            scale = state.page_scales[page_i]
            uh, uw = state.unscaled_shapes[page_i]
            for region_i, box in enumerate(per_page_boxes[page_i]):
                text, conf = texts.get((page_i, region_i), ("", 0.0))
                wb = word_box_map.get((page_i, region_i))
                if scale != 1.0:
                    # back to the pre-downscale frame before any rotation
                    box = np.asarray(box, np.float32) / scale
                    if wb is not None:
                        wb = [(w, np.asarray(q, np.float32) / scale)
                              for w, q in wb]
                if back_angle is not None:
                    box = rotate_points_back(box, back_angle, uw, uh)
                    if wb is not None:
                        wb = [(w, rotate_points_back(q, back_angle, uw, uh))
                              for w, q in wb]
                res.regions.append(TextRegion(
                    box=box, text=text, confidence=conf,
                    det_score=per_page_scores[page_i][region_i],
                    orientation_angle=line_angles.get((page_i, region_i)),
                    word_boxes=[q for _, q in wb] if wb else None,
                    word_texts=[w for w, _ in wb] if wb else None))
        return state.results


def _compose_rot180(matrix: np.ndarray, native_w: int,
                    native_h: int) -> np.ndarray:
    """Compose a 180° rotation into a native-crop sampling matrix
    (``ocr.py:484-492``)."""
    f = np.array([[-1.0, 0.0, native_w - 1.0],
                  [0.0, -1.0, native_h - 1.0],
                  [0.0, 0.0, 1.0]], np.float64)
    return (matrix.astype(np.float64) @ f).astype(np.float32)


def _poly_to_quad(poly: np.ndarray) -> np.ndarray:
    """Min-area quad of a polygon box, for cropping poly detections
    (``ocr.py:495-500``)."""
    import cv2

    rect = cv2.minAreaRect(np.asarray(poly, np.float32))
    return cv2.boxPoints(rect).astype(np.float32)


def resolve_device_batch_sizes(runtime: Runtime) -> Tuple[int, int]:
    """(image_batch, region_batch) defaults by device class
    (``ocr.py:514-524``: accelerator 8/64, CPU 1/16)."""
    return (8, 64) if runtime.is_accelerator else (1, 16)


class OAROCRBuilder:
    """Fluent builder (``ocr.py:527``). Weights are port state_dicts
    (``runtime/weights.params_from_jax`` of a JAX checkpoint); missing
    weights are seeded random, as in the JAX package."""

    def __init__(self, text_type: str = "general"):
        if text_type not in TEXT_TYPE_PRESETS:
            raise InvalidInputError("unknown text_type", text_type=text_type)
        thresh, box_thresh, unclip, side, limit_type, box_type = (
            TEXT_TYPE_PRESETS[text_type])
        self._batch_sizes: Tuple[Optional[int], Optional[int]] = (None, None)
        self._det_post = DBPostProcessConfig(
            thresh=thresh, box_thresh=box_thresh, unclip_ratio=unclip,
            box_type=box_type)
        self._det_resize = DetResizeConfig(limit_side_len=side,
                                           limit_type=limit_type)
        self._charset: Optional[Sequence[str]] = None
        self._det_state = None
        self._rec_state = None
        self._runtime: Optional[Runtime] = None
        # optional stages, on seeded random weights (``ocr.py:641-656``);
        # a caller with weights passes the stages to OAROCR itself
        self._doc_ori = self._uvdoc = self._line_ori = False
        self._word_boxes = False
        self._use_mesh: Optional[bool] = None

    def with_det_config(self, **kwargs) -> "OAROCRBuilder":
        post_keys = {f.name for f in dataclasses.fields(DBPostProcessConfig)}
        self._det_post = dataclasses.replace(self._det_post, **{
            k: v for k, v in kwargs.items() if k in post_keys})
        resize_keys = {f.name for f in dataclasses.fields(DetResizeConfig)}
        rk = {k: v for k, v in kwargs.items() if k in resize_keys}
        if rk:
            self._det_resize = dataclasses.replace(self._det_resize, **rk)
        return self

    def with_charset(self, charset: Sequence[str]) -> "OAROCRBuilder":
        """The recognizer's dictionary (blank first, then ``charset``,
        then a space); its size sets the model's vocabulary."""
        self._charset = charset
        return self

    def with_charset_file(self, path: str) -> "OAROCRBuilder":
        """The dictionary from a PP-OCR dictionary file
        (``ops/ctc.load_charset``)."""
        from ..ops.ctc import load_charset

        self._charset = load_charset(path)
        return self

    def with_det_source(self, source) -> "OAROCRBuilder":
        """Detector weights from a checkpoint path, a registry name (its
        converted artifact in ``$OAR_TPU_HOME/models``) or a
        ``runtime/weights.ModelSource`` (path or bytes; ``ocr.py:
        578-587``)."""
        from ..runtime.weights import load_weight_source

        self._det_state = load_weight_source(source)
        return self

    def with_rec_source(self, source) -> "OAROCRBuilder":
        """Recognizer weights from a path, a registry name or a
        ``ModelSource``."""
        from ..runtime.weights import load_weight_source

        self._rec_state = load_weight_source(source)
        return self

    def with_det_params(self, state_dict) -> "OAROCRBuilder":
        """Detector weights as a port state_dict (``params_from_jax``)."""
        self._det_state = state_dict
        return self

    def with_rec_params(self, state_dict) -> "OAROCRBuilder":
        """Recognizer weights as a port state_dict (``params_from_jax``)."""
        self._rec_state = state_dict
        return self

    def with_runtime(self, runtime: Runtime) -> "OAROCRBuilder":
        self._runtime = runtime
        return self

    def with_mesh(self, enable: bool = True) -> "OAROCRBuilder":
        """Force the data-parallel device mesh on or off for this
        pipeline (``ocr.py:594-601``; default: on exactly when more than
        one CUDA card is visible). With the mesh, every det and rec batch
        is split over the ``data`` devices, each with its replica of the
        models and its copy of the pages. A runtime given by
        :meth:`with_runtime` keeps its own mesh."""
        self._use_mesh = enable
        return self

    def with_batch_sizes(self, image: Optional[int] = None,
                         region: Optional[int] = None) -> "OAROCRBuilder":
        self._batch_sizes = (image or self._batch_sizes[0],
                             region or self._batch_sizes[1])
        return self

    def with_doc_orientation(self, enable: bool = True) -> "OAROCRBuilder":
        """Classify each page's orientation (4 classes) and rotate it
        upright first."""
        self._doc_ori = enable
        return self

    def with_doc_rectification(self, enable: bool = True) -> "OAROCRBuilder":
        """Rectify each page with UVDoc (after orientation)."""
        self._uvdoc = enable
        return self

    def with_textline_orientation(self, enable: bool = True
                                  ) -> "OAROCRBuilder":
        """Classify each text line as upright or upside down and turn the
        latter before recognition."""
        self._line_ori = enable
        return self

    def with_word_boxes(self, enable: bool = True) -> "OAROCRBuilder":
        self._word_boxes = enable
        return self

    def build(self) -> OAROCR:
        runtime = self._runtime
        if runtime is None:
            # ocr.py:627-633: a mesh request makes the pipeline's runtime
            runtime = (Runtime(cfg=RuntimeConfig(use_mesh=self._use_mesh))
                       if self._use_mesh is not None else Runtime())
        image_bs, region_bs = resolve_device_batch_sizes(runtime)
        cfg = OAROCRConfig(image_batch_size=self._batch_sizes[0] or image_bs,
                           region_batch_size=self._batch_sizes[1] or region_bs,
                           return_word_boxes=self._word_boxes)
        detector = DBDetector(self._det_state, resize_cfg=self._det_resize,
                              post_cfg=self._det_post, runtime=runtime)
        recognizer = CTCRecognizer(self._rec_state, charset=self._charset,
                                   runtime=runtime)

        preprocessor = None
        if self._doc_ori or self._uvdoc:
            from .preprocess import DocumentPreprocessor

            preprocessor = DocumentPreprocessor(
                use_orientation=self._doc_ori,
                use_rectification=self._uvdoc, runtime=runtime)
        line_orienter = None
        if self._line_ori:
            from ..models.classification.pp_lcnet import (
                textline_orientation_classifier)

            line_orienter = textline_orientation_classifier(runtime=runtime)
        return OAROCR(detector, recognizer, cfg, runtime,
                      preprocessor=preprocessor, line_orienter=line_orienter)

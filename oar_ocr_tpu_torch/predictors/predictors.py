"""Single-task predictors: the 11 thin public per-task APIs.

Counterpart of ``oar_ocr_tpu/predictors/predictors.py`` (:29-271): each
predictor validates its config (``config/validation.validate_config``)
when built, validates its image inputs, runs the port's model wrapper on
the Runtime's device and returns the JAX predictor's outputs. The
constructors take ``state_dict`` (port weights, ``params_from_jax``; the
JAX predictors' ``params``), seeded random weights when None, and
``runtime``, the CUDA card unless the caller passes a CPU ``Runtime``.

The page-level predictors upload their batch once, zero-padded to the
det side buckets (``_upload``, ``Runtime.put_pages``); every wrapper then
reaches K1 (``ops/normalize``) as its input's normalize on the card.
"""

from __future__ import annotations

from typing import Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

from ..config.validation import validate_config
from ..runtime.runtime import DET_SIDE_BUCKETS, Runtime
from ..tasks.tasks import (ClassificationConfig, FormulaRecognitionConfig,
                           LayoutDetectionConfig, RectificationConfig,
                           SealTextDetectionConfig, TableStructureConfig,
                           TaskType, TextDetectionConfig,
                           TextRecognitionConfig, validate_images_input)

C = TypeVar("C")


class TaskPredictorCore(Generic[C]):
    """validate(config) at build; validate(input) → execute → output."""

    task: TaskType

    def __init__(self, config: C, runtime: Optional[Runtime] = None):
        validate_config(config)
        self.config = config
        self.runtime = runtime or Runtime()

    def _validate(self, images):
        validate_images_input(images, self.task.value)

    def _upload(self, images: Sequence[np.ndarray]):
        """One upload of the batch, zero-padded to the det side buckets:
        (device pages, per-image (h, w))."""
        shapes = [im.shape[:2] for im in images]
        h = DET_SIDE_BUCKETS.bucket(max(s[0] for s in shapes))
        w = DET_SIDE_BUCKETS.bucket(max(s[1] for s in shapes))
        return self.runtime.put_pages(list(images), (h, w)), shapes


class TextDetectionPredictor(TaskPredictorCore[TextDetectionConfig]):
    task = TaskType.TEXT_DETECTION

    def __init__(self, config: TextDetectionConfig = TextDetectionConfig(),
                 state_dict=None, runtime: Optional[Runtime] = None):
        super().__init__(config, runtime)
        from ..models.detection.detector import DBDetector
        from ..ops.resize import DetResizeConfig
        from ..processors.db_postprocess import DBPostProcessConfig

        self._det = DBDetector(
            state_dict,
            resize_cfg=DetResizeConfig(
                limit_side_len=config.limit_side_len,
                max_side_limit=config.max_side_limit),
            post_cfg=DBPostProcessConfig(
                thresh=config.thresh, box_thresh=config.box_thresh,
                unclip_ratio=config.unclip_ratio,
                max_candidates=config.max_candidates),
            runtime=self.runtime)

    def predict(self, images: Sequence[np.ndarray]
                ) -> List[Tuple[List[np.ndarray], List[float]]]:
        self._validate(images)
        return self._det.detect_images(images)


class SealTextDetectionPredictor(TaskPredictorCore[SealTextDetectionConfig]):
    task = TaskType.SEAL_TEXT_DETECTION

    def __init__(self,
                 config: SealTextDetectionConfig = SealTextDetectionConfig(),
                 state_dict=None, runtime: Optional[Runtime] = None):
        super().__init__(config, runtime)
        from ..core.types import BoxType, LimitType
        from ..models.detection.detector import DBDetector
        from ..ops.resize import DetResizeConfig
        from ..processors.db_postprocess import DBPostProcessConfig

        self._det = DBDetector(
            state_dict,
            resize_cfg=DetResizeConfig(
                limit_side_len=config.limit_side_len,
                limit_type=LimitType.MIN),
            post_cfg=DBPostProcessConfig(
                thresh=config.thresh, box_thresh=config.box_thresh,
                unclip_ratio=config.unclip_ratio, box_type=BoxType.POLY),
            runtime=self.runtime)

    def predict(self, images):
        self._validate(images)
        return self._det.detect_images(images)


class TextRecognitionPredictor(TaskPredictorCore[TextRecognitionConfig]):
    """Recognize pre-cropped text-line images: one crop plan per image
    over the padded upload, one ``recognize_chunk``; a text whose
    confidence is below ``score_thresh`` becomes empty (:122-137)."""

    task = TaskType.TEXT_RECOGNITION

    def __init__(self,
                 config: TextRecognitionConfig = TextRecognitionConfig(),
                 state_dict=None, runtime: Optional[Runtime] = None):
        super().__init__(config, runtime)
        from ..models.recognition.recognizer import CTCRecognizer
        from ..ops.ctc import load_charset

        charset = (load_charset(config.charset_path)
                   if config.charset_path else None)
        self._rec = CTCRecognizer(state_dict, charset=charset,
                                  use_space_char=config.use_space_char,
                                  reverse=config.reverse,
                                  runtime=self.runtime)

    def predict(self, images: Sequence[np.ndarray]
                ) -> List[Tuple[str, float]]:
        self._validate(images)
        from ..models.recognition.recognizer import CropPlan

        pages, shapes = self._upload(images)
        plans = []
        for i, (h, w) in enumerate(shapes):
            quad = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                            np.float32)
            plans.append(CropPlan.from_quad(i, quad))
        decoded = self._rec.recognize_chunk(pages, plans)
        out = [(t, c) for t, c, _ in decoded]
        if self.config.score_thresh > 0:
            out = [(t, c) if c >= self.config.score_thresh else ("", c)
                   for t, c in out]
        return out


class _ClassifierPredictor(TaskPredictorCore[ClassificationConfig]):
    """(class, score) per whole image."""

    _factory = None

    def __init__(self, config: ClassificationConfig = ClassificationConfig(),
                 state_dict=None, runtime: Optional[Runtime] = None):
        super().__init__(config, runtime)
        self._cls = type(self)._factory(state_dict, runtime=self.runtime)

    def predict(self, images: Sequence[np.ndarray]
                ) -> List[Tuple[int, float]]:
        self._validate(images)
        pages, shapes = self._upload(images)
        return self._cls.classify_pages(pages, shapes)


class DocumentOrientationPredictor(_ClassifierPredictor):
    task = TaskType.DOCUMENT_ORIENTATION
    from ..models.classification.pp_lcnet import doc_orientation_classifier
    _factory = staticmethod(doc_orientation_classifier)


class TextLineOrientationPredictor(_ClassifierPredictor):
    task = TaskType.TEXTLINE_ORIENTATION
    from ..models.classification.pp_lcnet import (
        textline_orientation_classifier)
    _factory = staticmethod(textline_orientation_classifier)


class TableClassificationPredictor(_ClassifierPredictor):
    task = TaskType.TABLE_CLASSIFICATION
    from ..models.classification.pp_lcnet import table_classifier
    _factory = staticmethod(table_classifier)


class DocumentRectificationPredictor(TaskPredictorCore):
    """UVDoc: each page rectified, at its own size."""

    task = TaskType.DOCUMENT_RECTIFICATION

    def __init__(self, config=None, state_dict=None,
                 runtime: Optional[Runtime] = None):
        super().__init__(config or RectificationConfig(), runtime)
        from ..models.rectification.uvdoc import UVDocRectifier

        self._rect = UVDocRectifier(state_dict, runtime=self.runtime)

    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        self._validate(images)
        return [self._rect.rectify(im) for im in images]


class LayoutDetectionPredictor(TaskPredictorCore[LayoutDetectionConfig]):
    task = TaskType.LAYOUT_DETECTION

    def __init__(self,
                 config: LayoutDetectionConfig = LayoutDetectionConfig(),
                 state_dict=None, runtime: Optional[Runtime] = None):
        super().__init__(config, runtime)
        from ..models.detection.layout import LayoutDetector

        self._det = LayoutDetector(
            config.variant, state_dict, score_thresh=config.score_thresh,
            nms_iou=config.nms_iou, runtime=self.runtime)

    def predict(self, images: Sequence[np.ndarray]):
        self._validate(images)
        pages, shapes = self._upload(images)
        return self._det.detect(pages, shapes)


class TableCellDetectionPredictor(LayoutDetectionPredictor):
    task = TaskType.TABLE_CELL_DETECTION

    def __init__(self, config: Optional[LayoutDetectionConfig] = None,
                 state_dict=None, runtime: Optional[Runtime] = None):
        cfg = config or LayoutDetectionConfig(
            variant="rt-detr-l_wired_table_cell_det", score_thresh=0.3)
        super().__init__(cfg, state_dict, runtime)


class TableStructureRecognitionPredictor(
        TaskPredictorCore[TableStructureConfig]):
    """SLANet on each whole image as one table, ``max_steps`` decode
    steps at most."""

    task = TaskType.TABLE_STRUCTURE_RECOGNITION

    def __init__(self, config: TableStructureConfig = TableStructureConfig(),
                 state_dict=None, runtime: Optional[Runtime] = None):
        super().__init__(config, runtime)
        from ..models.recognition.slanet import SLANetModel

        self._model = SLANetModel(state_dict, max_steps=config.max_steps,
                                  runtime=self.runtime)

    def predict(self, images: Sequence[np.ndarray]):
        self._validate(images)
        pages, shapes = self._upload(images)
        regions = [(i, (0, 0, s[1], s[0])) for i, s in enumerate(shapes)]
        return self._model.recognize(pages, regions)


class FormulaRecognitionPredictor(
        TaskPredictorCore[FormulaRecognitionConfig]):
    """The default formula recognizer at ``max_len`` steps (256 by
    default, the task config's; the structure builder's is 64), or
    UniMERNet with ``model_type="unimernet"``."""

    task = TaskType.FORMULA_RECOGNITION

    def __init__(self,
                 config: FormulaRecognitionConfig = FormulaRecognitionConfig(),
                 state_dict=None, runtime: Optional[Runtime] = None):
        super().__init__(config, runtime)
        if config.model_type == "unimernet":
            from ..models.recognition.unimernet import UniMERNetRecognizer

            self._model = UniMERNetRecognizer(state_dict,
                                              runtime=self.runtime)
        else:
            from ..models.recognition.formula import FormulaRecognizer

            self._model = FormulaRecognizer(state_dict,
                                            max_len=config.max_len,
                                            runtime=self.runtime)

    def predict(self, images: Sequence[np.ndarray]):
        self._validate(images)
        return self._model.recognize(list(images))


ALL_PREDICTORS = {
    TaskType.TEXT_DETECTION: TextDetectionPredictor,
    TaskType.TEXT_RECOGNITION: TextRecognitionPredictor,
    TaskType.DOCUMENT_ORIENTATION: DocumentOrientationPredictor,
    TaskType.TEXTLINE_ORIENTATION: TextLineOrientationPredictor,
    TaskType.DOCUMENT_RECTIFICATION: DocumentRectificationPredictor,
    TaskType.LAYOUT_DETECTION: LayoutDetectionPredictor,
    TaskType.TABLE_CELL_DETECTION: TableCellDetectionPredictor,
    TaskType.TABLE_CLASSIFICATION: TableClassificationPredictor,
    TaskType.TABLE_STRUCTURE_RECOGNITION: TableStructureRecognitionPredictor,
    TaskType.FORMULA_RECOGNITION: FormulaRecognitionPredictor,
    TaskType.SEAL_TEXT_DETECTION: SealTextDetectionPredictor,
}

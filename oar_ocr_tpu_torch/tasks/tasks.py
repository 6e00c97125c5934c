"""Task definitions: the 11-task registry.

Re-expresses the reference's task layer (oar-ocr-core/src/domain/tasks/*,
registry macro core/macros.rs:28-110): each task has a config dataclass
with declarative validation (the `#[derive(ConfigValidator)]` analog), an
input/output schema, and validation hooks. A single TASK_REGISTRY dict
replaces the `with_task_registry!` macro as the one source of truth.

The port's copy of ``oar_ocr_tpu/tasks/tasks.py`` (:1-185), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py``
holds it to the original.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Type

import numpy as np

from ..config.validation import Rule
from ..errors import InvalidInputError


class TaskType(enum.Enum):
    """The 11 task types (core/macros.rs:31-107)."""

    TEXT_DETECTION = "text_detection"
    TEXT_RECOGNITION = "text_recognition"
    DOCUMENT_ORIENTATION = "document_orientation"
    TEXTLINE_ORIENTATION = "textline_orientation"
    DOCUMENT_RECTIFICATION = "document_rectification"
    LAYOUT_DETECTION = "layout_detection"
    TABLE_CELL_DETECTION = "table_cell_detection"
    TABLE_CLASSIFICATION = "table_classification"
    TABLE_STRUCTURE_RECOGNITION = "table_structure_recognition"
    FORMULA_RECOGNITION = "formula_recognition"
    SEAL_TEXT_DETECTION = "seal_text_detection"


def validate_images_input(images: Sequence[np.ndarray], task: str) -> None:
    """Common image-input validation (traits/task.rs ImageTaskInput)."""
    if not isinstance(images, (list, tuple)):
        raise InvalidInputError("input must be a list of images", task=task)
    for i, im in enumerate(images):
        if not isinstance(im, np.ndarray) or im.ndim != 3 or im.shape[2] != 3:
            raise InvalidInputError("image must be HWC with 3 channels",
                                    task=task, index=i,
                                    shape=getattr(im, "shape", None))
        if im.dtype != np.uint8:
            raise InvalidInputError("image must be uint8", task=task,
                                    index=i, dtype=str(im.dtype))
        if im.shape[0] < 1 or im.shape[1] < 1:
            raise InvalidInputError("empty image", task=task, index=i)


# --------------------------- task configs ---------------------------

@dataclass
class TextDetectionConfig:
    """domain/tasks/text_detection.rs:33-53."""

    thresh: float = 0.3
    box_thresh: float = 0.6
    unclip_ratio: float = 1.5
    max_candidates: int = 1000
    limit_side_len: int = 960
    max_side_limit: int = 4000

    RULES = {
        "thresh": Rule(min=0.0, max=1.0),
        "box_thresh": Rule(min=0.0, max=1.0),
        "unclip_ratio": Rule(min=0.0, max=10.0),
        "max_candidates": Rule(min=1, max=100000),
        "limit_side_len": Rule(min=32, max=10000),
    }


@dataclass
class TextRecognitionConfig:
    score_thresh: float = 0.0
    use_space_char: bool = True
    reverse: bool = False              # RTL scripts (pred_reverse)
    charset_path: Optional[str] = None

    RULES = {"score_thresh": Rule(min=0.0, max=1.0),
             "charset_path": Rule(path_exists=True)}


@dataclass
class ClassificationConfig:
    score_thresh: float = 0.0
    RULES = {"score_thresh": Rule(min=0.0, max=1.0)}


@dataclass
class LayoutDetectionConfig:
    variant: str = "pp-doclayout_plus-l"
    score_thresh: float = 0.5
    nms_iou: float = 0.6

    RULES = {"score_thresh": Rule(min=0.0, max=1.0),
             "nms_iou": Rule(min=0.0, max=1.0)}

    def validate_extra(self):
        from ..domain.layout import LAYOUT_VARIANTS

        if self.variant not in LAYOUT_VARIANTS:
            from ..errors import ConfigError

            raise ConfigError("unknown layout variant", variant=self.variant)


@dataclass
class TableStructureConfig:
    max_steps: int = 500
    RULES = {"max_steps": Rule(min=1, max=2000)}


@dataclass
class FormulaRecognitionConfig:
    max_len: int = 256
    # "pp_formulanet" | "unimernet" — the reference's model_type switch
    # (oarocr structure builder with_formula_recognition model_type)
    model_type: str = "pp_formulanet"
    RULES = {"max_len": Rule(min=1, max=4096),
             "model_type": Rule(choices=("pp_formulanet", "unimernet"))}


@dataclass
class SealTextDetectionConfig(TextDetectionConfig):
    """Seal preset: poly boxes, min-limited resize (ocr.rs:314-366)."""

    thresh: float = 0.2
    box_thresh: float = 0.6
    unclip_ratio: float = 0.5
    limit_side_len: int = 736


@dataclass
class RectificationConfig:
    pass


@dataclass
class TaskDef:
    """One registry entry (the TaskDefinition trait analog)."""

    task_type: TaskType
    config_cls: Type
    description: str


TASK_REGISTRY: Dict[TaskType, TaskDef] = {
    TaskType.TEXT_DETECTION: TaskDef(
        TaskType.TEXT_DETECTION, TextDetectionConfig,
        "DB text detection → quad/poly boxes + scores"),
    TaskType.TEXT_RECOGNITION: TaskDef(
        TaskType.TEXT_RECOGNITION, TextRecognitionConfig,
        "CTC text recognition → text + confidence"),
    TaskType.DOCUMENT_ORIENTATION: TaskDef(
        TaskType.DOCUMENT_ORIENTATION, ClassificationConfig,
        "page orientation, 4 classes"),
    TaskType.TEXTLINE_ORIENTATION: TaskDef(
        TaskType.TEXTLINE_ORIENTATION, ClassificationConfig,
        "text-line orientation, 2 classes"),
    TaskType.DOCUMENT_RECTIFICATION: TaskDef(
        TaskType.DOCUMENT_RECTIFICATION, RectificationConfig,
        "UVDoc unwarping"),
    TaskType.LAYOUT_DETECTION: TaskDef(
        TaskType.LAYOUT_DETECTION, LayoutDetectionConfig,
        "layout element detection"),
    TaskType.TABLE_CELL_DETECTION: TaskDef(
        TaskType.TABLE_CELL_DETECTION, LayoutDetectionConfig,
        "table cell detection (RT-DETR)"),
    TaskType.TABLE_CLASSIFICATION: TaskDef(
        TaskType.TABLE_CLASSIFICATION, ClassificationConfig,
        "wired/wireless table classification"),
    TaskType.TABLE_STRUCTURE_RECOGNITION: TaskDef(
        TaskType.TABLE_STRUCTURE_RECOGNITION, TableStructureConfig,
        "SLANet structure tokens + cell boxes"),
    TaskType.FORMULA_RECOGNITION: TaskDef(
        TaskType.FORMULA_RECOGNITION, FormulaRecognitionConfig,
        "formula image → LaTeX"),
    TaskType.SEAL_TEXT_DETECTION: TaskDef(
        TaskType.SEAL_TEXT_DETECTION, SealTextDetectionConfig,
        "curved seal text detection (poly)"),
}

"""The port's error hierarchy.

Copied value for value from ``oar_ocr_tpu/errors.py``, so that the port
imports nothing of the JAX package: ``OCRError`` (:29-42),
``ProcessingStage`` (:45-55), ``ImageLoadError`` (:58-59),
``ProcessingError`` with its
``batch_processing`` constructor (:62-73, :107-118), ``InvalidInputError``
(:166-167), ``ConfigError`` (:170-171), ``ModelLoadError`` (:195-196),
``UnsupportedError`` (:203-204), ``batch_item_error`` and
``format_batch_error_message`` (:207-229). What the port never raises
(the other constructors, ``InferenceError``, ``DownloadError``) is
left out.
"""

from __future__ import annotations

import enum
from typing import Any, Mapping, Optional, Sequence, Tuple


class OCRError(Exception):
    """Base error. Carries structured ``context`` for observability."""

    def __init__(self, message: str, /, **context: Any):
        self.context: Mapping[str, Any] = dict(context)
        if context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in context.items())
            message = f"{message} [{ctx}]"
        super().__init__(message)


class ProcessingStage(enum.Enum):
    """Which phase a processing failure hit."""

    TENSOR_OPERATION = "tensor_operation"
    NORMALIZATION = "normalization"
    RESIZE = "resize"
    IMAGE_PROCESSING = "image_processing"
    BATCH_PROCESSING = "batch_processing"
    POST_PROCESSING = "post_processing"
    WARP = "warp"
    DECODE = "decode"


class ImageLoadError(OCRError):
    """Failed to read or decode an input image (types.rs ImageLoad)."""


class ProcessingError(OCRError):
    """Pre/post-processing failure, tagged with its stage."""

    stage: Optional[ProcessingStage] = None

    @classmethod
    def _staged(cls, stage: ProcessingStage, message: str,
                **context: Any) -> "ProcessingError":
        err = cls(message, stage=stage.value, **context)
        err.stage = stage
        return err

    @classmethod
    def batch_processing(cls, message: str, *,
                         batch_size: Optional[int] = None,
                         batch_index: Optional[int] = None,
                         **context: Any):
        """A batch failure with its size and failing index."""
        if batch_size is not None:
            context["batch_size"] = batch_size
        if batch_index is not None:
            context["batch_index"] = batch_index
        return cls._staged(ProcessingStage.BATCH_PROCESSING, message,
                           **context)


class InvalidInputError(OCRError):
    """Input validation failure."""


class ConfigError(OCRError):
    """Configuration validation failure."""


class ModelLoadError(OCRError):
    """Weight loading / conversion failure."""


class UnsupportedError(OCRError):
    """Feature not supported on this backend/configuration."""


def batch_item_error(stage: str, item_index: int, total: int,
                     cause: BaseException) -> ProcessingError:
    """One failed item of a batch, chained to its cause."""
    err = ProcessingError.batch_processing(
        f"batch item {item_index}/{total} failed in {stage}",
        batch_index=item_index, batch_size=total, item_stage=stage)
    err.__cause__ = cause
    return err


def format_batch_error_message(stage: str,
                               failures: Sequence[Tuple[int, BaseException]],
                               total: int) -> str:
    """Aggregate a batch's per-item failures into one digest line."""
    if not failures:
        return f"{stage}: batch of {total} succeeded"
    head = ", ".join(f"#{i}: {type(e).__name__}: {e}"
                     for i, e in list(failures)[:3])
    more = f" (+{len(failures) - 3} more)" if len(failures) > 3 else ""
    return (f"{stage}: {len(failures)}/{total} batch items failed — "
            f"{head}{more}")

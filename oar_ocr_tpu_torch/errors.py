"""Error hierarchy for the TPU OCR framework.

TPU-native re-expression of the reference's ``OCRError`` enum
(reference: oar-ocr-core/src/core/errors/types.rs:110-170) and its rich
builder constructors (constructors.rs:72-660). In Python the natural shape
is an exception hierarchy with structured context attached rather than an
enum; every variant of the Rust enum has a corresponding exception class
here, and the typed constructors below mirror constructors.rs one for one
so raise sites attach the same shapes / stages / batch indices the
reference's do:

- ``ProcessingError.tensor_operation / normalization / resize /
  image_processing / batch_processing / post_processing`` — the staged
  processing constructors (:128-300) with a ``ProcessingStage`` tag;
- ``InferenceError.for_model(...)`` — the ModelInferenceError builder
  (:72-126): ``.with_batch_index().with_input_shape().with_context()``
  then ``.build(cause)``;
- ``ConfigError.for_field / validation / resource_limit`` (:346-404);
- ``batch_item_error`` + ``format_batch_error_message`` (:599-660) —
  per-item failure aggregation for graceful-degradation paths.

The port's copy of ``oar_ocr_tpu/errors.py`` (:1-229), line for line;
only this paragraph is new. ``tests/test_torch_host_copies.py`` holds it
to the original.
"""

from __future__ import annotations

import enum
from typing import Any, List, Mapping, Optional, Sequence, Tuple


class OCRError(Exception):
    """Base error. Carries structured ``context`` for observability.

    Mirrors the context-rich errors of the reference
    (oar-ocr-core/src/core/errors/types.rs:139-157 attaches input shapes and
    batch indices); we attach an arbitrary mapping.
    """

    def __init__(self, message: str, /, **context: Any):
        self.context: Mapping[str, Any] = dict(context)
        if context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in context.items())
            message = f"{message} [{ctx}]"
        super().__init__(message)


class ProcessingStage(enum.Enum):
    """types.rs ProcessingStage — which phase a processing failure hit."""

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
    """Pre/post-processing failure (types.rs Processing). Prefer the
    staged constructors, which mirror constructors.rs."""

    stage: Optional[ProcessingStage] = None

    @classmethod
    def _staged(cls, stage: ProcessingStage, message: str,
                **context: Any) -> "ProcessingError":
        err = cls(message, stage=stage.value, **context)
        err.stage = stage
        return err

    @classmethod
    def tensor_operation(cls, message: str, *,
                         shape: Optional[Sequence[int]] = None,
                         **context: Any) -> "ProcessingError":
        """constructors.rs:128 tensor_operation."""
        if shape is not None:
            context["shape"] = tuple(shape)
        return cls._staged(ProcessingStage.TENSOR_OPERATION, message,
                           **context)

    @classmethod
    def normalization(cls, message: str, **context: Any):
        """constructors.rs:190 normalization."""
        return cls._staged(ProcessingStage.NORMALIZATION, message, **context)

    @classmethod
    def resize(cls, message: str, *,
               src: Optional[Tuple[int, int]] = None,
               dst: Optional[Tuple[int, int]] = None, **context: Any):
        """constructors.rs:207 resize_error — source/target dims."""
        if src is not None:
            context["src_hw"] = tuple(src)
        if dst is not None:
            context["dst_hw"] = tuple(dst)
        return cls._staged(ProcessingStage.RESIZE, message, **context)

    @classmethod
    def image_processing(cls, message: str, **context: Any):
        """constructors.rs:224 image_processing."""
        return cls._staged(ProcessingStage.IMAGE_PROCESSING, message,
                           **context)

    @classmethod
    def batch_processing(cls, message: str, *,
                         batch_size: Optional[int] = None,
                         batch_index: Optional[int] = None,
                         **context: Any):
        """constructors.rs:263 batch_processing — size + failing index."""
        if batch_size is not None:
            context["batch_size"] = batch_size
        if batch_index is not None:
            context["batch_index"] = batch_index
        return cls._staged(ProcessingStage.BATCH_PROCESSING, message,
                           **context)

    @classmethod
    def post_processing(cls, message: str, **context: Any):
        """constructors.rs:173 post_processing."""
        return cls._staged(ProcessingStage.POST_PROCESSING, message,
                           **context)


class InferenceErrorBuilder:
    """constructors.rs:72-126 ModelInferenceError builder: collect model
    name, operation, batch index, input shape, free-form context, then
    ``build(cause)`` → InferenceError (chained via __cause__)."""

    def __init__(self, model_name: str, operation: str):
        self._ctx: dict = {"model": model_name, "operation": operation}

    def with_batch_index(self, index: int) -> "InferenceErrorBuilder":
        self._ctx["batch_index"] = index
        return self

    def with_input_shape(self, shape: Sequence[int]
                         ) -> "InferenceErrorBuilder":
        self._ctx["input_shape"] = tuple(int(s) for s in shape)
        return self

    def with_context(self, note: str) -> "InferenceErrorBuilder":
        self._ctx["note"] = note
        return self

    def build(self, cause: Optional[BaseException] = None
              ) -> "InferenceError":
        err = InferenceError(
            f"inference failed in {self._ctx['operation']}", **self._ctx)
        if cause is not None:
            err.__cause__ = cause
        return err


class InferenceError(OCRError):
    """Failure executing a compiled XLA program (types.rs Inference /
    ModelInference — a single class since there is one runtime here)."""

    @staticmethod
    def for_model(model_name: str, operation: str) -> InferenceErrorBuilder:
        return InferenceErrorBuilder(model_name, operation)


class InvalidInputError(OCRError):
    """Input validation failure (types.rs InvalidInput)."""


class ConfigError(OCRError):
    """Configuration validation failure (core/config/errors.rs)."""

    @classmethod
    def for_field(cls, field: str, value: Any, reason: str) -> "ConfigError":
        """constructors.rs:346 config_error_with_context."""
        return cls(f"invalid configuration for {field!r}: {reason}",
                   field=field, value=value)

    @classmethod
    def validation(cls, component: str, field: str, expected: Any,
                   actual: Any) -> "ConfigError":
        """constructors.rs:366 validation_error."""
        return cls(f"{component}.{field} validation failed",
                   component=component, field=field, expected=expected,
                   actual=actual)

    @classmethod
    def resource_limit(cls, resource: str, limit: int, requested: int
                       ) -> "ConfigError":
        """constructors.rs:385 resource_limit_error."""
        return cls(f"{resource} limit exceeded", resource=resource,
                   limit=limit, requested=requested)


class ModelLoadError(OCRError):
    """Weight loading / conversion failure (model_source.rs error paths)."""


class DownloadError(OCRError):
    """Model asset resolution failure (core/download/mod.rs)."""


class UnsupportedError(OCRError):
    """Feature not supported on this backend/configuration."""


def batch_item_error(stage: str, item_index: int, total: int,
                     cause: BaseException) -> ProcessingError:
    """constructors.rs:599 batch_item_error — one failed item of a batch,
    chained to its cause (graceful-degradation paths wrap per-item)."""
    err = ProcessingError.batch_processing(
        f"batch item {item_index}/{total} failed in {stage}",
        batch_index=item_index, batch_size=total, item_stage=stage)
    err.__cause__ = cause
    return err


def format_batch_error_message(stage: str,
                               failures: Sequence[Tuple[int, BaseException]],
                               total: int) -> str:
    """constructors.rs:638 format_batch_error_message — aggregate a batch's
    per-item failures into one digest line."""
    if not failures:
        return f"{stage}: batch of {total} succeeded"
    head = ", ".join(f"#{i}: {type(e).__name__}: {e}"
                     for i, e in list(failures)[:3])
    more = f" (+{len(failures) - 3} more)" if len(failures) > 3 else ""
    return (f"{stage}: {len(failures)}/{total} batch items failed — "
            f"{head}{more}")

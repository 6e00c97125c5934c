"""The VL stack on PyTorch: the port of ``oar_ocr_tpu.vl``.

    from oar_ocr_tpu_torch.vl import (DocParser, FAMILY_CLASSES,
                                      HunyuanOCRModel, PaddleOCRVL)
"""

from .hunyuan import HunyuanOCRConfig, HunyuanOCRModel, HunyuanOCRSpeculative
from .model import ByteTokenizer, GenerationResult, HFTokenizer, PaddleOCRVL
from .paddleocr_vl import TASK_PROMPTS, PaddleOCRVLConfig

__all__ = [
    "ByteTokenizer", "GenerationResult", "HFTokenizer", "HunyuanOCRConfig",
    "HunyuanOCRModel", "HunyuanOCRSpeculative", "PaddleOCRVL",
    "PaddleOCRVLConfig", "TASK_PROMPTS",
]


def __getattr__(name):
    # lazy, as in the JAX package: the families and the parser pull in
    # the layout stack
    if name in ("FAMILY_CLASSES", "FAMILY_CONFIGS"):
        from . import families

        return getattr(families, name)
    if name == "DocParser":
        from .doc_parser import DocParser

        return DocParser
    raise AttributeError(name)

"""PaddleOCR-VL on PyTorch: the port of ``oar_ocr_tpu.vl``'s generate path.

    from oar_ocr_tpu_torch.vl import PaddleOCRVL
"""

from .model import ByteTokenizer, GenerationResult, PaddleOCRVL
from .paddleocr_vl import TASK_PROMPTS, PaddleOCRVLConfig

__all__ = [
    "ByteTokenizer", "GenerationResult", "PaddleOCRVL", "PaddleOCRVLConfig",
    "TASK_PROMPTS",
]

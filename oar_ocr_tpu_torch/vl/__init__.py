"""The VL stack on PyTorch: the port of ``oar_ocr_tpu.vl``'s generate paths.

    from oar_ocr_tpu_torch.vl import HunyuanOCRModel, PaddleOCRVL
"""

from .hunyuan import HunyuanOCRConfig, HunyuanOCRModel
from .model import ByteTokenizer, GenerationResult, PaddleOCRVL
from .paddleocr_vl import TASK_PROMPTS, PaddleOCRVLConfig

__all__ = [
    "ByteTokenizer", "GenerationResult", "HunyuanOCRConfig",
    "HunyuanOCRModel", "PaddleOCRVL", "PaddleOCRVLConfig", "TASK_PROMPTS",
]

"""Framework-wide constants.

Copied value for value from ``oar_ocr_tpu/core/constants.py:3-20`` (the
constants the port reads).
"""

# Recognizer canonical input shape [C, H, W].
REC_IMAGE_SHAPE = (3, 48, 320)
# Max recognizer input width after ratio padding.
REC_MAX_WIDTH = 3200
# Detector defaults.
DET_LIMIT_SIDE_LEN = 960
DET_MAX_SIDE_LEN = 4000
# Cross-image crop pool flush threshold.
MAX_POOLED_CROPS = 4096

# ImageNet normalization (DB detection).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

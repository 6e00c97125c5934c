"""MinerU model-native two-step layout parsing helpers.

Re-expresses oar-ocr-vl/examples/utils/mineru_layout.rs:1-195 and the
two-step flow of examples/mineru.rs:155-230 — shared by the MinerU and
MinerU-Diffusion families: step 1 runs `\\nLayout Detection:` on the page
resized to a 1036×1036 square and parses `<|box_start|>…` lines into
typed blocks; step 2 crops each recognizable block (applying the model's
rotate token), resizes it for the ViT factor, and recognizes it with the
block-type-specific prompt.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

LAYOUT_PROMPT = "\nLayout Detection:"
LAYOUT_IMAGE_SIZE = 1036          # square edge for the layout pass

_TABLE_PROMPT = "\nTable Recognition:"
_EQUATION_PROMPT = "\nFormula Recognition:"
_DEFAULT_PROMPT = "\nText Recognition:"

_LAYOUT_RE = re.compile(
    r"^<\|box_start\|>(\d+)\s+(\d+)\s+(\d+)\s+(\d+)<\|box_end\|>"
    r"<\|ref_start\|>(\w+?)<\|ref_end\|>(.*)$")

_BLOCK_TYPES = frozenset((
    "text", "title", "table", "image", "code", "algorithm", "header",
    "footer", "page_number", "page_footnote", "aside_text", "equation",
    "equation_block", "ref_text", "list", "phonetic", "table_caption",
    "image_caption", "code_caption", "table_footnote", "image_footnote",
    "unknown"))

# these block kinds are NOT re-recognized (mineru_layout.rs:151-156)
_SKIP_EXTRACT = frozenset(("image", "list", "equation_block"))

_ANGLE_TOKENS = (("<|rotate_up|>", 0), ("<|rotate_right|>", 90),
                 ("<|rotate_down|>", 180), ("<|rotate_left|>", 270))


@dataclass
class ContentBlock:
    """One detected layout block + optionally recognized content
    (mineru_layout.rs:27-34). ``bbox`` is normalized xyxy in [0, 1]."""

    block_type: str
    bbox: Tuple[float, float, float, float]
    angle: Optional[int] = None
    content: Optional[str] = None

    def to_json(self) -> dict:
        return {"type": self.block_type, "bbox": list(self.bbox),
                "angle": self.angle, "content": self.content}


def _normalize_bbox(x1: int, y1: int, x2: int, y2: int
                    ) -> Optional[Tuple[float, float, float, float]]:
    """0..1000 coordinate check + corner ordering (mineru_layout.rs:76)."""
    if any(not 0 <= v <= 1000 for v in (x1, y1, x2, y2)):
        return None
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))
    if x1 == x2 or y1 == y2:
        return None
    return (x1 / 1000.0, y1 / 1000.0, x2 / 1000.0, y2 / 1000.0)


def _parse_angle(tail: str) -> Optional[int]:
    for token, angle in _ANGLE_TOKENS:
        if token in tail:
            return angle
    return None


def parse_layout_output(output: str) -> List[ContentBlock]:
    """Raw layout-pass text → typed blocks (mineru_layout.rs:36-74)."""
    blocks: List[ContentBlock] = []
    for line in output.splitlines():
        m = _LAYOUT_RE.match(line)
        if m is None:
            continue
        try:
            coords = tuple(int(m.group(i)) for i in range(1, 5))
        except ValueError:
            continue
        bbox = _normalize_bbox(*coords)
        if bbox is None:
            continue
        ref_type = m.group(5).lower()
        if ref_type not in _BLOCK_TYPES:
            continue
        blocks.append(ContentBlock(block_type=ref_type, bbox=bbox,
                                   angle=_parse_angle(m.group(6))))
    return blocks


def prompt_for_block(block_type: str) -> str:
    """Per-type recognition prompt (mineru_layout.rs:189-194)."""
    if block_type == "table":
        return _TABLE_PROMPT
    if block_type == "equation":
        return _EQUATION_PROMPT
    return _DEFAULT_PROMPT


def prepare_for_extract(image: np.ndarray, blocks: Sequence[ContentBlock],
                        min_image_edge: int = 28,
                        max_image_edge_ratio: float = 50.0
                        ) -> Tuple[List[np.ndarray], List[str], List[int]]:
    """Crop each recognizable block from the ORIGINAL page, de-rotate by
    the detected angle, resize for the ViT factor, and pair it with its
    recognition prompt. Returns (crops, prompts, original block indices)
    (mineru_layout.rs:138-187)."""
    from .doc_parser import resize_for_mineru

    h, w = image.shape[:2]
    crops: List[np.ndarray] = []
    prompts: List[str] = []
    indices: List[int] = []
    for idx, block in enumerate(blocks):
        if block.block_type in _SKIP_EXTRACT:
            continue
        # f32::round is half-away-from-zero, not Python's banker's
        # rounding (mineru_layout.rs:159-167); coords are non-negative
        def _round(v: float) -> int:
            return int(np.floor(v + 0.5))

        x1 = int(np.clip(_round(block.bbox[0] * w), 0, w - 1))
        y1 = int(np.clip(_round(block.bbox[1] * h), 0, h - 1))
        x2 = int(np.clip(_round(block.bbox[2] * w), 0, w))
        y2 = int(np.clip(_round(block.bbox[3] * h), 0, h))
        if x2 <= x1 or y2 <= y1:
            continue
        crop = np.ascontiguousarray(image[y1:y2, x1:x2])
        if block.angle:
            # image::imageops rotate90 is CLOCKWISE; np.rot90 is CCW
            crop = np.ascontiguousarray(
                np.rot90(crop, k=-(block.angle // 90)))
        crops.append(resize_for_mineru(crop, min_image_edge,
                                       max_image_edge_ratio))
        prompts.append(prompt_for_block(block.block_type))
        indices.append(idx)
    return crops, prompts, indices


def run_two_step(family, image: np.ndarray, *,
                 max_new_tokens: int = 256, min_image_edge: int = 28,
                 max_image_edge_ratio: float = 50.0) -> List[ContentBlock]:
    """The full model-native two-step flow (examples/mineru.rs:155-230):
    layout on the 1036² resize, then per-block extraction with per-type
    prompts; table content runs OTSL→HTML, everything else gets the
    reference's repetition truncation + trim. Works with any family
    whose ``generate`` accepts a verbatim ``prompt`` (MinerU and
    MinerU-Diffusion)."""
    import cv2

    from .otsl import otsl_to_html
    from .sampling import truncate_repetition

    layout_img = cv2.resize(image, (LAYOUT_IMAGE_SIZE, LAYOUT_IMAGE_SIZE),
                            interpolation=cv2.INTER_CUBIC)
    layout_raw = family.generate([layout_img], family.cfg.tasks[0],
                                 max_new_tokens=max_new_tokens,
                                 prompt=LAYOUT_PROMPT)[0]
    blocks = parse_layout_output(layout_raw)
    if not blocks:
        return blocks
    crops, prompts, indices = prepare_for_extract(
        image, blocks, min_image_edge, max_image_edge_ratio)
    # one call per crop: crops differ wildly in shape, so batched prompts
    # would force worst-case padding (mineru.rs:190 note)
    for crop, prompt, idx in zip(crops, prompts, indices):
        content = family.generate([crop], family.cfg.tasks[0],
                                  max_new_tokens=max_new_tokens,
                                  prompt=prompt)[0]
        cleaned = truncate_repetition(content, min_len=10, min_repeats=10)
        if blocks[idx].block_type == "table":
            blocks[idx].content = otsl_to_html(cleaned)
        else:
            blocks[idx].content = cleaned.strip()
    return blocks

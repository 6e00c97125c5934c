"""PP-LCNet image classifiers: document orientation, text-line
orientation, table wired/wireless.

Counterpart of ``oar_ocr_tpu/models/classification/pp_lcnet.py``. The
classifier's input is one :func:`ops.warp.sample_transform` pass: each
item's 3×3 matrix (the resize_short 256 → center-crop 224 geometry, a
direct 80×160 resize, or a quad crop composed with that resize) samples
the resident uint8 page batch, and K1 normalizes the tile (ImageNet
mean/std, RGB) into the Runtime's compute dtype. The model, the softmax,
the argmax and the max run on the same device; only (class, score) pairs
come back to the host.

``ClassifierPreprocess.matrix`` and ``DirectResizePreprocess.matrix`` are
host copies (``pp_lcnet.py:47-94``); ``classify_quads`` composes the
quad→crop homography with the classifier resize as the JAX package does
(``pp_lcnet.py:160-186``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.warp import NormSpec, resize_matrix, sample_transform
from ...runtime.runtime import Runtime
from ...utils.tracing import stage_timer
from ..backbones import PPLCNetV3
from ..layers import hswish, init_state_dict, load_weights
from .pp_lcnet_exact import PPLCNetV1Cls


class PPLCNetClassifier(nn.Module):
    """LCNet trunk + 1280-wide head + softmax (``pp_lcnet.py:34-44``).
    Input (N, H, W, 3); output float32 probabilities. The flax module
    names its parts ``PPLCNetV3_0``, ``Dense_0`` and ``Dense_1``."""

    def __init__(self, num_classes: int, scale: float = 1.0,
                 head_width: int = 1280):
        super().__init__()
        self.PPLCNetV3_0 = PPLCNetV3(scale=scale)
        self.Dense_0 = nn.Linear(self.PPLCNetV3_0.out_channels, head_width)
        self.Dense_1 = nn.Linear(head_width, num_classes)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        feat = self.PPLCNetV3_0(x_nhwc.permute(0, 3, 1, 2))
        logits = self.Dense_1(hswish(self.Dense_0(feat)))
        return torch.softmax(logits.float(), dim=-1)


@dataclass(frozen=True)
class ClassifierPreprocess:
    """resize_short + center-crop geometry."""

    resize_short: int = 256
    crop_h: int = 224
    crop_w: int = 224

    def matrix(self, src_h: int, src_w: int) -> np.ndarray:
        """Affine matrix: output crop px → source px (half-pixel resize
        convention composed with the center-crop offset)."""
        scale = self.resize_short / float(min(src_h, src_w))
        rh, rw = src_h * scale, src_w * scale
        off_x = (rw - self.crop_w) / 2.0
        off_y = (rh - self.crop_h) / 2.0
        inv = 1.0 / scale
        # src = ((crop + off) + 0.5) * inv - 0.5
        return np.array(
            [[inv, 0.0, (off_x + 0.5) * inv - 0.5],
             [0.0, inv, (off_y + 0.5) * inv - 0.5],
             [0.0, 0.0, 1.0]], np.float32)


@dataclass(frozen=True)
class DirectResizePreprocess:
    """Plain resize to (h, w): text-line orientation models take a fixed
    80×160 input rather than resize_short/crop."""

    h: int = 80
    w: int = 160

    @property
    def crop_h(self):
        return self.h

    @property
    def crop_w(self):
        return self.w

    def matrix(self, src_h: int, src_w: int) -> np.ndarray:
        return resize_matrix(src_h, src_w, self.h, self.w)


class ImageClassifier:
    """Batched classifier over a resident uint8 page batch: whole pages
    (:meth:`classify_pages`) or perspective regions of them
    (:meth:`classify_quads`)."""

    def __init__(self, state_dict=None, *, num_classes: int,
                 scale: float = 1.0, preprocess=ClassifierPreprocess(),
                 runtime: Optional[Runtime] = None, name: str = "cls",
                 model_type: str = "pplcnet-v1"):
        """``state_dict``: port weights (``params_from_jax``); seeded
        random weights when None. ``model_type`` "pplcnet-v1" is the PULC
        checkpoint topology (:class:`PPLCNetV1Cls`, returning logits);
        anything else the LCNet trunk classifier (probabilities)."""
        self.runtime = runtime or Runtime()
        self.preprocess = preprocess
        self.name = name
        self._returns_logits = model_type == "pplcnet-v1"
        model = (PPLCNetV1Cls(num_classes, scale) if self._returns_logits
                 else PPLCNetClassifier(num_classes, scale))
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(0))
        self.model = load_weights(model, state_dict,
                                  dtype=self.runtime.compute_dtype,
                                  device=self.runtime.device)
        if self._returns_logits:
            self.model.apply_dtype_policy()

    @torch.no_grad()
    def _probs(self, pages_u8: torch.Tensor, mats: np.ndarray,
               idx: np.ndarray) -> torch.Tensor:
        """(N, classes) float32 probabilities on the device."""
        n = mats.shape[0]
        h, w = self.preprocess.crop_h, self.preprocess.crop_w
        put = self.runtime.put
        full = put(np.full((n,), max(h, w), np.int32))
        x = sample_transform(
            pages_u8, put(mats.astype(np.float32)), put(idx.astype(np.int64)),
            full, full, out_h=h, out_w=w, norm=NormSpec.imagenet_rgb(),
            out_dtype=self.runtime.compute_dtype, caller=self.name)
        out = self.model(x)
        if self._returns_logits:
            out = torch.softmax(out.float(), dim=-1)
        return out

    def _classify(self, pages_u8, mats, idx) -> List[Tuple[int, float]]:
        with stage_timer(f"{self.name}.device", batch=len(mats)):
            probs = self._probs(pages_u8, mats, idx)
            score, cls = torch.max(probs, dim=-1)
            cls, score = cls.cpu().numpy(), score.cpu().numpy()
        return [(int(c), float(s)) for c, s in zip(cls, score)]

    def page_inputs(self, shapes: Sequence[Tuple[int, int]],
                    page_indices: Optional[Sequence[int]] = None):
        """(matrices, page indices) of whole-page classification."""
        mats = np.stack([self.preprocess.matrix(h, w) for h, w in shapes])
        idx = np.asarray(page_indices if page_indices is not None
                         else np.arange(len(shapes)), np.int64)
        return mats, idx

    def quad_inputs(self, quads: Sequence[Tuple[int, np.ndarray]]):
        """(matrices, page indices) of region classification: each quad's
        homography from the upright crop to the page, composed with the
        classifier resize, so the region never materializes at its native
        size."""
        import cv2

        from ...ops.warp import crop_geometry

        mats, idxs = [], []
        for page_i, quad in quads:
            quad = np.asarray(quad, np.float32).reshape(4, 2)
            cw, ch, _ = crop_geometry(quad)
            pts_std = np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]], np.float32)
            m1 = cv2.getPerspectiveTransform(pts_std, quad)
            m2 = self.preprocess.matrix(ch, cw).astype(np.float64)
            mats.append((m1 @ m2).astype(np.float32))
            idxs.append(page_i)
        return np.stack(mats), np.asarray(idxs, np.int64)

    def probs_pages(self, pages_u8: torch.Tensor,
                    shapes: Sequence[Tuple[int, int]],
                    page_indices: Optional[Sequence[int]] = None
                    ) -> np.ndarray:
        """(N, classes) float32 probabilities of whole pages."""
        with torch.no_grad():
            return self._probs(pages_u8, *self.page_inputs(
                shapes, page_indices)).cpu().numpy()

    def probs_quads(self, pages_u8: torch.Tensor,
                    quads: Sequence[Tuple[int, np.ndarray]]) -> np.ndarray:
        """(N, classes) float32 probabilities of perspective regions."""
        with torch.no_grad():
            return self._probs(pages_u8,
                               *self.quad_inputs(quads)).cpu().numpy()

    def classify_pages(self, pages_u8: torch.Tensor,
                       shapes: Sequence[Tuple[int, int]],
                       page_indices: Optional[Sequence[int]] = None
                       ) -> List[Tuple[int, float]]:
        """Classify whole pages (doc orientation / table cls)."""
        return self._classify(pages_u8, *self.page_inputs(shapes,
                                                          page_indices))

    def classify_quads(self, pages_u8: torch.Tensor,
                       quads: Sequence[Tuple[int, np.ndarray]]
                       ) -> List[Tuple[int, float]]:
        """Classify perspective regions (text-line orientation on crops)."""
        if not quads:
            return []
        return self._classify(pages_u8, *self.quad_inputs(quads))


def doc_orientation_classifier(state_dict=None, runtime=None
                               ) -> ImageClassifier:
    """4-class page orientation, scale 1.0, resize_short 256 → 224²."""
    return ImageClassifier(state_dict, num_classes=4, scale=1.0,
                           preprocess=ClassifierPreprocess(),
                           runtime=runtime, name="doc_ori")


def textline_orientation_classifier(state_dict=None, runtime=None
                                    ) -> ImageClassifier:
    """2-class text-line orientation, 80×160 input, scale 0.25."""
    return ImageClassifier(state_dict, num_classes=2, scale=0.25,
                           preprocess=DirectResizePreprocess(80, 160),
                           runtime=runtime, name="line_ori")


def table_classifier(state_dict=None, runtime=None) -> ImageClassifier:
    """2-class wired/wireless table classification."""
    return ImageClassifier(state_dict, num_classes=2, scale=1.0,
                           preprocess=ClassifierPreprocess(),
                           runtime=runtime, name="table_cls")

"""UVDoc document rectification (unwarping).

Counterpart of ``oar_ocr_tpu/models/rectification/uvdoc.py``. The net
predicts a coarse 2-D sampling grid over the warped page; rectification
bilinearly remaps the page through the grid, upsampled to the page. One
:meth:`UVDocRectifier.rectify` runs on the Runtime's device from the
uploaded page to the rectified uint8 page:

1. the page is zero-padded to the detector's side buckets and uploaded;
2. ``ops/warp.sample_transform`` resamples it to the 712×488 input and
   K1 scales it by 1/255 into the compute dtype;
3. the net (:class:`~.uvdoc_exact.UVDocNetExact`) gives the float32 grid;
4. the grid is upsampled with align-corners at the page's own (h, w)
   inside the bucket (not stretched over the padding), mapped to source
   pixels, and the page is remapped in float32, rounded and clamped to
   uint8 (``ops/grid_sample``); only the page's own (h, w) comes back.

The legacy small :class:`UVDocNet` (``uvdoc.py:40-64``) comes along.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.grid_sample import grid_sample
from ...ops.warp import NormSpec, resize_matrix, sample_transform
from ...runtime.runtime import DET_SIDE_BUCKETS, Runtime, stack_padded
from ...utils.tracing import stage_timer
from ..backbones import same_pad
from ..layers import FrozenBatchNorm2d, conv_bn, init_state_dict, load_weights
from .uvdoc_exact import UVDOC_GRID_HW, UVDOC_INPUT_HW, UVDocNetExact


class _ConvBNReluSame(nn.Module):
    """``layers.ConvBNAct(act="relu")``: 3×3 conv (no bias, flax
    ``"SAME"`` padding) + BatchNorm + relu, flax auto names."""

    def __init__(self, in_c: int, out_c: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(in_c, out_c, 3, stride, bias=False)
        self.BatchNorm_0 = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = same_pad(x, 3, self.stride)
        return F.relu(conv_bn(x, self.Conv_0, self.BatchNorm_0))


class UVDocNet(nn.Module):
    """Legacy conv encoder → normalized sampling grid (N, gh, gw, 2) in
    [-1, 1]: seven conv-bn-relu to stride 16, a bilinear resize to the
    grid (antialiased when it shrinks, as ``jax.image.resize``), one
    conv-bn-relu, a 3×3 conv and tanh in float32."""

    def __init__(self, grid_hw: Tuple[int, int] = UVDOC_GRID_HW,
                 width: int = 32):
        super().__init__()
        w = width
        self.grid_hw = grid_hw
        plan = [(3, w, 2), (w, w * 2, 2), (w * 2, w * 2, 1),
                (w * 2, w * 4, 2), (w * 4, w * 4, 1), (w * 4, w * 8, 2),
                (w * 8, w * 8, 1), (w * 8, w * 4, 1)]
        for i, (cin, cout, s) in enumerate(plan):
            setattr(self, f"ConvBNAct_{i}", _ConvBNReluSame(cin, cout, s))
        self.Conv_0 = nn.Conv2d(w * 4, 2, 3)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for i in range(7):
            x = getattr(self, f"ConvBNAct_{i}")(x)
        if tuple(x.shape[2:]) != tuple(self.grid_hw):
            x = F.interpolate(x, size=self.grid_hw, mode="bilinear",
                              align_corners=False, antialias=True)
        x = self.ConvBNAct_7(x)
        grid = self.Conv_0(same_pad(x, 3, 1))
        return torch.tanh(grid.float()).permute(0, 2, 3, 1)


class UVDocRectifier:
    """Page → rectified page on the Runtime's device."""

    def __init__(self, state_dict=None, *, runtime: Optional[Runtime] = None,
                 model_type: str = "uvdoc-exact", num_filter: int = 32):
        """``state_dict``: port weights (``params_from_jax``); seeded
        random weights when None."""
        self.runtime = runtime or Runtime()
        model = (UVDocNetExact(num_filter=num_filter)
                 if model_type == "uvdoc-exact" else UVDocNet())
        if state_dict is None:
            state_dict = init_state_dict(model,
                                         torch.Generator().manual_seed(0))
        self.model = load_weights(model, state_dict,
                                  dtype=self.runtime.compute_dtype,
                                  device=self.runtime.device)

    @torch.no_grad()
    def grid(self, pages_u8: torch.Tensor, mats: np.ndarray) -> torch.Tensor:
        """The net's float32 (n, gh, gw, 2) grid for pages resampled by
        ``mats`` to the 712×488 input (K1: x/255 into the compute dtype)."""
        ih, iw = UVDOC_INPUT_HW
        n = mats.shape[0]
        put = self.runtime.put
        x = sample_transform(
            pages_u8, put(mats.astype(np.float32)),
            put(np.zeros((n,), np.int64)), put(np.full((n,), iw, np.int32)),
            put(np.full((n,), ih, np.int32)), out_h=ih, out_w=iw,
            norm=NormSpec(alpha=(1 / 255.0,) * 3, beta=(0.0,) * 3),
            out_dtype=self.runtime.compute_dtype, caller="uvdoc")
        grid = self.model(x)
        return grid[0] if isinstance(grid, tuple) else grid

    @torch.no_grad()
    def remap(self, pages_u8: torch.Tensor, grid: torch.Tensor,
              src_h: int, src_w: int) -> torch.Tensor:
        """Upsample ``grid`` over the page's own (src_h, src_w) extent of
        the bucketed buffer (align-corners, per-page scale; a resize to
        the buffer would stretch it over the padding) and remap the page
        through it: (n, H, W, 3) uint8, rounded and clamped."""
        n, out_h, out_w, _ = pages_u8.shape
        gh, gw = grid.shape[1:3]
        dev = pages_u8.device
        hf = torch.full((n, 1, 1), max(src_h - 1.0, 1.0), device=dev)
        wf = torch.full((n, 1, 1), max(src_w - 1.0, 1.0), device=dev)
        iy = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
        ix = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
        gcoords = torch.stack(
            [(ix * ((gw - 1) / wf)).expand(n, out_h, out_w),
             (iy * ((gh - 1) / hf)).expand(n, out_h, out_w)], dim=-1)
        up = grid_sample(grid, gcoords)                        # (n,oh,ow,2)
        unit = (up + 1.0) * 0.5                                # [0,1] units
        coords = torch.stack([unit[..., 0] * wf, unit[..., 1] * hf], dim=-1)
        out = grid_sample(pages_u8, coords)
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)

    def rectify(self, image: np.ndarray) -> np.ndarray:
        """Rectify one HWC uint8 page; the output has the same size."""
        h, w = image.shape[:2]
        bh, bw = DET_SIDE_BUCKETS.bucket(h), DET_SIDE_BUCKETS.bucket(w)
        with stage_timer("uvdoc.device", hw=(h, w)):
            page = self.runtime.put(stack_padded([image], (bh, bw)))
            grid = self.grid(page, resize_matrix(h, w, *UVDOC_INPUT_HW)[None])
            out = self.remap(page, grid, h, w)[0, :h, :w].cpu().numpy()
        return out

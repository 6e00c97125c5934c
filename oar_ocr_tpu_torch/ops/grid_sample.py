"""Batched bilinear grid sampling (the displacement-grid remap).

Counterpart of ``oar_ocr_tpu/ops/grid_sample.py`` (:19-69), plain
PyTorch as it is XLA in the JAX package: a gather of the four neighbours
with the COORDINATE clamped to the border before the floor, the
convention of ``ops/warp.sample_pixels``. ``F.grid_sample`` is not used:
its align-corners and border conventions differ, and it is a library
kernel.
"""

from __future__ import annotations

import torch


def grid_sample(images: torch.Tensor, coords: torch.Tensor, *,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sample ``images`` (N, H, W, C) at per-pixel ``coords``
    (N, Ho, Wo, 2) given as absolute (x, y) source pixel positions.
    Border-clamped; the blend is float32."""
    n, h, w, c = images.shape
    _, ho, wo, _ = coords.shape
    sx = torch.clamp(coords[..., 0].reshape(n, -1), 0.0, w - 1.0)
    sy = torch.clamp(coords[..., 1].reshape(n, -1), 0.0, h - 1.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)

    flat = images.reshape(n * h * w, c)
    base = (torch.arange(n, device=images.device) * h)[:, None]

    def fetch(yi, xi):
        return flat[((base + yi) * w + xi).reshape(-1)].reshape(
            n, -1, c).float()

    top = fetch(y0i, x0i) * (1.0 - fx) + fetch(y0i, x1i) * fx
    bot = fetch(y1i, x0i) * (1.0 - fx) + fetch(y1i, x1i) * fx
    out = top * (1.0 - fy) + bot * fy
    return out.reshape(n, ho, wo, c).to(out_dtype)


def normalized_grid_to_pixels(grid: torch.Tensor, h: int,
                              w: int) -> torch.Tensor:
    """A [-1, 1]-normalized (…, 2) sampling grid → absolute pixel
    coordinates (align_corners convention: -1 → 0, +1 → size-1)."""
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    return torch.stack([gx, gy], dim=-1)

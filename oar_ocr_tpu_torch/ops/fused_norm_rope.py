"""Fused RMSNorm kernels: K3 (residual add + RMSNorm) and K4 (qk-norm +
rotary), each with its plain version.

Counterpart of ``oar_ocr_tpu/ops/fused_norm_rope.py``. The K3 CUDA kernel
(``csrc/add_rmsnorm.cu``) replaces the Pallas ``_add_rmsnorm_kernel``:

    s = x + residual                  (float32)
    returns (s·rsqrt(mean(s²) + eps)·scale, s), each rounded once to
    x's dtype

— the layer-boundary residual add + RMSNorm pair of a pre-norm decoder.
The kernel picks its path from the row count: below the card's SM count
(decode: one or two rows) a CTA of 128 threads per row, above it a warp
per row. Either way each thread reads its part of x and r once, as
16-byte vectors, and keeps the sum in registers through the reduction;
a width that is not a multiple of the vector or an input not 16-byte
aligned takes a scalar loop. A tensor on the CPU takes
:func:`add_rmsnorm_ref`, the JAX module's XLA form
(``fused_norm_rope.py:50-55``); a CUDA tensor launches the kernel, and a
failed build or launch raises. ``KERNEL.launches`` counts launches.

The K4 CUDA kernel (``csrc/qk_norm_rope.cu``) replaces the Pallas
``_qk_norm_rope_kernel``: on (R, T, D) q or k rows,

    n = x·rsqrt(mean(x²) + eps)·scale           (float32)
    returns [n1·cos − n2·sin, n2·cos + n1·sin]  rounded once to x's dtype

— the per-head RMSNorm and half-split rotary of a decoder with qk-norm
(HunyuanOCR). A CPU tensor takes :func:`qk_norm_rope_ref`;
``KERNEL_QK.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..errors import InvalidInputError, UnsupportedError
from .cuda_build import CudaKernel

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "add_rmsnorm", "add_rmsnorm.cu", "oar_add_rmsnorm",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="oar_ocr_tpu/ops/fused_norm_rope.py:38")

KERNEL_QK = CudaKernel(
    "qk_norm_rope", "qk_norm_rope.cu", "oar_qk_norm_rope",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="oar_ocr_tpu/ops/fused_norm_rope.py:91")


def add_rmsnorm_ref(x: torch.Tensor, residual: torch.Tensor,
                    scale: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device)."""
    s = x.float() + residual.float()
    var = s.square().mean(dim=-1, keepdim=True)
    normed = s * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype), s.to(x.dtype)


def fused_add_rmsnorm(x: torch.Tensor, residual: torch.Tensor,
                      scale: torch.Tensor, *, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, residual (..., D) and scale (D,), all of one dtype. Returns
    (rmsnorm(x + residual)·scale, x + residual)."""
    d = x.shape[-1]
    if residual.shape != x.shape or tuple(scale.shape) != (d,):
        raise InvalidInputError("fused_add_rmsnorm expects x, residual "
                                "(..., D) and scale (D,)",
                                x=tuple(x.shape), residual=tuple(
                                    residual.shape), scale=tuple(scale.shape))
    if not (x.dtype == residual.dtype == scale.dtype) \
            or x.dtype not in _KINDS:
        raise InvalidInputError("fused_add_rmsnorm takes float32 or "
                                "bfloat16 x, residual and scale of one "
                                "dtype", dtype=str(x.dtype),
                                scale_dtype=str(scale.dtype))
    if residual.device != x.device:
        raise InvalidInputError("fused_add_rmsnorm takes x and residual on "
                                "one device", x=str(x.device),
                                residual=str(residual.device))
    if x.device.type == "cpu":
        return add_rmsnorm_ref(x, residual, scale, eps)
    if x.device.type != "cuda":
        raise UnsupportedError("fused_add_rmsnorm runs on CPU or CUDA "
                               "tensors", device=str(x.device))
    x, residual = x.contiguous(), residual.contiguous()
    scale = scale.to(x.device).contiguous()
    normed, total = torch.empty_like(x), torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return normed, total
    KERNEL.launch(x.data_ptr(), residual.data_ptr(), scale.data_ptr(),
                  normed.data_ptr(), total.data_ptr(), _KINDS[x.dtype], rows,
                  d, float(eps),
                  torch.cuda.current_stream(x.device).cuda_stream,
                  what=f"rows {rows} x {d} {x.dtype}")
    return normed, total


def qk_norm_rope_ref(x: torch.Tensor, scale: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version (any device), the JAX module's XLA form
    (``fused_norm_rope.py:106-115``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps) * scale.float()
    d2 = xf.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    c, s = cos.float()[None], sin.float()[None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def fused_qk_norm_rope(x: torch.Tensor, scale: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """x (R, T, D) q or k rows (R = batch·heads), scale (D,) of x's dtype,
    float32 cos/sin (T, D/2). Returns the normed and rotated rows, (R, T,
    D) contiguous in x's dtype. x may be a strided view whose last axis is
    contiguous (the kernel reads through its strides)."""
    if x.ndim != 3 or x.shape[-1] % 2:
        raise InvalidInputError("fused_qk_norm_rope expects x (R, T, D) "
                                "with D even", x=tuple(x.shape))
    r, t, d = x.shape
    if tuple(scale.shape) != (d,) or tuple(cos.shape) != (t, d // 2) \
            or tuple(sin.shape) != (t, d // 2):
        raise InvalidInputError("fused_qk_norm_rope expects scale (D,) and "
                                "cos, sin (T, D/2)", x=tuple(x.shape),
                                scale=tuple(scale.shape),
                                cos=tuple(cos.shape), sin=tuple(sin.shape))
    if x.dtype not in _KINDS or scale.dtype != x.dtype \
            or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise InvalidInputError("fused_qk_norm_rope takes float32 or "
                                "bfloat16 x with scale of its dtype and "
                                "float32 cos, sin", dtype=str(x.dtype),
                                scale_dtype=str(scale.dtype),
                                cos_dtype=str(cos.dtype),
                                sin_dtype=str(sin.dtype))
    if not (x.device == scale.device == cos.device == sin.device):
        raise InvalidInputError("fused_qk_norm_rope takes x, scale, cos and "
                                "sin on one device", devices=[
                                    str(a.device) for a in (x, scale, cos,
                                                            sin)])
    if x.device.type == "cpu":
        return qk_norm_rope_ref(x, scale, cos, sin, eps)
    if x.device.type != "cuda":
        raise UnsupportedError("fused_qk_norm_rope runs on CPU or CUDA "
                               "tensors", device=str(x.device))
    if d > 256:
        raise UnsupportedError("the qk-norm+rope kernel takes D <= 256",
                               head_dim=d)
    if x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty((r, t, d), dtype=x.dtype, device=x.device)
    if r * t == 0:
        return out
    KERNEL_QK.launch(x.data_ptr(), scale.contiguous().data_ptr(),
                     cos.contiguous().data_ptr(), sin.contiguous().data_ptr(),
                     out.data_ptr(), _KINDS[x.dtype], r, t, d, x.stride(0),
                     x.stride(1), float(eps),
                     torch.cuda.current_stream(x.device).cuda_stream,
                     what=f"x {tuple(x.shape)} {x.dtype}")
    return out

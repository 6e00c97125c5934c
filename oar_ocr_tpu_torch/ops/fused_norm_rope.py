"""Fused residual add + RMSNorm: the K3 kernel and its plain version.

Counterpart of ``oar_ocr_tpu/ops/fused_norm_rope.py``. The CUDA kernel
(``csrc/add_rmsnorm.cu``) replaces the Pallas ``_add_rmsnorm_kernel``:

    s = x + residual                  (float32)
    returns (s·rsqrt(mean(s²) + eps)·scale, s), each rounded once to
    x's dtype

— the layer-boundary residual add + RMSNorm pair of a pre-norm decoder.
A tensor on the CPU takes :func:`add_rmsnorm_ref`, the JAX module's XLA
form (``fused_norm_rope.py:50-55``); a CUDA tensor launches the kernel,
and a failed build or launch raises. ``KERNEL.launches`` counts launches.

The module's second Pallas kernel, ``_qk_norm_rope_kernel`` (per-head
RMSNorm then rotary, for decoders with qk-norm), is ported with the
qk-norm decoder slice (HunyuanOCR); until then
:func:`fused_qk_norm_rope` raises ``UnsupportedError``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from oar_ocr_tpu.errors import InvalidInputError, UnsupportedError

from .cuda_build import CudaKernel

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "add_rmsnorm", "add_rmsnorm.cu", "oar_add_rmsnorm",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="oar_ocr_tpu/ops/fused_norm_rope.py:38")


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


def fused_qk_norm_rope(x: torch.Tensor, scale: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm → rotary (``fused_norm_rope.py:91``): ported with
    the qk-norm decoder slice."""
    raise UnsupportedError("fused_qk_norm_rope (K4) is ported with the "
                           "qk-norm decoder slice (HunyuanOCR)")

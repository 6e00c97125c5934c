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
(HunyuanOCR). :func:`fused_qk_norm_rope_qk` is the decoder's form: one
launch covers the q and k heads of every batch row, each with its own
row's tables, reads the projections through their strides and writes k
through ``k_out``'s, straight into the KV-cache slot. The slot is either
fixed by the caller's view (prefill) or a device scalar ``slot`` that
the kernel reads (decode), so a launch captured into a CUDA graph
writes the slot the graph has advanced to at every replay, or a (B,)
device vector of per-row slots (the HPD scheduler's branches, each at
its own depth), each start clamped as the scalar's is.
:func:`fused_qk_norm_rope` keeps the JAX signature (one (R, T, D) tensor,
shared tables) on the same kernel. A CPU tensor takes the plain version
(:func:`qk_norm_rope_qk_ref`, :func:`qk_norm_rope_ref`); a CUDA tensor
launches the kernel or raises. ``KERNEL_QK.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 9
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
                  device=x.device, what=f"rows {rows} x {d} {x.dtype}")
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


def row_slot_indices(slot: torch.Tensor, t: int,
                     slots: int) -> torch.Tensor:
    """The (B, t) int64 indices [s_b, s_b + t) of each row for the (B,)
    per-row slots ``slot``, each start clamped to [0, slots − t] (the JAX
    cache's vmapped write, ``oar_ocr_tpu/vl/kv_cache.py:85-93``)."""
    start = slot.to(torch.int64).clamp(0, slots - t)
    return start[:, None] + torch.arange(t, device=slot.device)


def slot_indices(slot: torch.Tensor, t: int, slots: int) -> torch.Tensor:
    """The (t,) int64 indices [s, s + t) along a cache's slot axis of
    ``slots`` entries for the 0-d int64 device slot ``slot``, its start
    clamped to [0, slots − t] as ``lax.dynamic_update_slice`` clamps
    (the JAX cache's write, ``oar_ocr_tpu/vl/kv_cache.py:68-86``)."""
    start = slot.clamp(0, slots - t).view(1)
    return start if t == 1 else start + torch.arange(t, device=slot.device)


def _launch_qk(q, k, q_scale, k_scale, cos, sin, q_out, k_out, eps,
               what: str, slot=None) -> None:
    """One K4 launch over q (B, T, Hq, D) and k (B, T, Hk, D) views
    (``k`` None for Hk = 0), cos/sin (B, T, D/2), q_out (B, Hq, T, D)
    contiguous, k_out (B, Hk, T, D) with D contiguous, or (B, Hk, C, D)
    written from the device slot ``slot`` on (0-d: every row's; (B,):
    each row's own)."""
    b, t, hq, d = q.shape
    if d > 256:
        raise UnsupportedError("the qk-norm+rope kernel takes D <= 256",
                               head_dim=d)
    if k is None:
        k, k_scale, k_out, hk = q, q_scale, q_out, 0
    else:
        hk = k.shape[2]
    KERNEL_QK.launch(q.data_ptr(), k.data_ptr(), q_scale.data_ptr(),
                     k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                     q_out.data_ptr(), k_out.data_ptr(),
                     None if slot is None else slot.data_ptr(),
                     # the slot's stride: 0 for a scalar, 1 per row
                     int(slot is not None and slot.ndim == 1),
                     _KINDS[q.dtype], b, t, hq, hk, d, k_out.shape[2],
                     *q.stride()[:3], *k.stride()[:3], *k_out.stride()[:3],
                     float(eps),
                     torch.cuda.current_stream(q.device).cuda_stream,
                     device=q.device, what=what)


def fused_qk_norm_rope(x: torch.Tensor, scale: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """The JAX signature: x (R, T, D) q or k rows (R = batch·heads),
    scale (D,) of x's dtype, float32 cos/sin (T, D/2). Returns the normed
    and rotated rows, (R, T, D) contiguous in x's dtype. x may be a
    strided view whose last axis is contiguous (the kernel reads through
    its strides)."""
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
    _check_qk_types("fused_qk_norm_rope", x, scale, cos, sin)
    if x.device.type == "cpu":
        return qk_norm_rope_ref(x, scale, cos, sin, eps)
    if x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty((r, t, d), dtype=x.dtype, device=x.device)
    if r * t == 0:
        return out
    # (R, T, D) is the one-launch form's (1, T, R, D) with no k heads
    _launch_qk(x.transpose(0, 1)[None], None, scale.contiguous(), None,
               cos.contiguous(), sin.contiguous(), out, None, eps,
               what=f"x {tuple(x.shape)} {x.dtype}")
    return out


def qk_norm_rope_qk_ref(q: torch.Tensor, k: torch.Tensor,
                        q_scale: torch.Tensor, k_scale: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor, *,
                        k_out: torch.Tensor,
                        slot: Optional[torch.Tensor] = None,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_qk_norm_rope_qk` (any
    device): :func:`qk_norm_rope_ref` per batch row on q and on k, then
    k's copy into ``k_out``, or into its slots from ``slot`` on
    (:func:`slot_indices`; a (B,) ``slot``: each row's from its own,
    :func:`row_slot_indices`)."""
    qs, ks = [], []
    for i in range(q.shape[0]):
        qs.append(qk_norm_rope_ref(q[i].transpose(0, 1), q_scale, cos[i],
                                   sin[i], eps))
        ks.append(qk_norm_rope_ref(k[i].transpose(0, 1), k_scale, cos[i],
                                   sin[i], eps))
    if slot is None:
        k_out.copy_(torch.stack(ks))
    elif slot.ndim == 1:
        idx = row_slot_indices(slot, q.shape[1], k_out.shape[2])
        for i in range(q.shape[0]):
            k_out[i].index_copy_(1, idx[i], ks[i])
    else:
        k_out.index_copy_(2, slot_indices(slot, q.shape[1], k_out.shape[2]),
                          torch.stack(ks))
    return torch.stack(qs)


def fused_qk_norm_rope_qk(q: torch.Tensor, k: torch.Tensor,
                          q_scale: torch.Tensor, k_scale: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor, *,
                          k_out: torch.Tensor,
                          slot: Optional[torch.Tensor] = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """A decoder layer's K4 site in one launch: q (B, T, Hq, D) and k
    (B, T, Hk, D), the projections' outputs viewed per head (read through
    their strides, D contiguous), each head RMS-normed with q_scale or
    k_scale (D,) and rotated by its batch row's float32 cos/sin
    (B, T, D/2). k goes into ``k_out`` (B, Hk, T, D), which may be a
    strided view such as a KV-cache slot; with ``slot``, a 0-d int64
    tensor on q's device, ``k_out`` is (B, Hk, C, D), such as a layer's
    whole cache, and k goes to its slots from ``slot`` on, read on the
    device (:func:`slot_indices`); a (B,) int64 ``slot`` gives each row
    its own (:func:`row_slot_indices`). q comes back as a contiguous
    (B, Hq, T, D) tensor, all in q's dtype."""
    if q.ndim != 4 or k.ndim != 4:
        raise InvalidInputError("fused_qk_norm_rope_qk expects q (B, T, Hq, "
                                "D) and k (B, T, Hk, D)", q=tuple(q.shape),
                                k=tuple(k.shape))
    b, t, hq, d = q.shape
    hk = k.shape[2]
    slots = t if slot is None else k_out.shape[2]
    if d % 2 or tuple(k.shape) != (b, t, hk, d) \
            or tuple(k_out.shape) != (b, hk, slots, d) or slots < t \
            or tuple(q_scale.shape) != (d,) or tuple(k_scale.shape) != (d,) \
            or tuple(cos.shape) != (b, t, d // 2) \
            or tuple(sin.shape) != (b, t, d // 2):
        raise InvalidInputError(
            "fused_qk_norm_rope_qk expects q (B, T, Hq, D), k (B, T, Hk, D) "
            "with D even, k_out (B, Hk, T, D), or (B, Hk, C >= T, D) with a "
            "slot, scales (D,) and cos, sin (B, T, D/2)", q=tuple(q.shape),
            k=tuple(k.shape),
            k_out=tuple(k_out.shape), q_scale=tuple(q_scale.shape),
            k_scale=tuple(k_scale.shape), cos=tuple(cos.shape),
            sin=tuple(sin.shape))
    _check_qk_types("fused_qk_norm_rope_qk", q, q_scale, cos, sin,
                    k, k_scale, k_out)
    if slot is not None and (tuple(slot.shape) not in ((), (b,))
                             or slot.dtype != torch.int64
                             or slot.device != q.device):
        raise InvalidInputError("fused_qk_norm_rope_qk takes its slot as a "
                                "0-d or (B,) int64 tensor on q's device",
                                slot_shape=tuple(slot.shape),
                                slot_dtype=str(slot.dtype),
                                slot_device=str(slot.device))
    if q.device.type == "cpu":
        return qk_norm_rope_qk_ref(q, k, q_scale, k_scale, cos, sin,
                                   k_out=k_out, slot=slot, eps=eps)
    if k_out.stride(-1) != 1:
        raise InvalidInputError("fused_qk_norm_rope_qk writes k_out through "
                                "its strides and needs D contiguous",
                                k_out_strides=tuple(k_out.stride()))
    q = q if q.stride(-1) == 1 else q.contiguous()
    k = k if k.stride(-1) == 1 else k.contiguous()
    q_out = torch.empty((b, hq, t, d), dtype=q.dtype, device=q.device)
    if b * t == 0:
        return q_out
    _launch_qk(q, k, q_scale.contiguous(), k_scale.contiguous(),
               cos.contiguous(), sin.contiguous(), q_out, k_out, eps,
               what=f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}",
               slot=None if slot is None else slot.contiguous())
    return q_out


def _check_qk_types(name: str, x: torch.Tensor, scale: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor,
                    *same: torch.Tensor) -> None:
    """x float32 or bfloat16 with ``scale`` and every tensor of ``same``
    of its dtype, float32 cos and sin, all on one CPU or CUDA device."""
    if x.dtype not in _KINDS or any(a.dtype != x.dtype
                                    for a in (scale, *same)) \
            or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise InvalidInputError(f"{name} takes float32 or bfloat16 rows "
                                "with scales of their dtype and float32 "
                                "cos, sin", dtype=str(x.dtype),
                                others=[str(a.dtype) for a in (scale, *same)],
                                cos_dtype=str(cos.dtype),
                                sin_dtype=str(sin.dtype))
    tensors = (x, scale, cos, sin, *same)
    if any(a.device != x.device for a in tensors):
        raise InvalidInputError(f"{name} takes its tensors on one device",
                                devices=[str(a.device) for a in tensors])
    if x.device.type not in ("cpu", "cuda"):
        raise UnsupportedError(f"{name} runs on CPU or CUDA tensors",
                               device=str(x.device))

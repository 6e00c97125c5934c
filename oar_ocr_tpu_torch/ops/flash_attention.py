"""Blockwise (flash) attention: the K2 kernel and its plain version.

Counterpart of ``oar_ocr_tpu/ops/flash_attention.py``. The CUDA kernels
(``csrc/flash_attention.cu``) replace the Pallas ``_flash_kernel`` and
compute softmax(q·kᵀ/√D + mask)·v over (B, H, T, D) tensors (H = the kv
heads after any GQA repeat) with the online-softmax recurrence, so the
(Tq, Tk) score matrix never exists in device memory. The mask is
``key < valid_len[b]`` and, when ``causal``, ``key <= query``; a row
whose keys are all masked outputs exactly 0.

- **bfloat16** runs on the tensor cores (``flash_wgmma_kernel``): wgmma
  for q·kᵀ and for P·v, K and V streamed by TMA, softmax in registers.
  Its bound is operations — 4·T²·D per head at 989 TFLOP/s — and, at
  D = 72, the T² exponentials nearly as much; the exponentials of one key
  block run while the tensor cores do P·v of the block before. P is
  rounded to bfloat16 for P·v, as the JAX fallback rounds its weights to
  ``v.dtype``.
- **float32** runs float32 FMAs (``flash_fma_kernel``), bound by
  operations at 67 TFLOP/s; kept off the tensor cores on purpose, since
  TF32 would round q, k and v to 10 bits. Each thread holds a register
  tile of scores (several query rows × several keys) fed by 128-bit
  shared-memory loads, P goes through shared memory for P·v, K and V
  stream through a ``cp.async`` ring, the softmax runs in registers with
  exp2 and shuffles, and causal grids launch their longest query tiles
  first.

Both read q, k and v through their (batch, head, token) strides — the
towers pass transposed (B, T, H, D) projections — and write the output in
(B, T, H, D) memory, returned as the (B, H, T, D) view, so neither side
of the call copies. :func:`kernel_strides` computes the strides the
kernel is passed and refuses a layout the kernels cannot read: TMA's
16-byte rule for bfloat16, and the same for the 16-byte ``cp.async``
copies and vector loads of float32.

A tensor on the CPU takes :func:`flash_attention_ref`, the JAX module's
XLA fallback (``flash_attention.py:118-134``): −1e30 masking, a float32
softmax, fully-masked rows zeroed, weights cast to ``v.dtype`` before PV.
A CUDA tensor launches a kernel at every length, and a failed build or
launch raises. ``KERNEL.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..errors import InvalidInputError, UnsupportedError
from .cuda_build import CudaKernel

_NEG_INF = -1e30
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# the template instances in the source, by dtype: float32 also has D = 80
# (MinerU's float32 tower), bfloat16 not (no bfloat16 caller runs it)
KERNEL_HEAD_DIMS = (64, 72, 80, 128)
_HEAD_DIMS = {torch.float32: KERNEL_HEAD_DIMS,
              torch.bfloat16: (64, 72, 128)}
_ALIGN = 16                    # byte strides and base addresses (TMA, cp.async)

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "oar_flash_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    replaces="oar_ocr_tpu/ops/flash_attention.py:33")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, valid_len: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version (any device): q (B, H, Tq, D), k/v
    (B, H, Tk, D), valid_len (B,) valid key count."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    mask = None
    if valid_len is not None:
        keys = torch.arange(tk, device=q.device)[None, :]
        mask = (keys < valid_len.to(q.device)[:, None])[:, None, None, :]
    if causal:
        cm = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        mask = cm[None, None] if mask is None else (mask & cm)
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(logits.float(), dim=-1)
    if mask is not None:
        w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)
    return torch.matmul(w.to(v.dtype), v)


def kernel_strides(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> Tuple[int, ...]:
    """The (batch, head, token) element strides of q, k and v, in turn,
    that the kernel reads them through. The last axis must be unit-stride,
    and every stride in bytes and every base address a multiple of 16
    (TMA's rule for bfloat16; the 16-byte ``cp.async`` copies and vector
    loads of float32); anything else raises :class:`InvalidInputError` — the
    wrapper never copies to make a layout fit. The stride of an axis of
    size 1 is never followed, so it is given as the contiguous one."""
    out = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        shape = t.shape
        contiguous = (shape[1] * shape[2] * shape[3], shape[2] * shape[3],
                      shape[3])
        strides = [t.stride(a) if shape[a] > 1 else contiguous[a]
                   for a in range(3)]
        if (shape[3] > 1 and t.stride(3) != 1) \
                or any(s < 0 or (s * size) % _ALIGN for s in strides) \
                or t.data_ptr() % _ALIGN:
            raise InvalidInputError(
                "flash_attention reads a (B, H, T, D) view with unit stride "
                f"in D and strides and base address in multiples of "
                f"{_ALIGN} bytes", tensor=name, shape=tuple(shape),
                stride=tuple(t.stride()), byte_offset=t.data_ptr() % _ALIGN)
        out.extend(strides)
    return tuple(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    valid_len: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention over (B, H, T, D) tensors with per-batch key lengths;
    output (B, H, Tq, D) in q's dtype. On the card it is a view of
    (B, Tq, H, D) memory."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise InvalidInputError("flash_attention expects q (B, H, Tq, D) "
                                "and k, v (B, H, Tk, D)", q=tuple(q.shape),
                                k=tuple(k.shape), v=tuple(v.shape))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KINDS:
        raise InvalidInputError("flash_attention takes float32 or bfloat16 "
                                "q, k, v of one dtype", dtype=str(q.dtype))
    if not (q.device == k.device == v.device):
        raise InvalidInputError("flash_attention takes q, k, v on one device",
                                devices=[str(t.device) for t in (q, k, v)])
    b, h, tq, d = q.shape
    if valid_len is not None and tuple(valid_len.shape) != (b,):
        raise InvalidInputError("valid_len must be (B,)",
                                shape=tuple(valid_len.shape))
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, valid_len=valid_len,
                                   causal=causal)
    if q.device.type != "cuda":
        raise UnsupportedError("flash_attention runs on CPU or CUDA tensors",
                               device=str(q.device))
    if d not in _HEAD_DIMS[q.dtype]:
        raise UnsupportedError("the flash kernel is built for head dims "
                               f"{_HEAD_DIMS[q.dtype]} in {q.dtype}",
                               head_dim=d)
    strides = (ctypes.c_longlong * 9)(*kernel_strides(q, k, v))
    out = torch.empty((b, tq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if tq == 0 or k.shape[2] == 0:
        return out.zero_()         # no keys: every row is fully masked
    vl = None
    if valid_len is not None:
        vl = valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  vl.data_ptr() if vl is not None else None,
                  _KINDS[q.dtype], b, h, tq, k.shape[2], d,
                  ctypes.addressof(strides), 1.0 / math.sqrt(d),
                  int(bool(causal)),
                  torch.cuda.current_stream(q.device).cuda_stream,
                  what=f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    return out

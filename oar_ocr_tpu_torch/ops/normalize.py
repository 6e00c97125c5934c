"""Fused per-channel image normalize: the K1 kernel and its plain version.

Counterpart of ``oar_ocr_tpu/ops/normalize.py``. The CUDA kernel
(``csrc/normalize.cu``) replaces the Pallas ``_normalize_kernel`` and
computes, on contiguous NHWC tensors with C = 3,

    out[b, y, x, c] = in[b, y, x, swap(c)] * alpha[c] + beta[c]

with ``alpha = scale / std`` and ``beta = -mean / std``; optionally only
inside per-image valid extents ``valid_h``/``valid_w``, with ``pad``
elsewhere. ``swap_rb`` swaps the channel DATA, not only the
coefficients (the JAX package's 3bc1760 fix, ``normalize.py:126-133``).

Two entry points share the kernel:

- :func:`normalize_images`: the JAX signature, uint8 pages in;
- :func:`normalize_masked`: f32 resample output in, with the pad mask —
  what ``det_device.separable_resize_normalize`` (pad 0) and
  ``warp.warp_rec_tiles_separable`` (pad β) call on the main path.

A tensor on the CPU takes :func:`normalize_ref`, the plain PyTorch
version; a CUDA tensor launches the kernel, and a failed build or launch
raises. ``KERNEL.launches`` counts kernel launches, and
:data:`LAUNCHES_BY_CALLER` splits the same count by the ``caller`` each
launch names (``det``, ``rec``, ``doc_ori``, ``line_ori``, ``uvdoc``,
``formula``, …).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Sequence, Tuple, Union

import torch

from ..errors import InvalidInputError, UnsupportedError
from .cuda_build import CudaKernel

_IN_KINDS = {torch.uint8: 0, torch.float32: 1}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}

Pad = Union[float, Sequence[float]]


KERNEL = CudaKernel(
    "normalize", "normalize.cu", "oar_normalize",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_float] * 9
    + [ctypes.c_int, ctypes.c_void_p],
    replaces="oar_ocr_tpu/ops/normalize.py:58")


# K1 launches by the caller named at the launch; reset with KERNEL.launches
LAUNCHES_BY_CALLER: Counter = Counter()


def coefficients(mean: Sequence[float], std: Sequence[float],
                 scale: float = 1.0 / 255.0
                 ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """(alpha, beta) with alpha = scale/std, beta = -mean/std."""
    alpha = tuple(float(scale) / float(s) for s in std)
    beta = tuple(-float(m) / float(s) for m, s in zip(mean, std))
    return alpha, beta


def _pad3(pad: Pad) -> Tuple[float, float, float]:
    if isinstance(pad, (int, float)):
        return (float(pad),) * 3
    p = tuple(float(v) for v in pad)
    if len(p) != 3:
        raise InvalidInputError("pad must be a scalar or 3 values", pad=p)
    return p


def normalize_ref(x: torch.Tensor, alpha: Sequence[float],
                  beta: Sequence[float], *, swap_rb: bool = False,
                  out_dtype: torch.dtype = torch.float32,
                  valid_h: Optional[torch.Tensor] = None,
                  valid_w: Optional[torch.Tensor] = None,
                  pad: Pad = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    xf = x.to(torch.float32)
    if swap_rb:
        xf = xf.flip(-1)
    a = torch.tensor(alpha, dtype=torch.float32, device=x.device)
    b = torch.tensor(beta, dtype=torch.float32, device=x.device)
    out = xf * a + b
    if valid_h is not None:
        _, h, w, _ = x.shape
        rows = torch.arange(h, device=x.device)[None, :, None, None]
        cols = torch.arange(w, device=x.device)[None, None, :, None]
        mask = ((rows < valid_h[:, None, None, None])
                & (cols < valid_w[:, None, None, None]))
        p = torch.tensor(_pad3(pad), dtype=torch.float32, device=x.device)
        out = torch.where(mask, out, p)
    return out.to(out_dtype)


def _normalize(x, alpha, beta, *, swap_rb, out_dtype, valid_h=None,
               valid_w=None, pad=0.0, caller: str = "") -> torch.Tensor:
    if x.ndim != 4 or x.shape[-1] != 3:
        raise InvalidInputError("normalize expects (N, H, W, 3)",
                                shape=tuple(x.shape))
    if x.dtype not in _IN_KINDS or out_dtype not in _OUT_KINDS:
        raise InvalidInputError("normalize dtypes: uint8/float32 in, "
                                "float32/bfloat16 out", dtype=str(x.dtype),
                                out_dtype=str(out_dtype))
    if x.device.type == "cpu":
        return normalize_ref(x, alpha, beta, swap_rb=swap_rb,
                             out_dtype=out_dtype, valid_h=valid_h,
                             valid_w=valid_w, pad=pad)
    if x.device.type != "cuda":
        raise UnsupportedError("normalize runs on CPU or CUDA tensors",
                               device=str(x.device))
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    if valid_h is not None:
        valid_h = valid_h.to(device=x.device, dtype=torch.int32).contiguous()
        valid_w = valid_w.to(device=x.device, dtype=torch.int32).contiguous()
        if valid_h.shape != (x.shape[0],) or valid_w.shape != (x.shape[0],):
            raise InvalidInputError("valid_h/valid_w must be (N,)",
                                    shape=tuple(x.shape))
    n, h, w, _ = x.shape
    KERNEL.launch(x.data_ptr(), _IN_KINDS[x.dtype], out.data_ptr(),
                  _OUT_KINDS[out.dtype], n * h * w, h, w,
                  valid_h.data_ptr() if valid_h is not None else None,
                  valid_w.data_ptr() if valid_w is not None else None,
                  *alpha, *beta, *_pad3(pad), int(bool(swap_rb)),
                  torch.cuda.current_stream(x.device).cuda_stream,
                  device=x.device, what=f"shape {tuple(x.shape)}")
    LAUNCHES_BY_CALLER[caller] += 1
    return out


def normalize_images(images_u8: torch.Tensor, *, mean: Sequence[float],
                     std: Sequence[float], scale: float = 1.0 / 255.0,
                     swap_rb: bool = False,
                     out_dtype: torch.dtype = torch.float32,
                     caller: str = "") -> torch.Tensor:
    """Normalize an (N, H, W, 3) uint8 batch: out = (x·scale − mean)/std
    in alpha/beta form, R/B swapped first when ``swap_rb``. ``caller``
    names the launch in :data:`LAUNCHES_BY_CALLER`."""
    alpha, beta = coefficients(mean, std, scale)
    return _normalize(images_u8, alpha, beta, swap_rb=swap_rb,
                      out_dtype=out_dtype, caller=caller)


def normalize_masked(x: torch.Tensor, alpha: Sequence[float],
                     beta: Sequence[float], *, valid_h: torch.Tensor,
                     valid_w: torch.Tensor, pad: Pad,
                     swap_rb: bool = False,
                     out_dtype: torch.dtype = torch.float32,
                     caller: str = "") -> torch.Tensor:
    """out = x[..., swap(c)]·alpha + beta inside (valid_h[b], valid_w[b]),
    ``pad`` (a scalar or one value per channel) outside. ``caller`` names
    the launch in :data:`LAUNCHES_BY_CALLER`."""
    return _normalize(x, alpha, beta, swap_rb=swap_rb, out_dtype=out_dtype,
                      valid_h=valid_h, valid_w=valid_w, pad=pad,
                      caller=caller)

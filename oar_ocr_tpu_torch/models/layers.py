"""Shared building blocks (NCHW inside, inference-mode BatchNorm).

Counterpart of ``oar_ocr_tpu/models/layers.py`` plus the shared pieces of
``models/lcnetv3.py`` and ``models/detection/db.py``. Module attribute
names follow the official PaddleOCR deploy names, so the state_dict keys
are those names with PyTorch's BatchNorm buffer names
(``runtime/weights.params_from_jax``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def hswish(x: torch.Tensor) -> torch.Tensor:
    """x·relu6(x + 3)/6 (``layers.py:23``)."""
    return F.hardswish(x)


def hardsigmoid_paddle(x: torch.Tensor, slope: float = 0.2,
                       offset: float = 0.5) -> torch.Tensor:
    """Paddle ``F.hardsigmoid(slope=0.2, offset=0.5)``: the PP-LCNet SE
    gate (``lcnetv3.py:51``), not the relu6(x+3)/6 form."""
    return torch.clamp(slope * x + offset, 0.0, 1.0)


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm: buffers only, eps 1e-5 (``layers.py:41-61``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def scale_shift(self):
        """(scale, shift) in float32 with bn(y) = y·scale + shift; applied
        folded into the preceding convolution (:func:`conv_bn`)."""
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale


def conv_bn(x: torch.Tensor, conv: nn.Conv2d,
            bn: FrozenBatchNorm2d) -> torch.Tensor:
    """bn(conv(x)) with the BatchNorm folded into the convolution's
    weight and bias (one convolution, no extra pass over x)."""
    scale, shift = bn.scale_shift()
    w = conv.weight.float() * scale[:, None, None, None]
    b = shift if conv.bias is None else shift + conv.bias.float() * scale
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def deconv_bn(x: torch.Tensor, deconv: nn.ConvTranspose2d,
              bn: FrozenBatchNorm2d) -> torch.Tensor:
    """bn(deconv(x)) with the BatchNorm folded into the transposed
    convolution (weight layout (in, out, kH, kW))."""
    scale, shift = bn.scale_shift()
    w = deconv.weight.float() * scale[None, :, None, None]
    b = shift if deconv.bias is None else shift + deconv.bias.float() * scale
    return F.conv_transpose2d(x, w.to(x.dtype), b.to(x.dtype),
                              deconv.stride, deconv.padding)


class ConvBNLayer(nn.Module):
    """Conv (no bias) + BatchNorm, no activation (``lcnetv3.ConvBNLayer``;
    symmetric k//2 padding, Paddle semantics)."""

    def __init__(self, in_c: int, out_c: int, k, stride=1, groups: int = 1):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.conv = nn.Conv2d(in_c, out_c, (kh, kw), stride,
                              padding=(kh // 2, kw // 2), groups=groups,
                              bias=False)
        self.bn = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(x, self.conv, self.bn)


class SEModule(nn.Module):
    """PP-LCNet squeeze-excitation (``lcnetv3.SEModule``, and
    ``db.SEModuleFPN``, which is the same): mean over the WHOLE (padded)
    map in f32, conv1 1×1 → relu → conv2 1×1 → hardsigmoid(0.2, 0.5)."""

    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c // reduction, 1)
        self.conv2 = nn.Conv2d(c // reduction, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean((2, 3), keepdim=True).to(x.dtype)
        s = F.relu(self.conv1(s))
        return x * hardsigmoid_paddle(self.conv2(s))


def upsample2x(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample (``layers.py:154-157``), NCHW."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def init_state_dict(module: nn.Module,
                    generator: torch.Generator) -> dict:
    """Seeded random weights in the shape of flax's default init (the
    JAX package's ``init_params``): weights ~ N(0, 1/fan_in) (a GRU's
    ``weight_ih``/``weight_hh`` too), biases 0, norm and LAB scales 1,
    BatchNorm statistics (0, 1). The tensors are
    made in float32 on the generator's device; ``module`` may live on the
    ``meta`` device, since only its shapes are read."""
    sd = {}
    dev = generator.device
    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("running_var", "scale") or (
                leaf == "weight" and t.ndim == 1):
            v = torch.ones(t.shape, device=dev)
        elif leaf in ("weight", "weight_ih", "weight_hh"):
            v = torch.randn(t.shape, generator=generator,
                            device=dev) / t[0].numel() ** 0.5
        else:                                   # biases, running_mean
            v = torch.zeros(t.shape, device=dev)
        sd[name] = v
    return sd


def load_weights(module: nn.Module, state_dict,
                 dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None) -> nn.Module:
    """Load a state_dict (``params_from_jax`` or :func:`init_state_dict`)
    strictly — every key must match — then switch to eval mode and move
    to ``device``/``dtype``."""
    module.load_state_dict(state_dict, strict=True)
    module.eval().requires_grad_(False)
    return module.to(device=device, dtype=dtype)

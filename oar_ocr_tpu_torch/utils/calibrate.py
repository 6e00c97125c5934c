"""Seeded random weights whose activations stay alive at depth.

No checkpoint of the classifiers or of UVDoc is in the repository, so the
tests and ``chip_smoke.py`` run them on seeded random weights. Plain
N(0, 1/fan_in) weights with identity BatchNorm statistics shrink the
signal by each hardswish's slope of 1/2, so a deep random classifier's
logits underflow to 0 and its probabilities tie exactly.
:func:`calibrated_state_dict` sets every BatchNorm's statistics from its
input on a batch of pages instead. Nothing in the models' own forward
knows about it: a torch function mode watches the folded convolutions of
``layers.conv_bn`` and ``layers.deconv_bn``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ..models.layers import FrozenBatchNorm2d, init_state_dict, load_weights

_CONVS = {F.conv2d: 0, F.conv_transpose2d: 1}   # → the weight's out axis


class _Calibrate(TorchFunctionMode):
    """``conv_bn`` asks ``bn.scale_shift()`` for the fold, then runs one
    convolution. Each BatchNorm's ``scale_shift`` is made to hand out the
    identity fold and mark the BatchNorm pending; the next convolution's
    output y (the BatchNorm's input) sets its statistics, running_mean 0
    and running_var E[y²] per channel, and the convolution is run again
    with the calibrated fold, as ``conv_bn`` would run it. Scaling to unit
    second moment, not subtracting the mean as well, keeps the large
    constant part of a page's features: without it a random net is
    chaotic, and bfloat16 rounding moves its output by a large share of
    its spread."""

    def __init__(self, bns):
        super().__init__()
        self.pending = None
        self.bns = bns

    def __enter__(self):
        for bn in self.bns:
            bn.scale_shift = (lambda bn=bn: self._identity(bn))
        return super().__enter__()

    def __exit__(self, *exc):
        for bn in self.bns:
            del bn.scale_shift
        return super().__exit__(*exc)

    def _identity(self, bn):
        self.pending = bn
        return (torch.ones_like(bn.weight, dtype=torch.float32),
                torch.zeros_like(bn.bias, dtype=torch.float32))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _CONVS or self.pending is None:
            return func(*args, **kwargs)
        bn, self.pending = self.pending, None
        x, w, b, *rest = args
        y = func(*args, **kwargs).float()
        bn.running_mean.zero_()
        bn.running_var.copy_((y * y).mean((0, 2, 3)))
        scale, shift = FrozenBatchNorm2d.scale_shift(bn)
        axes = [None] * 4
        axes[_CONVS[func]] = slice(None)
        return func(x, w * scale[tuple(axes)], shift + b * scale, *rest,
                    **kwargs)


@torch.no_grad()
def calibrated_state_dict(module: nn.Module, generator: torch.Generator,
                          inputs: torch.Tensor) -> dict:
    """:func:`layers.init_state_dict`, then every BatchNorm's running
    statistics set, in forward order, from its input on ``inputs`` so that
    it scales that input to unit second moment. ``module`` is run on the
    CPU in float32 and left with the calibrated weights."""
    load_weights(module, init_state_dict(module, generator))
    bns = [m for m in module.modules() if isinstance(m, FrozenBatchNorm2d)]
    with _Calibrate(bns):
        module(inputs)
    return {k: v.clone() for k, v in module.state_dict().items()}


# the tempering of a calibrated random RT-DETR (:func:`tempered_rtdetr`)
RTDETR_BOX_GAIN = 0.1
RTDETR_RESIDUAL_GAMMA = 0.1


def tempered_rtdetr(state_dict: dict) -> dict:
    """A calibrated random RT-DETR, tempered so that its decoder is not
    chaotic: the last layer of the encoder's box head and of each decoder
    layer's box head is scaled by :data:`RTDETR_BOX_GAIN` (queries start
    near their anchors and each layer refines a box by small steps), and
    each decoder layer's three residual branches (self attention's
    ``out_proj``, cross attention's ``output_proj``, the FFN's
    ``linear2``) by :data:`RTDETR_RESIDUAL_GAMMA`. Float32 against float64
    on the CPU, on ``chip_smoke.py``'s pages, the six random layers carry
    a 1.7e-4 difference in the encoder output to 0.40 of max|logit|
    untempered (the refinement drives reference points to 0 and 1, where
    the next inverse sigmoid amplifies it), 1.4e-3 with the box heads
    tempered and 2.1e-4 with the residual branches too."""
    out = dict(state_dict)
    for k, v in out.items():
        if (k.startswith("transformer.enc_bbox_head.layers.2.")
                or (k.startswith("transformer.dec_bbox_head.")
                    and ".layers.2." in k)):
            out[k] = v * RTDETR_BOX_GAIN
        elif k.startswith("transformer.decoder.layers.") and any(
                f".{m}." in k for m in ("self_attn.out_proj",
                                        "cross_attn.output_proj",
                                        "linear2")):
            out[k] = v * RTDETR_RESIDUAL_GAMMA
    return out


# the tempering of a calibrated random UVDoc (:func:`tempered_uvdoc`)
UVDOC_RESIDUAL_GAMMA = 0.1
UVDOC_GRID_GAIN = 0.5


def tempered_uvdoc(state_dict: dict) -> dict:
    """A calibrated random UVDoc, tempered so that its grid is not
    chaotic: each residual block's second BatchNorm scale is set to
    :data:`UVDOC_RESIDUAL_GAMMA` (the block is its shortcut plus a tenth of
    its branch) and the grid projection is scaled by
    :data:`UVDOC_GRID_GAIN`. Untempered at full width, float32 rounding
    moves the grid enough to flip more pixels of a scrambled page's sharp
    edges than the rectified-page gate allows, and bfloat16 moves it far
    past the bfloat16 grid gate; ``chip_smoke.py`` prints both readings.
    The grid is linear in the projection up to its clip, so a bfloat16
    grid gate of g on the tempered net is g / UVDOC_GRID_GAIN on the
    untempered projection."""
    out = dict(state_dict)
    for k, v in out.items():
        if k.endswith(".bn2.weight"):
            out[k] = torch.full_like(v, UVDOC_RESIDUAL_GAMMA)
        elif k.startswith("out_point_positions2D.proj."):
            out[k] = v * UVDOC_GRID_GAIN
    return out

"""CTC text recognizer — exact PP-OCRv5 mobile rec topology.

Counterpart of ``oar_ocr_tpu/models/recognition/svtr.py``:
PPLCNetV3(0.95, rec) backbone (PP-HGNetV2 for the server model) →
MultiHead inference branch =
``ctc_encoder`` (EncoderWithSVTR: dims 120, depth 2, 8 heads) +
``ctc_head`` (fc → softmax). The attention is plain matmul + softmax, as
in the JAX module (``svtr.py:55-73``). NCHW inside;
:meth:`SVTRRecognizer.forward` takes the normalized (N, 48, W, 3) NHWC
tiles and returns (N, W/8, vocab) post-softmax probabilities.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import FrozenBatchNorm2d, conv_bn
from ..hgnet import PPHGNetV2
from ..lcnetv3 import PPLCNetV3


class ConvBNSwish(nn.Module):
    """``rnn.py`` ConvBNLayer: conv (no bias) + BatchNorm ``norm`` + swish."""

    def __init__(self, in_c: int, out_c: int, k: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, k, padding=(k[0] // 2, k[1] // 2),
                              bias=False)
        self.norm = FrozenBatchNorm2d(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(conv_bn(x, self.conv, self.norm))


class SVTRAttention(nn.Module):
    """Global mixer: qkv Linear, softmax(q·kᵀ·d^-½) in f32, proj Linear."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-2, -1)) * (hd ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, c)
        return self.proj(o)


class SVTRMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(x)))


class SVTRBlock(nn.Module):
    """prenorm=False block: x += mixer(norm1(x)); x += mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 2.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mixer = SVTRAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = SVTRMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.mixer(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class EncoderWithSVTR(nn.Module):
    """``rnn.py`` EncoderWithSVTR (dims 120, depth 2, hidden 120, kernel
    (1, 3))."""

    def __init__(self, in_c: int, dims: int = 120, depth: int = 2,
                 hidden_dims: int = 120, num_heads: int = 8,
                 kernel: Tuple[int, int] = (1, 3)):
        super().__init__()
        self.conv1 = ConvBNSwish(in_c, in_c // 8, kernel)
        self.conv2 = ConvBNSwish(in_c // 8, hidden_dims)
        self.svtr_block = nn.ModuleList(
            [SVTRBlock(hidden_dims, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(hidden_dims, eps=1e-6)
        self.conv3 = ConvBNSwish(hidden_dims, in_c)
        self.conv4 = ConvBNSwish(2 * in_c, in_c // 8, kernel)
        self.conv1x1 = ConvBNSwish(in_c // 8, dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        z = self.conv2(self.conv1(x))
        b, c, hh, ww = z.shape
        z = z.flatten(2).transpose(1, 2)              # (B, H·W, C)
        for blk in self.svtr_block:
            z = blk(z)
        z = self.norm(z).transpose(1, 2).reshape(b, c, hh, ww)
        z = torch.cat([h, self.conv3(z)], dim=1)
        return self.conv1x1(self.conv4(z))


class CTCEncoder(nn.Module):
    """SequenceEncoder(type='svtr') wrapper (module path
    ``ctc_encoder.encoder``)."""

    def __init__(self, in_c: int, dims: int = 120, depth: int = 2):
        super().__init__()
        self.encoder = EncoderWithSVTR(in_c, dims, depth, dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.encoder(x)                           # (B, C, 1, T)
        return z.flatten(2).transpose(1, 2)           # Im2Seq → (B, T, C)


class CTCHead(nn.Module):
    def __init__(self, in_c: int, vocab_size: int):
        super().__init__()
        self.fc = nn.Linear(in_c, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.fc(x).float(), dim=-1)


class MultiHeadCTC(nn.Module):
    def __init__(self, in_c: int, vocab_size: int, dims: int = 120,
                 depth: int = 2):
        super().__init__()
        self.ctc_encoder = CTCEncoder(in_c, dims, depth)
        self.ctc_head = CTCHead(dims, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ctc_head(self.ctc_encoder(x))


class SVTRRecognizer(nn.Module):
    """Input: (N, 48, W, 3) normalized crops. Output: (N, W/8, vocab)
    float32 probabilities, blank at index 0. ``backbone``: ``"lcnet"``
    (the mobile models, PP-LCNetV3 × ``backbone_scale``) or ``"hgnet"``
    (the server models: PP-HGNetV2-B4's (N, 2048, 1, W/8) feature,
    ``svtr.py:186-191``)."""

    def __init__(self, vocab_size: int, backbone_scale: float = 0.95,
                 svtr_dim: int = 120, svtr_depth: int = 2,
                 backbone: str = "lcnet"):
        super().__init__()
        self.backbone = (PPHGNetV2(mode="rec") if backbone == "hgnet"
                         else PPLCNetV3(backbone_scale, mode="rec"))
        self.head = MultiHeadCTC(self.backbone.out_channels, vocab_size,
                                 svtr_dim, svtr_depth)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(x_nhwc.permute(0, 3, 1, 2)))

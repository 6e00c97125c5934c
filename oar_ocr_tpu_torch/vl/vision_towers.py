"""The exact per-family vision towers: MinerU (Qwen2-VL), HPD (InternViT),
GLM-OCR (GLM-4V), OvisOCR2 and MonkeyOCRv2.

Counterpart of ``oar_ocr_tpu/vl/vision_towers.py``. The module tree is
the HF checkpoint's, as there: a flax name with dots (``blocks.{i}``,
``attn.qkv``, ``merger.mlp.0``, ``vision_model.encoder.layers.{i}``,
the raw ``vision_model.embeddings.class_embedding``) is a path of nested
modules here, a ``ModuleList`` for each ``.{i}``. A container whose name
joins its child's in the flax tree carries ``flax_join``
(:class:`Group`), which ``runtime/ppocr_maps.jax_flat_params`` reads to
give the flax key back.

Kernels: every tower's attention is the flash kernel (K2,
``ops/flash_attention.py``), unmasked and non-causal, on the (B, H, T, D)
views of the (B, T, H, D) projections: head dim 80 for MinerU, 128 for
GLM, 72 for Ovis and Monkey, 64 for HPD. The JAX towers compute the same
function with plain einsums and a float32 softmax; the K2 plain version
is that form. The rotary, the norms and the MLPs are plain PyTorch.

The host helpers (``mineru_vision_positions``, ``_qwen_vision_rope``,
``intern_target_ratios``, ``intern_closest_ratio``,
``intern_tile_image``) are copies of the JAX ones, numpy and ``cv2``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention

_LN_EPS = 1e-6


class Group(nn.Module):
    """A container whose flax name joins its children's with a dot
    (``attn`` of ``attn.qkv``, ``merger`` of ``merger.mlp.0``)."""

    flax_join = True

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, m in children.items():
            self.add_module(name, m)


class RawWeight(nn.Module):
    """A flax raw parameter whose name ends in ``.weight``
    (``pos_embed.weight``, ``conv1d.weight``): one tensor, ``weight``."""

    flax_join = True

    def __init__(self, *shape: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))


class TowersRMSNorm(nn.Module):
    """``_TowersRMSNorm``: float32 statistics and product, one rounding."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()
                ).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _rotate_half(x):
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def _rope(x, cos, sin):
    """x (T, H, D) rotated by float32 cos/sin (T, D), rounded once."""
    xf = x.float()
    return (xf * cos[:, None] + _rotate_half(xf) * sin[:, None]).to(x.dtype)


def _attend(q, k, v):
    """Unmasked attention on (B, T, H, D) tensors through K2; the result
    is (B, T, H·D)."""
    b, t, h, d = q.shape
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))
    return o.transpose(1, 2).reshape(b, t, h * d)


def _qkv_rope_attend(qkv, heads, cos, sin, q_norm=None, k_norm=None):
    """One image's fused (T, 3·d) projection → per-head (norm,) 2-D
    rotary and attention → (T, d)."""
    t = qkv.shape[0]
    qkv = qkv.view(t, 3, heads, -1)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    if q_norm is not None:
        q, k = q_norm(q), k_norm(k)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    return _attend(q[None], k[None], v[None])[0]


# --------------------------- MinerU (Qwen2-VL) ---------------------------

@dataclass(frozen=True)
class MinerUVisionConfig:
    embed_dim: int = 1280
    heads: int = 16
    mlp_ratio: float = 4.0
    layers: int = 32
    patch: int = 14
    temporal_patch: int = 2
    merge: int = 2
    out_hidden: int = 1536          # llm hidden (merger.mlp.2 out)
    ln_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.heads

    @property
    def ffn(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    def tiny(self) -> "MinerUVisionConfig":
        return dataclasses.replace(self, embed_dim=32, heads=4, layers=2,
                                   patch=4, temporal_patch=1, out_hidden=48)


def mineru_vision_positions(h: int, w: int, merge: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """h/w position per patch token in merge-block order
    (build_vision_pos_emb:728-741)."""
    hp, wp = [], []
    for hb in range(h // merge):
        for wb in range(w // merge):
            for hi in range(merge):
                for wi in range(merge):
                    hp.append(hb * merge + hi)
                    wp.append(wb * merge + wi)
    return np.asarray(hp, np.int32), np.asarray(wp, np.int32)


def _qwen_vision_rope(hpos, wpos, head_dim: int, theta: float):
    """cos/sin (T, head_dim): per-axis freqs over head_dim/4 dims each,
    concatenated then doubled (apply via rotate_half)."""
    quarter = head_dim // 4
    inv = 1.0 / (theta ** (np.arange(quarter, dtype=np.float32) * 2
                           / (head_dim // 2)))
    fh = hpos[:, None].astype(np.float32) * inv[None]
    fw = wpos[:, None].astype(np.float32) * inv[None]
    freqs = np.concatenate([fh, fw], -1)            # (T, head_dim/2)
    emb = np.concatenate([freqs, freqs], -1)        # (T, head_dim)
    return np.cos(emb), np.sin(emb)


class MinerUVisionBlock(nn.Module):
    def __init__(self, cfg: MinerUVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=c.ln_eps)
        self.attn = Group(qkv=nn.Linear(d, 3 * d), proj=nn.Linear(d, d))
        self.norm2 = nn.LayerNorm(d, eps=c.ln_eps)
        self.mlp = Group(fc1=nn.Linear(d, c.ffn), fc2=nn.Linear(c.ffn, d))

    def forward(self, x, cos, sin):
        o = _qkv_rope_attend(self.attn.qkv(self.norm1(x)), self.cfg.heads,
                             cos, sin)
        x = x + self.attn.proj(o)
        h = self.mlp.fc2(quick_gelu(self.mlp.fc1(self.norm2(x))))
        return x + h


def _merger_mlp(d_in: int, d_out: int) -> nn.Sequential:
    """``mlp.0`` → gelu_erf → ``mlp.2``."""
    return nn.Sequential(nn.Linear(d_in, d_in), nn.GELU(),
                         nn.Linear(d_in, d_out))


class MinerUVisionModel(nn.Module):
    """(T, 3·tp·p²) flattened patches for ONE image grid → merged tokens
    (T/merge², out_hidden)."""

    def __init__(self, cfg: MinerUVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d, g = c.embed_dim, c.merge ** 2
        self.patch_embed = Group(proj=nn.Linear(
            3 * c.temporal_patch * c.patch ** 2, d, bias=False))
        self.blocks = nn.ModuleList(MinerUVisionBlock(c)
                                    for _ in range(c.layers))
        self.merger = Group(ln_q=nn.LayerNorm(d, eps=c.ln_eps),
                            mlp=_merger_mlp(g * d, c.out_hidden))

    def forward(self, patches, cos, sin):
        c = self.cfg
        x = self.patch_embed.proj(patches)
        for blk in self.blocks:
            x = blk(x, cos, sin)
        x = self.merger.ln_q(x)
        g = c.merge ** 2
        return self.merger.mlp(x.reshape(x.shape[0] // g, g * c.embed_dim))


# --------------------------- HPD (InternViT) ---------------------------

@dataclass(frozen=True)
class HpdVisionConfig:
    hidden: int = 1024
    ffn: int = 4096
    layers: int = 24
    heads: int = 16
    image_size: int = 448
    patch: int = 14
    ln_eps: float = 1e-6
    qkv_bias: bool = True
    downsample_ratio: float = 0.5
    llm_hidden: int = 1024

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @property
    def downsample(self) -> int:
        return int(round(1.0 / self.downsample_ratio))

    def tiny(self) -> "HpdVisionConfig":
        return dataclasses.replace(self, hidden=32, ffn=64, layers=2,
                                   heads=4, image_size=32, patch=4,
                                   llm_hidden=48)


class InternBlock(nn.Module):
    def __init__(self, cfg: HpdVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.hidden
        self.norm1 = nn.LayerNorm(d, eps=c.ln_eps)
        self.attn = Group(qkv=nn.Linear(d, 3 * d, bias=c.qkv_bias),
                          proj=nn.Linear(d, d))
        self.ls1 = nn.Parameter(torch.ones(d))
        self.norm2 = nn.LayerNorm(d, eps=c.ln_eps)
        self.mlp = Group(fc1=nn.Linear(d, c.ffn), fc2=nn.Linear(c.ffn, d))
        self.ls2 = nn.Parameter(torch.ones(d))

    def forward(self, x):
        b, t, d = x.shape
        qkv = self.attn.qkv(self.norm1(x)).view(b, t, 3, self.cfg.heads, -1)
        o = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self.attn.proj(o) * self.ls1
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + h * self.ls2


class HpdVisionModel(nn.Module):
    """(tiles, grid², 3·p²) → (tiles·(grid/ds)², llm_hidden) — InternViT
    encoder + exact pixel-shuffle v2 + mlp1 projector."""

    def __init__(self, cfg: HpdVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d, g = c.hidden, c.grid
        emb = Group(patch_embedding=nn.Linear(3 * c.patch ** 2, d))
        emb.class_embedding = nn.Parameter(torch.zeros(1, 1, d))
        emb.position_embedding = nn.Parameter(torch.zeros(1, g * g + 1, d))
        self.vision_model = Group(
            embeddings=emb,
            encoder=Group(layers=nn.ModuleList(InternBlock(c)
                                               for _ in range(c.layers))))
        dd = d * c.downsample ** 2
        self.mlp1 = nn.Sequential(nn.LayerNorm(dd, eps=1e-5),
                                  nn.Linear(dd, c.llm_hidden), nn.GELU(),
                                  nn.Linear(c.llm_hidden, c.llm_hidden))

    def forward(self, patches):
        c = self.cfg
        tiles = patches.shape[0]
        g, d = c.grid, c.hidden
        emb = self.vision_model.embeddings
        x = emb.patch_embedding(patches)
        x = torch.cat([emb.class_embedding.to(x.dtype).expand(tiles, 1, d),
                       x], dim=1) + emb.position_embedding.to(x.dtype)
        for blk in self.vision_model.encoder.layers:
            x = blk(x)
        x = x[:, 1:].reshape(tiles, g, g, d)
        ds = c.downsample
        r = g // ds
        # pixel-shuffle v2 exact ordering (vision.rs:300-330)
        x = x.reshape(tiles, g, r, d * ds).transpose(1, 2)
        x = x.reshape(tiles, r, r, d * ds * ds).transpose(1, 2)
        return self.mlp1(x.reshape(tiles * r * r, d * ds * ds))


# ------------------------ InternVL dynamic tiling ------------------------

def intern_target_ratios(min_blocks: int, max_blocks: int
                         ) -> List[Tuple[int, int]]:
    """processing.rs:99-113 — unique (cols, rows) with blocks in range,
    sorted by (area, cols, rows)."""
    ratios = []
    for n in range(min_blocks, max_blocks + 1):
        for cols in range(1, n + 1):
            for rows in range(1, n + 1):
                blocks = cols * rows
                if (min_blocks <= blocks <= max_blocks
                        and (cols, rows) not in ratios):
                    ratios.append((cols, rows))
    ratios.sort(key=lambda cr: (cr[0] * cr[1], cr[0], cr[1]))
    return ratios


def intern_closest_ratio(width: int, height: int, image_size: int,
                         ratios: Sequence[Tuple[int, int]]
                         ) -> Tuple[int, int]:
    """processing.rs:115-152 — aspect-filtered (≤0.2 diff) candidates by
    area distance, best aspect among the top 3; fall back to unfiltered."""
    aspect = width / height
    area = width * height

    def entry(cr):
        cols, rows = cr
        ar_diff = abs(aspect - cols / rows)
        target_area = float(image_size) ** 2 * cols * rows
        return (cr, abs(area - target_area), ar_diff)

    cands = [entry(cr) for cr in ratios
             if abs(aspect - cr[0] / cr[1]) <= 0.2]
    if not cands:
        cands = [entry(cr) for cr in ratios]
    cands.sort(key=lambda e: e[1])
    best = min(cands[:3], key=lambda e: e[2])
    return best[0]


def intern_tile_image(image: np.ndarray, *, image_size: int = 448,
                      min_blocks: int = 1, max_blocks: int = 12,
                      use_thumbnail: bool = True) -> List[np.ndarray]:
    """Dynamic tiling (processing.rs:17-68): pick the closest grid, resize
    to cols·rows tiles of image_size², split row-major, append a
    thumbnail when more than one tile."""
    import cv2

    h, w = image.shape[:2]
    mb = max_blocks + 1 if use_thumbnail and max_blocks != 1 else max_blocks
    ratios = intern_target_ratios(min_blocks, mb)
    cols, rows = intern_closest_ratio(w, h, image_size, ratios)
    resized = cv2.resize(image, (cols * image_size, rows * image_size),
                         interpolation=cv2.INTER_LINEAR)
    tiles = []
    for r in range(rows):
        for c_ in range(cols):
            tiles.append(resized[r * image_size:(r + 1) * image_size,
                                 c_ * image_size:(c_ + 1) * image_size])
    if use_thumbnail and cols * rows != 1:
        tiles.append(cv2.resize(image, (image_size, image_size),
                                interpolation=cv2.INTER_LINEAR))
    return tiles


# --------------------------- GLM-OCR (GLM-4V) ---------------------------

@dataclass(frozen=True)
class GlmVisionConfig:
    """glmocr/vision.rs GlmOcrVisionConfig (dims from config.json)."""

    hidden: int = 1536
    heads: int = 12
    ffn: int = 4224
    depth: int = 24
    patch: int = 14
    merge: int = 2
    out_hidden: int = 1536
    attention_bias: bool = False
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def tiny(self) -> "GlmVisionConfig":
        return dataclasses.replace(self, hidden=32, heads=4, ffn=64,
                                   depth=2, patch=4, out_hidden=48)


def _swiglu(gate, up, down, x):
    return down(F.silu(gate(x)) * up(x))


class GlmVisionBlock(nn.Module):
    """norm1/norm2 RMSNorms, fused attn.qkv + per-head q/k RMSNorms +
    attn.proj, SwiGLU mlp (glmocr/vision.rs:203-525)."""

    def __init__(self, cfg: GlmVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d, b = c.hidden, c.attention_bias
        self.norm1 = TowersRMSNorm(d, c.rms_eps)
        self.attn = Group(qkv=nn.Linear(d, 3 * d, bias=b),
                          q_norm=TowersRMSNorm(c.head_dim, c.rms_eps),
                          k_norm=TowersRMSNorm(c.head_dim, c.rms_eps),
                          proj=nn.Linear(d, d, bias=b))
        self.norm2 = TowersRMSNorm(d, c.rms_eps)
        self.mlp = Group(gate_proj=nn.Linear(d, c.ffn, bias=False),
                         up_proj=nn.Linear(d, c.ffn, bias=False),
                         down_proj=nn.Linear(c.ffn, d, bias=False))

    def forward(self, x, cos, sin):
        a = self.attn
        o = _qkv_rope_attend(a.qkv(self.norm1(x)), self.cfg.heads, cos, sin,
                             a.q_norm, a.k_norm)
        x = x + a.proj(o)
        m = self.mlp
        return x + _swiglu(m.gate_proj, m.up_proj, m.down_proj,
                           self.norm2(x))


class GlmVisionModel(nn.Module):
    """(T, 3·p²) merge-block-ordered patches → (T/merge², out_hidden)
    (glmocr/vision.rs:602-861): blocks → post RMSNorm → per-block
    downsample conv → merger (proj → LN → tanh-gelu → SwiGLU)."""

    def __init__(self, cfg: GlmVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d, o = c.hidden, c.out_hidden
        self.patch_embed = Group(proj=nn.Linear(3 * c.patch ** 2, d))
        self.blocks = nn.ModuleList(GlmVisionBlock(c) for _ in range(c.depth))
        self.post_layernorm = TowersRMSNorm(d, c.rms_eps)
        self.downsample = nn.Conv2d(d, o, c.merge, stride=c.merge)
        ctx = o * 3                                # context_dim = out·in_ch
        self.merger = Group(
            proj=nn.Linear(o, o, bias=False),
            post_projection_norm=nn.LayerNorm(o, eps=c.rms_eps),
            gate_proj=nn.Linear(o, ctx, bias=False),
            up_proj=nn.Linear(o, ctx, bias=False),
            down_proj=nn.Linear(ctx, o, bias=False))

    def forward(self, patches, cos, sin):
        c = self.cfg
        x = self.patch_embed.proj(patches)
        for blk in self.blocks:
            x = blk(x, cos, sin)
        x = self.post_layernorm(x)
        m, t = c.merge, x.shape[0]
        x = x.view(t // (m * m), m, m, c.hidden).permute(0, 3, 1, 2)
        x = self.downsample(x).reshape(t // (m * m), c.out_hidden)
        g = self.merger
        # candle .gelu() is the TANH approximation; the gate act is silu
        x = F.gelu(g.post_projection_norm(g.proj(x)), approximate="tanh")
        return _swiglu(g.gate_proj, g.up_proj, g.down_proj, x)


# --------------------------- OvisOCR2 (Qwen2.5-VL-ish) ---------------------

@dataclass(frozen=True)
class OvisVisionConfig:
    """ovisocr2/vision.rs OvisOcr2VisionConfig."""

    hidden: int = 1152
    heads: int = 16
    ffn: int = 4304
    depth: int = 27
    patch: int = 14
    merge: int = 2
    out_hidden: int = 1024
    num_positions: int = 1024           # pos_embed rows (grid²)
    ln_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def pos_grid(self) -> int:
        return int(round(self.num_positions ** 0.5))

    def tiny(self) -> "OvisVisionConfig":
        return dataclasses.replace(self, hidden=32, heads=4, ffn=64,
                                   depth=2, patch=4, out_hidden=48,
                                   num_positions=16)


class OvisVisionBlock(nn.Module):
    def __init__(self, cfg: OvisVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.hidden
        self.norm1 = nn.LayerNorm(d, eps=c.ln_eps)
        self.attn = Group(qkv=nn.Linear(d, 3 * d), proj=nn.Linear(d, d))
        self.norm2 = nn.LayerNorm(d, eps=c.ln_eps)
        self.mlp = Group(linear_fc1=nn.Linear(d, c.ffn),
                         linear_fc2=nn.Linear(c.ffn, d))

    def forward(self, x, cos, sin):
        o = _qkv_rope_attend(self.attn.qkv(self.norm1(x)), self.cfg.heads,
                             cos, sin)
        x = x + self.attn.proj(o)
        h = F.gelu(self.mlp.linear_fc1(self.norm2(x)), approximate="tanh")
        return x + self.mlp.linear_fc2(h)


class OvisVisionModel(nn.Module):
    """(T, 3·p²) merge-block-ordered patches + interpolated pos rows →
    merger (norm → group merge² → fc1 gelu_erf → fc2) (ovisocr2/vision.rs
    :385-530)."""

    def __init__(self, cfg: OvisVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d, g = c.hidden, c.merge ** 2
        self.patch_embed = Group(proj=nn.Linear(3 * c.patch ** 2, d,
                                                bias=False))
        # the table lives under its checkpoint name; rows arrive
        # host-interpolated in the same merge-block order as the patches
        self.pos_embed = RawWeight(c.num_positions, d)
        self.blocks = nn.ModuleList(OvisVisionBlock(c) for _ in range(c.depth))
        self.merger = Group(norm=nn.LayerNorm(d, eps=c.ln_eps),
                            linear_fc1=nn.Linear(g * d, g * d),
                            linear_fc2=nn.Linear(g * d, c.out_hidden))

    def forward(self, patches, pos_embed, cos, sin):
        c = self.cfg
        x = self.patch_embed.proj(patches) + pos_embed.to(patches.dtype)
        for blk in self.blocks:
            x = blk(x, cos, sin)
        g = c.merge ** 2
        x = self.merger.norm(x).reshape(x.shape[0] // g, g * c.hidden)
        return self.merger.linear_fc2(F.gelu(self.merger.linear_fc1(x)))


# --------------------------- MonkeyOCRv2 (Monkey ViT) ---------------------

@dataclass(frozen=True)
class MonkeyVisionConfig:
    """monkeyocrv2/vision.rs MonkeyOcrV2VisionConfig."""

    embed_dim: int = 1152
    heads: int = 16
    ffn: int = 4304
    depth: int = 27
    patch: int = 14
    merge: int = 2
    out_hidden: int = 1024           # llm hidden (merger.mlp.2 out)
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    post_trunk_norm: bool = True

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.heads

    def tiny(self) -> "MonkeyVisionConfig":
        return dataclasses.replace(self, embed_dim=32, heads=4, ffn=64,
                                   depth=2, patch=4, out_hidden=48)


class MonkeyVisionBlock(nn.Module):
    """RMS norms + bias-free fused qkv/proj + SwiGLU fc1(gate)/fc3(up)/
    fc2(down) (monkeyocrv2/vision.rs:65-270)."""

    def __init__(self, cfg: MonkeyVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.embed_dim
        self.norm1 = TowersRMSNorm(d, c.rms_eps)
        self.attn = Group(qkv=nn.Linear(d, 3 * d, bias=False),
                          proj=nn.Linear(d, d, bias=False))
        self.norm2 = TowersRMSNorm(d, c.rms_eps)
        self.mlp = Group(fc1=nn.Linear(d, c.ffn, bias=False),
                         fc3=nn.Linear(d, c.ffn, bias=False),
                         fc2=nn.Linear(c.ffn, d, bias=False))

    def forward(self, x, cos, sin):
        o = _qkv_rope_attend(self.attn.qkv(self.norm1(x)), self.cfg.heads,
                             cos, sin)
        x = x + self.attn.proj(o)
        m = self.mlp
        return x + _swiglu(m.fc1, m.fc3, m.fc2, self.norm2(x))


class MonkeyVisionModel(nn.Module):
    """patch_embed.patchifier (proj + RMS norm) → blocks →
    post_trunk_norm → merger (ln_q LN → group merge² → mlp.0 gelu_erf →
    mlp.2) (monkeyocrv2/vision.rs:335-420)."""

    def __init__(self, cfg: MonkeyVisionConfig):
        super().__init__()
        c = self.cfg = cfg
        d, g = c.embed_dim, c.merge ** 2
        self.patch_embed = Group(patchifier=Group(
            proj=nn.Linear(3 * c.patch ** 2, d),
            norm=TowersRMSNorm(d, c.rms_eps)))
        self.blocks = nn.ModuleList(MonkeyVisionBlock(c)
                                    for _ in range(c.depth))
        if c.post_trunk_norm:
            self.post_trunk_norm = TowersRMSNorm(d, c.rms_eps)
        self.merger = Group(ln_q=nn.LayerNorm(d, eps=1e-6),
                            mlp=_merger_mlp(g * d, c.out_hidden))

    def forward(self, patches, cos, sin):
        c = self.cfg
        pf = self.patch_embed.patchifier
        x = pf.norm(pf.proj(patches))
        for blk in self.blocks:
            x = blk(x, cos, sin)
        if c.post_trunk_norm:
            x = self.post_trunk_norm(x)
        g = c.merge ** 2
        x = self.merger.ln_q(x)
        return self.merger.mlp(x.reshape(x.shape[0] // g, g * c.embed_dim))


TOWERS = {"qwen2vl": MinerUVisionModel, "glm": GlmVisionModel,
          "ovis": OvisVisionModel, "monkey": MonkeyVisionModel,
          "internvit": HpdVisionModel}

"""PaddleOCR-VL (0.9B): NaViT vision tower + Ernie-4.5 decoder.

Counterpart of ``oar_ocr_tpu/vl/paddleocr_vl.py``. Module attribute names
follow the HF checkpoint tree, so the state_dict keys are the
checkpoint's tensor names (``visual.vision_model.encoder.layers.{i}...``,
``mlp_AR.linear_1``, ``model.layers.{i}.self_attn.q_proj``, ``lm_head``;
``runtime/weights.vl_params_from_jax`` converts the JAX parameters to
them).

Kernels on this path:

- the vision attention of every encoder layer runs the flash kernel
  (K2, ``ops/flash_attention.py``) at every sequence length. The JAX
  module switches to its Pallas kernel only above the reference's
  8192-token memory guard against the (T, T) score matrix of full SDPA
  (``paddleocr_vl.py:209-216``); both compute the same function, and an
  online-softmax kernel never builds that matrix;
- the decoder runs the residual add + RMSNorm kernel (K3,
  ``ops/fused_norm_rope.py``) at its 36 norm sites: each layer's
  ``post_attention_layernorm`` after ``x + o_proj(o)``, the next layer's
  ``input_layernorm`` after ``x + mlp(h)``, and the final ``model.norm``.
  The layers hand on ``(residual, delta)``, so the add happens inside the
  kernel. Layer 0's ``input_layernorm`` has no add in front of it and
  runs the plain :class:`RMSNorm`, which rounds ``x·rsqrt(var + eps)`` to
  x's dtype before the scale as the JAX RMSNorm does (``:147-148``); the
  kernel rounds once, after the scale. The decoder is float32 in either
  runtime (``model.apply_dtype_policy``), where the two agree to
  rounding.

Details kept from the JAX module: the vision MLP's GELU is the tanh form
(flax's ``nn.gelu`` default, ``:229``), the projector's the exact erf form
(``:316``); every LayerNorm has eps 1e-6 (``v_ln_eps``); the vision rope
tables are cast to the tower's dtype and the MRoPE tables to the
embeddings' (float32) before use (``:270-272``, ``:368-369``); the patch
embedding keeps the HF Conv2d (D, 3, p, p) weight and applies it as a
dense layer over HWC-flattened patches in 2×2-block order (``:265-268``,
``runtime/ppocr_maps.py:146-154``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..ops.fused_norm_rope import fused_add_rmsnorm
from .attention import (apply_rope, create_generation_mask, mrope_cos_sin,
                        scaled_dot_product_attention)
from .kv_cache import KVCache

# Task prompts (paddleocr_vl/model.rs:30-38).
TASK_PROMPTS = {
    "ocr": "OCR:",
    "table": "Table Recognition:",
    "formula": "Formula Recognition:",
    "chart": "Chart Recognition:",
    "spotting": "Spotting:",
    "seal": "Seal Recognition:",
}


def strip_math_wrappers(text: str) -> str:
    """Remove one layer of $$…$$, then of $…$, around a formula."""
    t = text.strip()
    if t.startswith("$$") and t.endswith("$$") and len(t) >= 4:
        t = t[2:-2]
    if t.startswith("$") and t.endswith("$") and len(t) >= 2:
        t = t[1:-1]
    return t.strip()


def postprocess_table_output(text: str) -> str:
    """Table task output → HTML when it carries OTSL tokens or raw
    ``<table`` markup (``paddleocr_vl.py:70-78``)."""
    from .otsl import convert_otsl_to_html, looks_like_table_tokens

    trimmed = text.strip()
    if not looks_like_table_tokens(trimmed) and "<table" not in trimmed:
        return trimmed
    return convert_otsl_to_html(text)


def postprocess_task_output(text: str, task: str) -> str:
    """Per-task output cleanup (``paddleocr_vl.py:81-90``): formulas lose
    their math wrappers, tables convert OTSL→HTML, everything else is
    trimmed."""
    if task == "formula":
        return strip_math_wrappers(text)
    if task == "table":
        return postprocess_table_output(text)
    return text.strip()


@dataclass(frozen=True)
class PaddleOCRVLConfig:
    # decoder (Ernie4.5-0.3B; config.json text fields)
    vocab_size: int = 103424
    hidden: int = 1024
    layers: int = 18
    heads: int = 16
    kv_heads: int = 2
    head_dim: int = 128          # explicit: not hidden/heads
    ffn: int = 3072
    use_bias: bool = False
    rms_eps: float = 1e-5
    rope_theta: float = 500000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # sums to head_dim/2
    # vision (NaViT/SigLIP; config.json vision_config)
    v_dim: int = 1152
    v_ffn: int = 4304
    v_layers: int = 27
    v_heads: int = 16
    v_patch: int = 14
    v_merge: int = 2
    v_image_size: int = 384      # pretrain grid of position_embedding
    v_ln_eps: float = 1e-6
    # special tokens
    image_start_id: int = 101
    image_end_id: int = 102
    image_pad_id: int = 100
    eos_id: int = 2

    @property
    def v_head_dim(self) -> int:
        return self.v_dim // self.v_heads

    @property
    def v_grid(self) -> int:
        return self.v_image_size // self.v_patch

    def tiny(self) -> "PaddleOCRVLConfig":
        """Development-size clone (same topology, small dims)."""
        return dataclasses.replace(
            self, vocab_size=512, hidden=128, layers=2, heads=4, kv_heads=2,
            head_dim=32, ffn=256, v_dim=64, v_ffn=128, v_layers=2, v_heads=4,
            v_image_size=56, mrope_sections=(8, 4, 4))


class RMSNorm(nn.Module):
    """RMSNorm with the JAX module's rounding (``paddleocr_vl.py:141-148``).
    Its weight is also the scale the K3 sites pass to the kernel."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


# ----------------------------- vision -----------------------------

def vision_rope_cos_sin(h_ids: torch.Tensor, w_ids: torch.Tensor,
                        head_dim: int, theta: float = 10000.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SigLIP 2-D rotary tables: head_dim/4 frequencies for the patch row,
    as many for the column; float32 cos/sin (…, head_dim/2)."""
    quarter = head_dim // 4
    inv = 1.0 / (theta ** (torch.arange(0, quarter, dtype=torch.float32,
                                        device=h_ids.device) / quarter))
    freqs = torch.cat([h_ids[..., None].float() * inv,
                       w_ids[..., None].float() * inv], dim=-1)
    return freqs.cos(), freqs.sin()


class VisionAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, cos, sin, valid_len):
        b, t, d = x.shape

        def heads_of(y):
            return y.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        q = apply_rope(heads_of(self.q_proj(x)), cos[:, None], sin[:, None])
        k = apply_rope(heads_of(self.k_proj(x)), cos[:, None], sin[:, None])
        o = flash_attention(q, k, heads_of(self.v_proj(x)),
                            valid_len=valid_len)
        return self.out_proj(o.transpose(1, 2).reshape(b, t, d))


class VisionMlp(nn.Module):
    def __init__(self, dim: int, ffn: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, ffn)
        self.fc2 = nn.Linear(ffn, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class VisionEncoderLayer(nn.Module):
    def __init__(self, cfg: PaddleOCRVLConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.v_dim, eps=cfg.v_ln_eps)
        self.self_attn = VisionAttention(cfg.v_dim, cfg.v_heads)
        self.layer_norm2 = nn.LayerNorm(cfg.v_dim, eps=cfg.v_ln_eps)
        self.mlp = VisionMlp(cfg.v_dim, cfg.v_ffn)

    def forward(self, x, cos, sin, valid_len):
        x = x + self.self_attn(self.layer_norm1(x), cos, sin, valid_len)
        return x + self.mlp(self.layer_norm2(x))


def conv_as_dense(patches: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """(B, T, p·p·3) HWC-flattened patches → (B, T, D): a patch
    embedding's Conv2d weight (D, 3, p, p) applied as a dense layer in
    (p, p, 3) order."""
    w = conv.weight
    return F.linear(patches, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                    conv.bias)


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: PaddleOCRVLConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.v_dim, cfg.v_patch,
                                         cfg.v_patch)
        self.position_embedding = nn.Embedding(cfg.v_grid * cfg.v_grid,
                                               cfg.v_dim)


class VisionModel(nn.Module):
    """``visual.vision_model``: patch embedding + the host-interpolated
    position embedding, the 2-D-rope encoder stack, post LayerNorm, over a
    padded token batch whose first ``valid_len[b]`` tokens are real."""

    def __init__(self, cfg: PaddleOCRVLConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = VisionEmbeddings(cfg)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            VisionEncoderLayer(cfg) for _ in range(cfg.v_layers))
        self.post_layernorm = nn.LayerNorm(cfg.v_dim, eps=cfg.v_ln_eps)

    def forward(self, patches, valid_len, h_ids, w_ids, pos_embed):
        x = conv_as_dense(patches, self.embeddings.patch_embedding)
        x = x + pos_embed.to(x.dtype)
        cos, sin = vision_rope_cos_sin(h_ids, w_ids, self.cfg.v_head_dim)
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        for layer in self.encoder.layers:
            x = layer(x, cos, sin, valid_len)
        return self.post_layernorm(x)


class Projector(nn.Module):
    """``mlp_AR``: pre_norm, merge of 4 consecutive tokens (the host packs
    them in 2×2-block order), linear_1 → GELU(erf) → linear_2."""

    def __init__(self, cfg: PaddleOCRVLConfig):
        super().__init__()
        m2 = cfg.v_merge ** 2
        self.m2 = m2
        self.pre_norm = nn.LayerNorm(cfg.v_dim, eps=cfg.v_ln_eps)
        self.linear_1 = nn.Linear(m2 * cfg.v_dim, m2 * cfg.v_dim)
        self.linear_2 = nn.Linear(m2 * cfg.v_dim, cfg.hidden)

    def forward(self, x):
        b, t, d = x.shape
        x = self.pre_norm(x).reshape(b, t // self.m2, self.m2 * d)
        return self.linear_2(F.gelu(self.linear_1(x)))


# ----------------------------- decoder -----------------------------

class ErnieAttention(nn.Module):
    def __init__(self, cfg: PaddleOCRVLConfig):
        super().__init__()
        self.cfg = cfg
        hd, bias = cfg.head_dim, cfg.use_bias
        self.q_proj = nn.Linear(cfg.hidden, cfg.heads * hd, bias=bias)
        self.k_proj = nn.Linear(cfg.hidden, cfg.kv_heads * hd, bias=bias)
        self.v_proj = nn.Linear(cfg.hidden, cfg.kv_heads * hd, bias=bias)
        self.o_proj = nn.Linear(cfg.heads * hd, cfg.hidden, bias=bias)

    def forward(self, h, cos, sin, cache: KVCache, layer_idx: int,
                pos: Union[int, torch.Tensor], mask):
        """Writes this layer's K/V at slot ``pos`` (an int, or the decode
        step's 0-d device slot), attends over the cache, returns o_proj
        of the attention output."""
        c = self.cfg
        b, t, _ = h.shape
        q = self.q_proj(h).view(b, t, c.heads, c.head_dim).transpose(1, 2)
        k = self.k_proj(h).view(b, t, c.kv_heads, c.head_dim).transpose(1, 2)
        v = self.v_proj(h).view(b, t, c.kv_heads, c.head_dim).transpose(1, 2)
        q = apply_rope(q, cos[:, None], sin[:, None])
        k = apply_rope(k, cos[:, None], sin[:, None])
        cache.append(layer_idx, k, v, pos)
        ck, cv = cache.layer(layer_idx)
        o = scaled_dot_product_attention(q, ck, cv, mask)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, c.heads * c.head_dim))


class ErnieMlp(nn.Module):
    """SwiGLU gate/up/down MLP (the JAX ``SwiGLU``, ``:151-165``)."""

    def __init__(self, hidden: int, ffn: int, bias: bool = False):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, ffn, bias=bias)
        self.up_proj = nn.Linear(hidden, ffn, bias=bias)
        self.down_proj = nn.Linear(ffn, hidden, bias=bias)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class ErnieLayer(nn.Module):
    def __init__(self, cfg: PaddleOCRVLConfig, layer_idx: int):
        super().__init__()
        self.layer_idx = layer_idx
        self.eps = cfg.rms_eps
        self.self_attn = ErnieAttention(cfg)
        self.mlp = ErnieMlp(cfg.hidden, cfg.ffn, cfg.use_bias)
        self.input_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps)

    def forward(self, residual, delta, cos, sin, cache, pos, mask):
        """(residual, delta) in → (residual, delta) out; the layer's
        hidden state is residual + delta. ``delta`` is None before
        layer 0."""
        if delta is None:
            h = self.input_layernorm(residual)
        else:
            h, residual = fused_add_rmsnorm(delta, residual,
                                            self.input_layernorm.weight,
                                            eps=self.eps)
        attn = self.self_attn(h, cos, sin, cache, self.layer_idx, pos, mask)
        h, residual = fused_add_rmsnorm(attn, residual,
                                        self.post_attention_layernorm.weight,
                                        eps=self.eps)
        return residual, self.mlp(h)


class ErnieModel(nn.Module):
    """``model``: token embedding, the decoder layers, the final norm."""

    def __init__(self, cfg: PaddleOCRVLConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.layers = nn.ModuleList(
            ErnieLayer(cfg, i) for i in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, cfg.rms_eps)

    def forward(self, embeds, position_ids, cache: KVCache, pos: int, mask):
        c = self.cfg
        cos, sin = mrope_cos_sin(position_ids, c.head_dim, c.mrope_sections,
                                 c.rope_theta)
        cos, sin = cos.to(embeds.dtype), sin.to(embeds.dtype)
        residual, delta = embeds, None
        for layer in self.layers:
            residual, delta = layer(residual, delta, cos, sin, cache, pos,
                                    mask)
        normed, _ = fused_add_rmsnorm(delta, residual, self.norm.weight,
                                      eps=c.rms_eps)
        return normed


class PaddleOCRVLModel(nn.Module):
    """The whole network; its state_dict keys are the HF checkpoint's
    tensor names."""

    def __init__(self, cfg: PaddleOCRVLConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = nn.Module()
        self.visual.vision_model = VisionModel(cfg)
        self.mlp_AR = Projector(cfg)
        self.model = ErnieModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden, cfg.vocab_size, bias=False)

    def encode_vision(self, patches, valid_len, h_ids, w_ids, pos_embed):
        """(B, T, p·p·3) patches → (B, T/4, hidden) image embeddings."""
        return self.mlp_AR(self.visual.vision_model(
            patches, valid_len, h_ids, w_ids, pos_embed))

    def prefill(self, embeds, position_ids, cache: KVCache,
                mask) -> torch.Tensor:
        """Run the prompt through the decoder, filling ``cache`` from
        slot 0; float32 logits (B, vocab) of the last position."""
        hidden = self.model(embeds, position_ids, cache, 0, mask)
        return self.lm_head(hidden[:, -1]).float()

    def decode_step(self, tok, position_ids, cache: KVCache,
                    pos: int) -> torch.Tensor:
        """One token per row: tok (B,), positions (3, B, 1); writes slot
        ``pos`` and advances the cache."""
        embeds = self.model.embed_tokens(tok)[:, None, :]
        mask = create_generation_mask(cache.length + 1, cache.capacity,
                                      cache.pad)
        hidden = self.model(embeds, position_ids, cache, pos, mask)
        cache.advance(1)
        return self.lm_head(hidden[:, -1]).float()


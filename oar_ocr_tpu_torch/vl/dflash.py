"""DFlash block-draft model for HunyuanOCR.

Counterpart of ``oar_ocr_tpu/vl/dflash.py``. The draft's context K/V is
projected from the TARGET decoder's mid-layer hidden states:

- the target records its hidden states after the layers named by
  ``target_layer_ids`` (0-based; out-of-range ids are an error, never
  filtered), concatenated along the hidden axis;
- ``fc`` + ``hidden_norm`` map that concatenation to the draft width;
- each draft layer's own k/v projections turn those rows into context
  K/V, rotated at their absolute positions and appended to a paged cache
  (``vl/paged_kv.py``) as the target commits tokens;
- a query block [bonus-token embedding, mask-token embedding ×
  (block_size − 1)] (the target's embedding table) runs through the
  draft layers attending to [context ‖ block] non-causally;
- rows 1.. go through the target's LM head; their argmaxes are the
  drafts, which one causal target pass verifies.

Layers: input_layernorm → GQA attention with per-head q_norm/k_norm and
interleaved-pair RoPE → post_attention_layernorm → SwiGLU MLP, every
projection without bias; every RMSNorm has eps 1e-6, the JAX module's
default (``DFlashConfig.rms_eps`` is not read there either). Module names
follow the checkpoint (``layers.{i}.self_attn.q_proj``), so the flax keys
map to this state_dict by ``runtime/weights.torch_name``.

The attention is the JAX module's plain float32 product over
[context ‖ block] (``dflash.py:136-146``): its mask keeps a context row
below ``ctx_len`` and at or past ``ctx_pad``, and every block row, which
is not the valid-length prefix the flash kernel (K2) takes, so it stays
plain here as there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .paddleocr_vl import RMSNorm
from .paged_kv import PagedKVCache

_EPS = 1e-6   # flax RMSNorm's default, which every DFlash norm takes


@dataclass(frozen=True)
class DFlashConfig:
    """``dflash.py:52-88``, value for value."""

    block_size: int = 8
    hidden: int = 2048
    intermediate: int = 6144
    heads: int = 16
    kv_heads: int = 4
    head_dim: int = 128
    layers: int = 1
    vocab_size: int = 128000
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    target_layer_ids: Tuple[int, ...] = (1, 8, 15, 22)
    mask_token_id: int = 120817
    page_size: int = 128
    max_pages: int = 32

    def tiny(self, **overrides) -> "DFlashConfig":
        base = dataclasses.replace(
            self, block_size=4, hidden=64, intermediate=128, heads=4,
            kv_heads=2, head_dim=16, layers=1, vocab_size=256,
            target_layer_ids=(0, 1), mask_token_id=255, page_size=16,
            max_pages=64)
        return dataclasses.replace(base, **overrides)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on (B, H, T, D) over interleaved pairs (x[2i], x[2i+1]) at
    the absolute positions ``pos`` (T,), in float32 (``dflash.py:91-101``)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = pos.float()[:, None] * inv[None]
    cos, sin = freqs.cos()[None, None], freqs.sin()[None, None]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.reshape(x.shape).to(x.dtype)


def _positions(start: Union[int, torch.Tensor], t: int,
               device) -> torch.Tensor:
    return torch.as_tensor(start, device=device).to(torch.int64) \
        + torch.arange(t, device=device)


class DFlashAttention(nn.Module):
    def __init__(self, cfg: DFlashConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.q_proj = nn.Linear(c.hidden, c.heads * c.head_dim, bias=False)
        self.k_proj = nn.Linear(c.hidden, c.kv_heads * c.head_dim, bias=False)
        self.v_proj = nn.Linear(c.hidden, c.kv_heads * c.head_dim, bias=False)
        self.o_proj = nn.Linear(c.heads * c.head_dim, c.hidden, bias=False)
        self.q_norm = RMSNorm(c.head_dim, _EPS)
        self.k_norm = RMSNorm(c.head_dim, _EPS)

    def context_kv(self, target_rows: torch.Tensor, start
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Transformed target rows (B, T, hidden) → rotated context K and
        raw V, (B, Hkv, T, D) each, at positions start .. start + T."""
        c = self.cfg
        b, t, _ = target_rows.shape
        k = self.k_proj(target_rows).view(b, t, c.kv_heads, c.head_dim)
        v = self.v_proj(target_rows).view(b, t, c.kv_heads, c.head_dim)
        k = self.k_norm(k).transpose(1, 2)
        pos = _positions(start, t, target_rows.device)
        return _rope(k, pos, c.rope_theta), v.transpose(1, 2)

    def forward(self, x, ctx_k, ctx_v, ctx_len, start, ctx_pad=None):
        """Non-causal block attention over [context ‖ block]. ctx_k/ctx_v
        (B, Hkv, C, D) from the paged view (C ≥ ctx_len); context rows at
        or past ``ctx_len`` (B,) and below ``ctx_pad`` (B,) are masked."""
        c = self.cfg
        b, t, _ = x.shape
        g = c.heads // c.kv_heads
        q = self.q_norm(self.q_proj(x).view(b, t, c.heads, c.head_dim))
        k = self.k_norm(self.k_proj(x).view(b, t, c.kv_heads, c.head_dim))
        v = self.v_proj(x).view(b, t, c.kv_heads, c.head_dim).transpose(1, 2)
        pos = _positions(start, t, x.device)
        q = _rope(q.transpose(1, 2), pos, c.rope_theta)
        k = _rope(k.transpose(1, 2), pos, c.rope_theta)
        full_k = torch.cat([ctx_k, k], dim=2)
        full_v = torch.cat([ctx_v, v], dim=2)
        cap = ctx_k.shape[2]
        col = torch.arange(cap + t, device=x.device)[None, None, None, :]
        mask = (col < ctx_len[:, None, None, None]) | (col >= cap)
        if ctx_pad is not None:
            mask = mask & ((col >= ctx_pad[:, None, None, None])
                           | (col >= cap))
        fk = full_k.repeat_interleave(g, dim=1).float()
        fv = full_v.repeat_interleave(g, dim=1).float()
        attn = torch.matmul(q.float(), fk.transpose(-1, -2)) \
            * (c.head_dim ** -0.5)
        attn = torch.softmax(attn.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.matmul(attn, fv).transpose(1, 2).reshape(
            b, t, c.heads * c.head_dim)
        return self.o_proj(o.to(x.dtype))


class DFlashMlp(nn.Module):
    def __init__(self, cfg: DFlashConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden, cfg.intermediate, bias=False)
        self.up_proj = nn.Linear(cfg.hidden, cfg.intermediate, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate, cfg.hidden, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DFlashLayer(nn.Module):
    def __init__(self, cfg: DFlashConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden, _EPS)
        self.self_attn = DFlashAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden, _EPS)
        self.mlp = DFlashMlp(cfg)

    def forward(self, x, ctx_k, ctx_v, ctx_len, start, ctx_pad=None):
        x = x + self.self_attn(self.input_layernorm(x), ctx_k, ctx_v,
                               ctx_len, start, ctx_pad)
        return x + self.mlp(self.post_attention_layernorm(x))


class DFlashDraft(nn.Module):
    """fc + hidden_norm + layers + final norm (the checkpoint's names).
    ``fc`` takes the target's hidden states at every tap, concatenated:
    the target is as wide as the draft."""

    def __init__(self, cfg: DFlashConfig):
        super().__init__()
        self.cfg = cfg
        self.fc = nn.Linear(cfg.hidden * len(cfg.target_layer_ids),
                            cfg.hidden, bias=False)
        self.hidden_norm = RMSNorm(cfg.hidden, _EPS)
        self.layers = nn.ModuleList(DFlashLayer(cfg)
                                    for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, _EPS)

    def transform_target(self, aux_hidden: torch.Tensor) -> torch.Tensor:
        """(B, T, hidden·|ids|) target concatenation → (B, T, hidden)."""
        return self.hidden_norm(self.fc(aux_hidden))

    def context_rows(self, aux_hidden: torch.Tensor, start
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each layer's context K/V of the target rows, stacked
        (L, B, Hkv, T, D), for the caller to append to the paged cache."""
        t = self.transform_target(aux_hidden)
        kv = [layer.self_attn.context_kv(t, start) for layer in self.layers]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def draft_hidden(self, query_embeds: torch.Tensor, cache: PagedKVCache,
                     n_pages: int, start) -> torch.Tensor:
        """The bonus + mask query block through the layers over the first
        ``n_pages`` context pages; the normed (B, block, hidden)."""
        x = query_embeds
        for li, layer in enumerate(self.layers):
            ck, cv = cache.view(n_pages, li)
            x = layer(x, ck.to(x.dtype), cv.to(x.dtype), cache.length,
                      start, cache.pad)
        return self.norm(x)


def check_draft_fits(dcfg: DFlashConfig, hidden: int, layers: int) -> None:
    """Raise before any weight is made when the draft cannot serve this
    target: a tap past the target's layers (``InvalidInputError``, as the
    JAX package raises, ``hunyuan.py:580-586``), or a draft whose width is
    not the target's, whose embeddings it takes and whose LM head it
    feeds (``ConfigError``; the JAX package fails there too, inside its
    first forward, with flax's parameter-shape error)."""
    from ..errors import ConfigError, InvalidInputError

    bad = [i for i in dcfg.target_layer_ids if not 0 <= i < layers]
    if bad:
        raise InvalidInputError(
            "DFlash target_layer_ids out of range for target",
            bad=bad, layers=layers)
    if dcfg.hidden != hidden:
        raise ConfigError(
            "the DFlash draft must be as wide as its target: it embeds "
            "with the target's table and drafts through its LM head",
            draft_hidden=dcfg.hidden, target_hidden=hidden)

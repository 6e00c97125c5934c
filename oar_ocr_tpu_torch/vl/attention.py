"""Decoder attention for the VLM stack: SDPA with GQA, masks, RoPE/MRoPE.

Counterpart of ``oar_ocr_tpu/vl/attention.py``. The JAX module computes
this attention with plain einsums (it is not a Pallas kernel there), so
the port computes it with plain tensor products; the vision tower's
attention is the flash kernel (``ops/flash_attention.py``).

Conventions kept from the JAX module:

- masks are boolean with True = attend; a masked logit becomes
  ``finfo(logits.dtype).min`` (``attention.py:43``), so a row with every
  key masked gets uniform weights, as there, not NaN;
- the softmax runs in float32 and its weights are cast back to
  ``v.dtype`` before the product with V (``:44-46``);
- rotary embeddings use the half-split convention (``:102-111``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..errors import InvalidInputError


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D), mask broadcastable to
    (B, Hq, Tq, Tk) with True = attend.

    Grouped-query attention pairs q-head h with kv-head h // (Hq/Hkv):
    the pairing of ``jnp.repeat`` (``attention.py:38``) and of
    ``torch.repeat_interleave`` along the head axis. The q heads of one
    group are folded into the row axis of one product with their kv head,
    which is that pairing without materialising the repeated K/V.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise InvalidInputError("q heads must be a multiple of kv heads",
                                hq=hq, hkv=hkv)
    rep = hq // hkv
    logits = torch.matmul(q.reshape(b, hkv, rep * tq, d),
                          k.transpose(-1, -2)).reshape(b, hq, tq, tk) \
        * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    out = torch.matmul(weights.reshape(b, hkv, rep * tq, tk), v)
    return out.reshape(b, hq, tq, d)


# ------------------------------- masks -------------------------------

def create_causal_mask(t: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) lower-triangular attend mask."""
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()[None, None]


def create_left_padding_mask(valid_lengths: torch.Tensor,
                             t: int) -> torch.Tensor:
    """(B, 1, 1, T): key j is attended iff j >= T - valid_len[b] (the
    padding sits at the front of each row)."""
    pos = torch.arange(t, device=valid_lengths.device)[None, :]
    start = (t - valid_lengths)[:, None]
    return (pos >= start)[:, None, None, :]


def create_generation_mask(kv_len: torch.Tensor, capacity: int,
                           pad_len: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """(B, 1, 1, C): decode attends cache slots < kv_len[b], except the
    first pad_len[b] slots, which hold the K/V of left-padding tokens."""
    pos = torch.arange(capacity, device=kv_len.device)[None, :]
    keep = pos < kv_len[:, None]
    if pad_len is not None:
        keep = keep & (pos >= pad_len[:, None])
    return keep[:, None, None, :]


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Logical AND of attend masks; None when every mask is None."""
    out = None
    for m in masks:
        if m is not None:
            out = m if out is None else (out & m)
    return out


# ------------------------------- RoPE -------------------------------

def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate (…, T, D) by per-position cos/sin (…, T, D/2), half-split:
    x = [x1, x2] → [x1·cos − x2·sin, x2·cos + x1·sin]."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_cos_sin(position_ids: torch.Tensor, dim: int,
                  mrope_sections: Sequence[int],
                  theta: float = 10000.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-D multimodal RoPE tables (``attention.py:114-136``).

    ``position_ids`` (3, B, T): temporal / height / width position of each
    token. ``mrope_sections`` gives how many frequency pairs each axis
    owns (they sum to dim/2). Returns float32 cos/sin (B, T, dim/2), each
    frequency band read from its axis's positions.
    """
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=position_ids.device) / dim))
    freqs = position_ids[..., None].float() * inv          # (3, B, T, dim/2)
    cos, sin = freqs.cos(), freqs.sin()
    parts_c, parts_s, start = [], [], 0
    for axis, width in enumerate(mrope_sections):
        parts_c.append(cos[axis, ..., start:start + width])
        parts_s.append(sin[axis, ..., start:start + width])
        start += width
    return torch.cat(parts_c, -1), torch.cat(parts_s, -1)

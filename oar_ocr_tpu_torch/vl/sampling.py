"""Decode-side sampling helpers: repetition penalty, masking, sampling,
and the host-side truncation of repetition loops.

Counterpart of ``oar_ocr_tpu/vl/sampling.py``. Sampling takes an
explicit ``torch.Generator``; its draws are torch's, not JAX's, so the
two packages agree on the greedy branch and on the distribution sampled
from, not on the random tokens.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             penalty: float, vocab_size: int) -> torch.Tensor:
    """Tokens present in ``history`` (B, H), -1 padded: positive logits
    divided by ``penalty``, negative ones multiplied by it
    (``sampling.py:19-31``)."""
    b, v = logits.shape
    hist = history.to(torch.int64).clamp(0, vocab_size - 1)
    valid = (history >= 0).to(torch.int32)
    hits = torch.zeros((b, v), dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, hist, valid)
    seen = hits > 0
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def mask_token_ids(logits: torch.Tensor,
                   banned: Sequence[int]) -> torch.Tensor:
    """Banned ids set to the dtype's lowest value (``:34-39``)."""
    if not banned:
        return logits
    out = logits.clone()
    out[:, list(banned)] = torch.finfo(logits.dtype).min
    return out


def sample_with_confidence(logits: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           temperature: float = 1.0, top_p: float = 1.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token, probability) per row (``:42-64``): greedy with its softmax
    probability when ``temperature`` <= 0, else a draw from the
    temperature-scaled softmax restricted to the top-p nucleus."""
    if temperature <= 0:
        tok = logits.argmax(-1).to(torch.int32)
        return tok, torch.softmax(logits, -1).max(-1).values
    probs = torch.softmax(logits / temperature, -1)
    if top_p < 1.0:
        sorted_p = probs.sort(-1, descending=True).values
        csum = sorted_p.cumsum(-1)
        k = (csum < top_p).sum(-1) + 1
        thresh = sorted_p.gather(1, (k - 1)[:, None])
        probs = torch.where(probs >= thresh, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True)
    tok = torch.multinomial(probs.clamp(min=1e-20), 1,
                            generator=generator)[:, 0]
    return tok.to(torch.int32), probs.gather(1, tok[:, None])[:, 0]


def truncate_repetition(text: str, *, min_len: int = 4,
                        min_repeats: int = 6) -> str:
    """Cut degenerate repetition loops from decoded text (oar-ocr-vl
    utils.rs repetition truncation): when the tail is >= min_repeats
    consecutive copies of the same substring, keep one copy and stop."""

    n = len(text)
    for size in range(min_len, max(min_len, n // min_repeats) + 1):
        unit = text[n - size : n]
        if not unit:
            continue
        repeats = 1
        pos = n - size
        while pos - size >= 0 and text[pos - size : pos] == unit:
            repeats += 1
            pos -= size
        if repeats >= min_repeats:
            return text[: pos + size]
    return text

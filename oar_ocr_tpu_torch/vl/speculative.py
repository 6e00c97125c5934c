"""Speculative decoding primitives: draft → one verify pass → rollback.

Counterpart of ``oar_ocr_tpu/vl/speculative.py``. ``verify_draft``
compares the target's argmaxes with a draft block and accepts the
longest agreeing prefix plus the target's own next token; the KV cache
rolls back by a length reset (``KVCache.trim_to``). Every emitted token
is a target argmax, so speculative decoding gives greedy decoding's
tokens whatever the drafts are. ``ngram_draft`` drafts from the tokens
already committed (prompt lookup); ``recurrent_draft`` rolls one draft
step K times (GLM-OCR's MTP layer).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .kv_cache import KVCache


class VerifyResult(NamedTuple):
    accepted: torch.Tensor      # (B,) int32 — draft tokens accepted
    next_tokens: torch.Tensor   # (B, K+1) int32 — accepted + correction, -1 pad
    num_emitted: torch.Tensor   # (B,) int32 — accepted + 1


def verify_draft(draft_tokens: torch.Tensor,
                 target_logits: torch.Tensor) -> VerifyResult:
    """Greedy verification (``speculative.py:56-88``). ``draft_tokens``
    (B, K); ``target_logits`` (B, K+1, V) at [last committed, drafts…].
    Draft i is accepted iff the target's argmax at i equals it and every
    earlier draft was accepted; the emitted row is the accepted prefix,
    then the target's argmax at the first disagreement (or the bonus
    token), then -1."""
    b, k = draft_tokens.shape
    target = target_logits.argmax(-1).to(torch.int32)          # (B, K+1)
    match = target[:, :k] == draft_tokens.to(torch.int32)
    accepted = match.to(torch.int32).cumprod(dim=1).sum(dim=1).to(torch.int32)
    pos = torch.arange(k + 1, device=target.device)[None, :]
    acc = accepted[:, None]
    padded = torch.nn.functional.pad(draft_tokens.to(torch.int32), (0, 1))
    corr = target.gather(1, torch.maximum(pos, acc).clamp(max=k).expand(b, -1))
    emitted = torch.where(pos < acc, padded, corr)
    emitted = torch.where(pos <= acc, emitted, torch.full_like(emitted, -1))
    return VerifyResult(accepted, emitted, accepted + 1)


def rollback_cache(cache: KVCache, committed_length) -> KVCache:
    """Discard speculated entries past the committed length."""
    return cache.trim_to(committed_length)


def ngram_draft(hist: torch.Tensor, length: torch.Tensor, *, k: int,
                n: int = 2) -> torch.Tensor:
    """Prompt-lookup drafting (``speculative.py:97-134``). ``hist``
    (B, CAP) int32 committed tokens, ``length`` (B,) their count. Drafts
    the ``k`` tokens that followed the most recent earlier occurrence of
    the trailing ``n``-gram; a row with no match, or a draft that reads
    past the history (-1), gets its last committed token."""
    b, cap = hist.shape
    dev = hist.device
    length = length.to(device=dev, dtype=torch.int64)
    # dynamic_slice clamps a start to [0, cap - size]
    starts = (length - n).clamp(min=0).clamp(max=cap - n)
    gram = hist.gather(1, starts[:, None] + torch.arange(n, device=dev))
    w = max(cap - n, 1)
    i = torch.arange(w, device=dev)
    wins = hist[:, (i[:, None] + torch.arange(n, device=dev)[None]).clamp(
        max=cap - 1)]                                          # (B, W, n)
    match = (wins == gram[:, None, :]).all(-1)
    valid = (i[None, :] + n) <= (length[:, None] - 1)
    score = torch.where(match & valid, i[None, :] + 1, 0)
    best = score.max(dim=1).values
    has = best > 0
    cont = torch.where(has, best - 1 + n, 0).clamp(max=cap - k)
    drafts = hist.gather(1, cont[:, None] + torch.arange(k, device=dev))
    last = hist.gather(1, (length - 1).clamp(min=0)[:, None])   # (B, 1)
    drafts = torch.where(has[:, None], drafts, last.expand(b, k))
    drafts = torch.where(drafts < 0, last.expand(b, k), drafts)
    return drafts.to(torch.int32)


class MTPDraftState(NamedTuple):
    """An MTP draft layer's state between draft steps."""

    hidden: torch.Tensor        # (B, D) last target hidden state
    token: torch.Tensor         # (B,) last committed token


def recurrent_draft(draft_step: Callable, state: MTPDraftState,
                    k: int) -> Tuple[torch.Tensor, MTPDraftState]:
    """Roll one draft layer ``k`` times: ``draft_step(hidden, token) →
    (new_hidden, logits)``. Returns (drafts (B, k) int32, final state)."""
    h, tok = state.hidden, state.token
    drafts = []
    for _ in range(k):
        h, logits = draft_step(h, tok)
        tok = logits.argmax(-1).to(torch.int32)
        drafts.append(tok)
    return torch.stack(drafts, dim=1), MTPDraftState(h, tok)

"""SDAR block-diffusion decoding schedule (MinerU-Diffusion).

Counterpart of ``oar_ocr_tpu/vl/diffusion.py``: a block of L tokens is
decoded by iterative unmasking. Each step predicts every masked position
at once and commits those whose confidence passes a threshold, and at
least the schedule's count of the most confident ones, until the block
is complete.
"""

from __future__ import annotations

from typing import Callable

import torch

MASK_ID = -1


def transfer_count(step: int, num_steps: int, block_len: int) -> int:
    """Tokens committed by step ``step``: ⌈L·(step+1)/num_steps⌉, at
    least 1 (``diffusion.py:34-39``)."""
    return max(1, -(-block_len * (step + 1) // num_steps))


def unmask_step(tokens: torch.Tensor, logits: torch.Tensor, *,
                confidence_threshold: float,
                min_transfer: int) -> torch.Tensor:
    """One step (``:42-66``): tokens (B, L) with MASK_ID where masked,
    logits (B, L, V). Commits each masked position whose softmax maximum
    reaches the threshold, and the ``min_transfer`` most confident masked
    positions; ties in confidence go to the lower position, as the JAX
    stable argsort orders them."""
    conf = torch.softmax(logits.float(), -1).max(-1).values
    pred = logits.argmax(-1).to(torch.int32)
    masked = tokens == MASK_ID
    conf_masked = torch.where(masked, conf, float("-inf"))
    order = torch.argsort(-conf_masked, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    take = masked & ((conf >= confidence_threshold) | (rank < min_transfer))
    return torch.where(take, pred, tokens.to(torch.int32))


def decode_block(predictor: Callable[[torch.Tensor], torch.Tensor],
                 block_len: int, batch: int, *, num_steps: int = 8,
                 confidence_threshold: float = 0.9,
                 device=None) -> torch.Tensor:
    """Unmask one block to completion in at most ``num_steps`` predictor
    calls (``:69-93``); a step runs only while a position is masked."""
    tokens = torch.full((batch, block_len), MASK_ID, dtype=torch.int32,
                        device=device)
    for s in range(num_steps):
        if not bool((tokens == MASK_ID).any()):
            break
        prev = transfer_count(s - 1, num_steps, block_len) if s else 0
        tokens = unmask_step(
            tokens, predictor(tokens),
            confidence_threshold=confidence_threshold,
            min_transfer=transfer_count(s, num_steps, block_len) - prev)
    return tokens

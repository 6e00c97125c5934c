"""SDAR block-diffusion decoding schedule (MinerU-Diffusion).

Counterpart of ``oar_ocr_tpu/vl/diffusion.py``: a block of L tokens is
decoded by iterative unmasking. Each step predicts every masked position
at once and commits those whose confidence passes a threshold, and at
least the schedule's count of the most confident ones, until the block
is complete.

:class:`DiffusionBlocks` runs that loop for a decoder, as the JAX
package's block loops do (``exact_models.py:761-830``,
``families.py:868-949``): JAX jits the bidirectional trial pass and the
causal commit pass, one program each per (block length, cache shape)
with the slot traced, and the host reads the tokens once per unmask
step. Here each pass is one body on the static buffers of a
(block length, KV capacity) key (:class:`BlockState`), replayed as a
CUDA graph on the card: the trial feeds the block (masked positions as
the mask token) at the 0-d device slot ``wpos``, rolls its K/V back
(``trim_to(wpos)``, on the device) and unmasks in place
(:func:`unmask_step`, the schedule's count and the threshold as device
buffers); the commit writes the block causally and advances ``wpos``
and the block's positions by L. The host reads the tokens once per
unmask step (its check for a masked position and the block's EOS scan
use that copy). A key's first trial and first commit run eagerly on a
side stream and are then captured; later ones replay. ``graph=False``
runs the same bodies eagerly, and on the CPU they always run eagerly:
the plain version the tests hold to the JAX loops. A capture or a replay
that fails raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .decode_graph import CapturedGraph, replay_or_capture
from .kv_cache import KVCache

MASK_ID = -1


def transfer_count(step: int, num_steps: int, block_len: int) -> int:
    """Tokens committed by step ``step``: ⌈L·(step+1)/num_steps⌉, at
    least 1 (``diffusion.py:34-39``)."""
    return max(1, -(-block_len * (step + 1) // num_steps))


def unmask_step(tokens: torch.Tensor, logits: torch.Tensor, *,
                confidence_threshold, min_transfer) -> torch.Tensor:
    """One step (``:42-66``): tokens (B, L) with MASK_ID where masked,
    logits (B, L, V). Commits each masked position whose softmax maximum
    reaches the threshold, and the ``min_transfer`` most confident masked
    positions; ties in confidence go to the lower position, as the JAX
    stable argsort orders them. The threshold (float32) and the count
    (int64) may be 0-d device tensors (a captured trial's buffers)."""
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


class BlockState:
    """The static buffers of one (block length, KV capacity) key:

    - ``cache``, the static KV cache the prompt's prefill fills;
    - ``tokens`` (1, L) int32, the block (MASK_ID where masked), which
      the trial unmasks in place and the commit writes;
    - ``wpos``, a 0-d int64: the block's first KV slot;
    - ``positions``, the block's rotary positions (the model's shape and
      dtype), advanced by L with ``wpos``;
    - ``min_transfer`` (0-d int64) and ``threshold`` (0-d float32), the
      unmask step's schedule count and confidence threshold;
    - ``host``, the pinned host buffer each unmask step's read copies
      ``tokens`` into (``tokens`` itself on the CPU);
    - the model's own buffers (keyword arguments, kept as attributes:
      the exact stack's delta carry ``dstate`` / ``conv``).

    ``graphs`` holds the captured ``"trial"`` and ``"commit"`` passes;
    they replay one after the other on one stream, so they share one
    memory pool, ``pool``."""

    def __init__(self, cache: KVCache, positions: torch.Tensor,
                 mask_token: int, **buffers):
        dev = cache.k.device
        block = positions.shape[-1]
        self.cache, self.positions = cache, positions
        self.mask_token = mask_token
        self.tokens = torch.full((1, block), MASK_ID, dtype=torch.int32,
                                 device=dev)
        self.wpos = torch.zeros((), dtype=torch.int64, device=dev)
        self.min_transfer = torch.zeros((), dtype=torch.int64, device=dev)
        self.threshold = torch.zeros((), dtype=torch.float32, device=dev)
        self.host = (torch.empty((1, block), dtype=torch.int32,
                                 pin_memory=True)
                     if dev.type == "cuda" else self.tokens)
        self.graphs: Dict[str, CapturedGraph] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if dev.type == "cuda" else None)
        for name, buf in buffers.items():
            setattr(self, name, buf)

    @property
    def block(self) -> int:
        return self.tokens.shape[1]

    def begin(self, wpos: int, positions: torch.Tensor,
              confidence_threshold: float) -> None:
        """Load a request: the first block's KV slot and positions (a
        tensor broadcastable to the positions' shape) and the threshold;
        the block all masked."""
        self.tokens.fill_(MASK_ID)
        self.wpos.fill_(wpos)
        self.positions.copy_(positions)
        self.threshold.fill_(confidence_threshold)

    def read(self) -> np.ndarray:
        """The unmask step's one host read: the block's (L,) tokens."""
        if self.host is not self.tokens:
            self.host.copy_(self.tokens, non_blocking=True)
            torch.cuda.current_stream(self.tokens.device).synchronize()
        return self.host[0].numpy().copy()


# (state, fed block (1, L) int32) → the bidirectional trial's float32
# (1, L, vocab) logits, at slot state.wpos; the pass advances the cache
TrialPass = Callable[[BlockState, torch.Tensor], torch.Tensor]
# state → None: the causal pass of state.tokens at slot state.wpos,
# advancing the cache by L
CommitPass = Callable[[BlockState], None]


class DiffusionBlocks:
    """A model's block-diffusion states by key, each built at its key's
    first request and kept with the model, and the block loop over them:
    ``trial`` and ``commit`` are the model's two passes."""

    def __init__(self, trial: TrialPass, commit: CommitPass):
        self._trial, self._commit = trial, commit
        self.states: Dict[tuple, BlockState] = {}

    def state(self, key: tuple, make: Callable[[], BlockState]
              ) -> BlockState:
        if key not in self.states:
            self.states[key] = make()
        return self.states[key]

    def trial_body(self, st: BlockState) -> torch.Tensor:
        """One unmask step in place: the trial pass over the block (its
        masked positions fed as the mask token), its K/V rolled back,
        the block unmasked → the trial's logits."""
        feed = torch.where(st.tokens == MASK_ID, st.mask_token, st.tokens)
        logits = self._trial(st, feed)
        st.cache.trim_to(st.wpos)                 # the trial is discarded
        st.tokens.copy_(unmask_step(st.tokens, logits,
                                    confidence_threshold=st.threshold,
                                    min_transfer=st.min_transfer))
        return logits

    def commit_body(self, st: BlockState) -> None:
        """The block's causal commit in place, then the next block's
        slot and positions and an all-masked block."""
        self._commit(st)
        st.wpos += st.block
        st.positions += st.block
        st.tokens.fill_(MASK_ID)

    def _run(self, st: BlockState, name: str, body: Callable[[], object],
             graph: bool):
        """``body`` through its key's graph on the card unless ``graph``
        is False (``vl/decode_graph.replay_or_capture``) → its return
        value."""
        if graph and st.tokens.device.type == "cuda":
            return replay_or_capture(st.graphs, name, body,
                                     st.tokens.device, st.pool)
        return body()

    @torch.inference_mode()
    def decode(self, st: BlockState, n_blocks: int, num_steps: int,
               eos: int, *, graph: bool = True,
               logits: Optional[List[torch.Tensor]] = None) -> List[int]:
        """Up to ``n_blocks`` blocks from the state :meth:`BlockState.begin`
        loaded, each unmasked in at most ``num_steps`` trials (a trial
        runs only while the host's copy of the block holds a masked
        position) and committed; stops after the block that holds
        ``eos`` → the ids before it. ``logits``, when a list, receives
        each trial's logits (a copy after a replay)."""
        ids: List[int] = []
        for _ in range(n_blocks):
            tokens = np.full((st.block,), MASK_ID, np.int32)
            for s in range(num_steps):
                if not (tokens == MASK_ID).any():
                    break
                prev = transfer_count(s - 1, num_steps, st.block) if s else 0
                st.min_transfer.fill_(
                    transfer_count(s, num_steps, st.block) - prev)
                out = self._run(st, "trial", lambda: self.trial_body(st),
                                graph)
                if logits is not None:
                    logits.append(out.clone())
                tokens = st.read()
            self._run(st, "commit", lambda: self.commit_body(st), graph)
            done = False
            for v in tokens.tolist():
                if v == eos:
                    done = True
                    break
                ids.append(int(v))
            if done:
                break
        return ids

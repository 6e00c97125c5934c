"""HPD-Parsing continuous-batching scheduler with per-branch P-MTP.

Counterpart of ``oar_ocr_tpu/vl/hpd_scheduler.py`` (the reference's fork
scheduler, oar-ocr-vl/src/hpd_parsing/model.rs:467-723):

- the parent decodes with fork permission; every emitted ``<FORK>`` token
  spawns a child branch whose KV is the parent's cache up to the fork
  position and whose first input is the ``<CHILD>`` token;
- all live branches advance as one decode batch per scheduler round;
  newly forked children are admitted with priority, preempting older
  unfinished branches into a FIFO waiting queue beyond
  ``max_active_branches``;
- with P-MTP, each branch drafts ``num_speculative_tokens`` tokens through
  the MTP head (``llm_decoders.HpdMtpHead``) and one causal target pass
  verifies them; greedy and P-MTP emit identical tokens.

Branches live in a slot pool: one KV cache whose batch is a power-of-two
slot count, grown on demand, in the JAX package's row order (padding a
batch changes a library matmul's bits, so the pool and its order are
kept). Every round runs over all slots at per-row positions: the verify
block's K4 launch writes each row's k at that row's own slot (a (S,)
device vector), its v goes through ``KVCache.append``'s per-row write,
and the frozen rows (waiting, finished) write slots past their length
that ``with_lengths`` then discards, as the JAX round's do. A round is
eager; its host reads are the targets and the accept counts, once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..errors import InvalidInputError
from ..models.layers import init_state_dict
from .kv_cache import KVCache
from .llm_decoders import HpdMtpHead

DEFAULT_SPECULATIVE_TOKENS = 6    # hpd_parsing/model.rs:19
DEFAULT_MAX_ACTIVE_BRANCHES = 64  # model.rs:23-41


@dataclass
class HpdSchedulerConfig:
    """HpdGenerationConfig parity (model.rs:23-41)."""

    max_new_tokens: int = 48
    use_mtp: bool = True
    num_speculative_tokens: int = DEFAULT_SPECULATIVE_TOKENS
    max_active_branches: int = DEFAULT_MAX_ACTIVE_BRANCHES

    def validate(self) -> None:
        if self.use_mtp and self.num_speculative_tokens == 0:
            raise InvalidInputError(
                "num_speculative_tokens must be non-zero when P-MTP is on")
        if self.max_active_branches == 0:
            raise InvalidInputError("max_active_branches must be non-zero")


@dataclass
class HpdStats:
    """HpdRuntimeStats parity (model.rs:71-81)."""

    scheduler_rounds: int = 0
    peak_active_branches: int = 0
    forked_branches: int = 0
    shared_prefix_tokens: int = 0
    mtp_drafted_tokens: int = 0
    mtp_accepted_tokens: int = 0


@dataclass
class _Branch:
    slot: int
    child_index: Optional[int]          # None = parent
    allow_fork: bool
    max_new: int
    pending: int                        # next input token (not yet in KV)
    fresh: bool                         # first round after fork: input is
                                        # <CHILD>, which is never emitted
    tokens: List[int] = field(default_factory=list)
    finished: bool = False


@dataclass
class HpdSchedulerOutput:
    parent_tokens: List[int]
    children: List[List[int]]
    token_ids: List[int]                # parent with children spliced in
    stats: HpdStats


class HpdContinuousScheduler:
    """Drives an ``ExactVLM`` through the fork scheduler. ``mtp_state_dict``
    holds the P-MTP head's weights; without one they are seeded from
    ``seed``."""

    def __init__(self, model, *, fork_token_id: int, child_token_id: int,
                 stop_token_ids: Tuple[int, ...] = (),
                 mtp_state_dict=None, seed: int = 11):
        self.model = model
        c = model.spec.text_cfg
        self.cfg_text = c
        self.fork_token_id = int(fork_token_id)
        self.child_token_id = int(child_token_id)
        self.stop_token_ids = set(int(s) for s in stop_token_ids)
        self.stop_token_ids.add(c.eos_id)
        dev = model.device
        with torch.device("meta"):
            mtp = HpdMtpHead(c)
        if mtp_state_dict is None:
            mtp_state_dict = init_state_dict(
                mtp, torch.Generator(device=dev).manual_seed(seed))
        mtp.load_state_dict(mtp_state_dict, strict=True, assign=True)
        self.mtp = mtp.eval().requires_grad_(False).to(device=dev,
                                                       dtype=torch.float32)

    # ------------------------------------------------------------------
    def _round(self, cache: KVCache, hidden, pending, fresh, advance, *,
               k: int):
        """One scheduler round over all S slots: k MTP draft steps + one
        causal verify pass (advance_mtp_batch, model.rs:605-702; k = 0 is
        advance_greedy_batch, :568-603)."""
        net = self.model.net
        s = pending.shape[0]
        starts = cache.length.clone()
        drafts = []
        h, prev = hidden, pending
        for _ in range(k):
            e = net.embed(prev[:, None])[:, 0]
            h = self.mtp(h.float(), e.float())
            prev = net.lm_logits(h).argmax(-1).to(torch.int32)
            drafts.append(prev)
        verify = pending[:, None]
        if k:
            drafts_a = torch.stack(drafts, 1)                   # (S, k)
            verify = torch.cat([verify, drafts_a], 1)
        pids = starts.long()[:, None] + torch.arange(
            k + 1, device=starts.device)[None]
        logits, hid, _, _ = net.decode_block(
            verify, pids, cache, starts.long(), *self.model.empty_states(s))
        targets = logits.argmax(-1).to(torch.int32)             # (S, k+1)
        if k:
            eq = (drafts_a == targets[:, :k]).to(torch.int32)
            matched = eq.cumprod(1).sum(1).to(torch.int32)
        else:
            matched = torch.zeros((s,), dtype=torch.int32,
                                  device=targets.device)
        # fresh rows accept nothing (start_branch, model.rs:438-465: the
        # <CHILD> forward only seeds hidden + first pending token); frozen
        # rows neither advance nor keep their writes
        matched = torch.where(fresh | ~advance, 0, matched)
        cache.with_lengths(torch.where(advance, starts + 1 + matched, starts))
        idx = torch.arange(s, device=hid.device)
        new_hidden = torch.where(advance[:, None],
                                 hid[idx, matched.long()].to(hidden.dtype),
                                 hidden)
        return targets, matched, new_hidden

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self, prefix_cache: KVCache, first_token: int, first_hidden,
            gen: HpdSchedulerConfig) -> HpdSchedulerOutput:
        """Schedule from a completed batch-1 prefill: ``prefix_cache`` holds
        the prompt KV (advanced to the prompt length), ``first_token`` is
        the parent's pending token and ``first_hidden`` (1, H) the last
        prefill hidden (the P-MTP producer)."""
        gen.validate()
        stats = HpdStats()
        capacity = prefix_cache.capacity
        c = self.cfg_text
        dev = prefix_cache.k.device

        s = 1
        cache = KVCache(prefix_cache.k[:, :1].clone(),
                        prefix_cache.v[:, :1].clone(),
                        prefix_cache.length[:1].clone(),
                        torch.zeros_like(prefix_cache.pad[:1]))
        hidden = torch.as_tensor(first_hidden, dtype=torch.float32,
                                 device=dev).reshape(1, c.hidden).clone()

        parent = _Branch(slot=0, child_index=None, allow_fork=True,
                         max_new=gen.max_new_tokens,
                         pending=int(first_token), fresh=False)
        active: List[_Branch] = [parent]
        waiting: List[_Branch] = []
        free_slots: List[int] = []
        children_tokens: List[List[int]] = []
        parent_tokens: Optional[List[int]] = None
        lengths = [int(prefix_cache.length[0])]   # host mirror per slot

        def grow(min_slots: int):
            nonlocal s, cache, hidden, lengths
            new_s = s
            while new_s < min_slots:
                new_s *= 2
            if new_s != s:
                cache = cache.pad_batch(new_s)
                hidden = torch.nn.functional.pad(hidden, (0, 0, 0, new_s - s))
                lengths = lengths + [0] * (new_s - s)
                free_slots.extend(range(s, new_s))
                s = new_s

        while active or waiting:
            while len(active) < gen.max_active_branches and waiting:
                active.append(waiting.pop(0))
            stats.scheduler_rounds += 1
            stats.peak_active_branches = max(stats.peak_active_branches,
                                             len(active))

            k = gen.num_speculative_tokens if gen.use_mtp else 0
            if k:
                # binary k (K or 0), as the JAX scheduler: a full-K write
                # window must fit every live slot's tail, else a greedy
                # round (a clamped start would clobber a waiting branch)
                live_max = max((lengths[br.slot]
                                for br in active + waiting), default=0)
                if capacity - live_max - 2 < k:
                    k = 0
            adv = np.zeros((s,), bool)
            fresh = np.zeros((s,), bool)
            pending = np.zeros((s,), np.int32)
            for br in active:
                adv[br.slot] = True
                fresh[br.slot] = br.fresh
                pending[br.slot] = br.pending
            if gen.use_mtp:
                stats.mtp_drafted_tokens += k * sum(
                    1 for br in active if not br.fresh)

            put = self.model.runtime.put
            targets, matched, hidden = self._round(
                cache, hidden, put(pending), put(fresh), put(adv), k=k)
            targets = targets.cpu().numpy()
            matched = matched.cpu().numpy()

            # --- emit + fork events (model.rs:704-723) ---
            events: List[Tuple[_Branch, int]] = []   # (branch, prefix)

            def emit(br: _Branch, token: int, prefix_len: int):
                if br.finished:
                    return
                br.tokens.append(token)
                if br.allow_fork and token == self.fork_token_id:
                    events.append((br, prefix_len))
                if (token in self.stop_token_ids
                        or len(br.tokens) >= br.max_new):
                    br.finished = True

            for br in active:
                start = lengths[br.slot]
                m = int(matched[br.slot])
                if gen.use_mtp and not br.fresh:
                    stats.mtp_accepted_tokens += m
                if not br.fresh:
                    emit(br, br.pending, start)
                for offset in range(m):
                    if br.finished:
                        break
                    emit(br, int(targets[br.slot, offset]),
                         start + 1 + offset)
                br.pending = int(targets[br.slot, m])
                br.fresh = False
                lengths[br.slot] = start + 1 + m

            # --- spawn children from the post-verification cache at the
            # exact pre-<FORK> boundary (model.rs:496-525) ---
            spawned: List[_Branch] = []
            for parent_br, prefix_len in events:
                remaining = capacity - prefix_len - 1
                if remaining <= 0:
                    continue
                if not free_slots:
                    grow(s + 1)
                slot = free_slots.pop(0)
                cache.copy_row(parent_br.slot, slot, prefix_len)
                hidden[slot] = 0.0
                lengths[slot] = prefix_len
                child_index = len(children_tokens)
                children_tokens.append([])
                stats.forked_branches += 1
                stats.shared_prefix_tokens += prefix_len
                spawned.append(_Branch(
                    slot=slot, child_index=child_index, allow_fork=False,
                    max_new=min(gen.max_new_tokens, remaining),
                    pending=self.child_token_id, fresh=True))

            unfinished: List[_Branch] = []
            for br in active:
                if br.finished:
                    if br.child_index is None:
                        parent_tokens = br.tokens
                    else:
                        children_tokens[br.child_index] = br.tokens
                    free_slots.append(br.slot)
                else:
                    unfinished.append(br)
            # children bypass FCFS admission; overflow preempts older
            # unfinished branches into the waiting queue (model.rs:541)
            active = list(spawned)
            while len(active) < gen.max_active_branches and (
                    unfinished or waiting):
                active.append(unfinished.pop(0) if unfinished
                              else waiting.pop(0))
            waiting.extend(unfinished)
            if len(active) > gen.max_active_branches:
                waiting.extend(active[gen.max_active_branches:])
                active = active[: gen.max_active_branches]

        assert parent_tokens is not None, "scheduler lost the parent"
        final: List[int] = []
        child_i = 0
        for tok in parent_tokens:
            if tok == self.fork_token_id:
                final.append(self.child_token_id)
                if child_i < len(children_tokens):
                    final.extend(children_tokens[child_i])
                    child_i += 1
            else:
                final.append(tok)
        return HpdSchedulerOutput(parent_tokens, children_tokens, final,
                                  stats)

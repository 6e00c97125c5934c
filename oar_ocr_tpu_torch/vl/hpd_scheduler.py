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
that ``with_lengths`` then discards, as the JAX round's do.

The JAX round is one program per (S, k) (``hpd_scheduler.py:121-177``,
jitted per key; capacity too, since jit keys on the cache's shape). Here
a pool of S slots at one KV capacity is a :class:`SlotPool`: its static
cache, hidden states, round inputs and outputs, and one CUDA graph per k
(K, or 0 when the write window does not fit), all sharing the pool's
memory pool. The pools' caches are the leading S rows of one buffer per
capacity (``kv_cache.RowBuffers``, shared by the greedy and the P-MTP
scheduler of a model), so all the pools a request grows through hold as
many rows as the largest one. A round copies its inputs (pending token,
fresh, advance) from one pinned host buffer into the pool's input
buffer, replays the k's graph (its first round runs eagerly on a side
stream and is then captured, ``vl/decode_graph.warm_up``), and reads
(targets, matched) into one pinned host buffer: one read a round, as the
JAX host's. The round writes the cache lengths and the hidden states in
place. ``grow`` moves to the next power of two's pool, whose cache
extends the same rows (``KVCache.pad_into`` zeroes the new ones; when
the buffer is too small it is replaced by one of the new size, the rows
are copied over in their order and the pools on the old buffer are
dropped), and a fork copies the parent's row and zeroes the child's
hidden state in those buffers between replays, so every graph keeps its
addresses. ``graph=False`` runs the same round body eagerly, and on the
CPU it always runs eagerly: the plain version the tests hold to the JAX
round. The binary k, preemption, emit and fork logic stays on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import InvalidInputError
from ..models.layers import init_state_dict
from .decode_graph import CapturedGraph, replay_or_capture
from .kv_cache import KVCache, RowBuffers
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


class SlotPool:
    """The static buffers of one (slots S, KV capacity) pool:

    - ``cache``, the pool's KV cache (S rows);
    - ``hidden`` (S, hidden) float32, each slot's P-MTP producer;
    - ``inputs`` (3, S) int32: the pending tokens, fresh and advance
      flags, and ``staging``, the pinned host buffer each round's inputs
      are written into (``inputs`` itself on the CPU);
    - ``dstate`` / ``conv``, the zero recurrent states the verify block
      takes;
    - by k: ``out[k]`` (S, k + 2) int32, the targets (k + 1) and the
      accept count, ``host[k]`` its pinned host copy, and ``graphs[k]``
      the captured round. Its rounds replay one at a time on one
      stream, so the graphs share one memory pool, ``pool``."""

    def __init__(self, cache: KVCache, hidden: int, states):
        s, dev = cache.k.shape[1], cache.k.device
        self.cache = cache
        self.hidden = torch.zeros((s, hidden), dtype=torch.float32,
                                  device=dev)
        self.inputs = torch.zeros((3, s), dtype=torch.int32, device=dev)
        self.staging = (torch.zeros((3, s), dtype=torch.int32,
                                    pin_memory=True)
                        if dev.type == "cuda" else self.inputs)
        self.dstate, self.conv = states
        self.out: Dict[int, torch.Tensor] = {}
        self.host: Dict[int, torch.Tensor] = {}
        self.graphs: Dict[int, CapturedGraph] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if dev.type == "cuda" else None)

    @property
    def slots(self) -> int:
        return self.hidden.shape[0]

    def outputs(self, k: int) -> torch.Tensor:
        """The (S, k + 2) output buffer of k's rounds (made at its first
        round, outside any capture)."""
        if k not in self.out:
            s, dev = self.slots, self.hidden.device
            self.out[k] = torch.zeros((s, k + 2), dtype=torch.int32,
                                      device=dev)
            self.host[k] = (torch.empty((s, k + 2), dtype=torch.int32,
                                        pin_memory=True)
                            if dev.type == "cuda" else self.out[k])
        return self.out[k]

    def read(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The round's one host read → (targets (S, k + 1), matched
        (S,))."""
        out, host = self.out[k], self.host[k]
        if host is not out:
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(out.device).synchronize()
        a = host.numpy().copy()
        return a[:, :k + 1], a[:, k + 1]


class HpdContinuousScheduler:
    """Drives an ``HpdForkExact`` through the fork scheduler.
    ``mtp_state_dict`` holds the P-MTP head's weights; without one they
    are seeded from ``seed``. The pools' caches are rows of the model's
    ``slot_rows`` (:class:`~.kv_cache.RowBuffers`)."""

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
        # the slot pools by (slots, capacity, dtype), their caches rows
        # of ``self.rows``' buffer of that capacity and dtype
        self.pools: Dict[Tuple[int, int, torch.dtype], SlotPool] = {}
        self.rows: RowBuffers = model.slot_rows.join(self)

    # ------------------------------------------------------------------
    def pool(self, slots: int, capacity: int, dtype: torch.dtype,
             device: torch.device) -> SlotPool:
        """The (slots, capacity, dtype) pool's static buffers, made at its
        first use and kept with the scheduler while its rows' buffer
        lasts, as the JAX jit cache keeps its round programs."""
        key = (slots, capacity, dtype)
        if key not in self.pools:
            cache = self.rows.cache(slots, capacity, dtype, device)
            self.pools[key] = SlotPool(
                cache, self.cfg_text.hidden,
                self.model.net.text.empty_states(slots, device))
        return self.pools[key]

    def drop_rows(self, capacity: int, dtype: torch.dtype) -> None:
        """Drop the pools (their graphs with them) on the (capacity,
        dtype) buffer that ``self.rows`` is replacing."""
        for key in [k for k in self.pools if k[1:] == (capacity, dtype)]:
            del self.pools[key]

    def round_body(self, p: SlotPool, k: int) -> None:
        """One scheduler round over all S slots, in place on the pool's
        buffers: k MTP draft steps + one causal verify pass
        (advance_mtp_batch, model.rs:605-702; k = 0 is
        advance_greedy_batch, :568-603); the JAX ``_round_impl``. Writes
        the cache lengths, ``hidden`` and ``out[k]``."""
        net = self.model.net
        cache, hidden = p.cache, p.hidden
        pending = p.inputs[0]
        fresh, advance = p.inputs[1].bool(), p.inputs[2].bool()
        s = pending.shape[0]
        if self.cfg_text.delta_layers():
            p.dstate.zero_()
            p.conv.zero_()
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
            verify, pids, cache, starts.long(), p.dstate, p.conv)
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
        hidden.copy_(torch.where(advance[:, None],
                                 hid[idx, matched.long()].to(hidden.dtype),
                                 hidden))
        out = p.out[k]
        out[:, :k + 1].copy_(targets)
        out[:, k + 1].copy_(matched)

    @torch.inference_mode()
    def round(self, p: SlotPool, k: int, *, graph: bool = True
              ) -> Tuple[np.ndarray, np.ndarray]:
        """One round from the inputs staged in ``p.staging`` → (targets
        (S, k + 1), matched (S,)), read once. On a CUDA pool unless
        ``graph`` is False it replays k's graph; the first round of a k
        runs eagerly on a side stream and is then captured."""
        p.outputs(k)
        if p.staging is not p.inputs:
            p.inputs.copy_(p.staging, non_blocking=True)
        if graph and p.hidden.device.type == "cuda":
            replay_or_capture(p.graphs, k, lambda: self.round_body(p, k),
                              p.hidden.device, p.pool)
        else:
            self.round_body(p, k)
        return p.read(k)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def run(self, prefix_cache: KVCache, first_token: int, first_hidden,
            gen: HpdSchedulerConfig, *, graph: bool = True,
            round_log: Optional[list] = None) -> HpdSchedulerOutput:
        """Schedule from a completed batch-1 prefill: ``prefix_cache`` holds
        the prompt KV (advanced to the prompt length), ``first_token`` is
        the parent's pending token and ``first_hidden`` (1, H) the last
        prefill hidden (the P-MTP producer). The rounds replay their
        pools' graphs on the card unless ``graph`` is False.
        ``round_log``, when a list, receives each round's (k, targets,
        matched, hidden after it on the host)."""
        gen.validate()
        stats = HpdStats()
        capacity = prefix_cache.capacity
        c = self.cfg_text
        dev, dtype = prefix_cache.k.device, prefix_cache.k.dtype

        s = 1
        p = self.pool(1, capacity, dtype, dev)
        prefix_cache.rows(1).pad_into(p.cache)
        p.cache.pad.zero_()
        p.hidden.copy_(torch.as_tensor(first_hidden, dtype=torch.float32,
                                       device=dev).reshape(1, c.hidden))

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
            nonlocal s, p, lengths
            new_s = s
            while new_s < min_slots:
                new_s *= 2
            if new_s != s:
                bigger = self.pool(new_s, capacity, dtype, dev)
                p.cache.pad_into(bigger.cache)
                bigger.hidden[:s].copy_(p.hidden)
                bigger.hidden[s:].zero_()
                p = bigger
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
            staged = p.staging.numpy()
            staged.fill(0)                    # pending, fresh, advance
            for br in active:
                staged[:, br.slot] = (br.pending, br.fresh, True)
            if gen.use_mtp:
                stats.mtp_drafted_tokens += k * sum(
                    1 for br in active if not br.fresh)

            targets, matched = self.round(p, k, graph=graph)
            if round_log is not None:
                round_log.append((k, targets, matched, p.hidden.cpu()))

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
                p.cache.copy_row(parent_br.slot, slot, prefix_len)
                p.hidden[slot] = 0.0
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

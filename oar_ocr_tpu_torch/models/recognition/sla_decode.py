"""The table-structure decode loop: an eager loop, and chunks of steps
replayed as a CUDA graph on the card.

Counterpart of the two ``nn.while_loop``s of the JAX package's table
heads (``oar_ocr_tpu/models/recognition/slanet.py:96-133``,
``slanet_exact.py:322-361``). Their semantics, kept exactly:

- (B, T, vocab) logits and (B, T, loc) corner buffers, pre-filled with
  the EOS logit 1.0 (all else 0), so a step that never runs decodes as
  EOS;
- a step: the head's new hidden state, logits and corners from the fed
  token; ``nxt = argmax``; ``done_next = done | (nxt == EOS)``;
  ``nxt = where(done, EOS, nxt)`` with the OLD ``done``; the step's
  logits and corners written at its index;
- step 0 runs the same body, and the loop stops before the first step
  at which every row is done, or after T steps (T = ``max_steps``, 500,
  for SLANet; ``max_text_length + 1``, 501, for SLANet_plus and
  SLANeXt).

A head (:class:`SLADecoder`) gives :meth:`~SLADecoder.prepare`, the
loop-invariant projections of its memory (computed once; the JAX
``i2h(batch_H)`` of every step is the same product each time), and
:meth:`~SLADecoder.step`. :meth:`SLADecoder.decode` is the plain version:
an eager Python loop that reads ``done.all()`` before each step, the CPU
path and the card's reference.

On the card :class:`DecodeGraphs` captures :data:`CHUNK` steps as one
CUDA graph per (batch, memory shape) on static buffers: the hidden
state, the fed token, ``done``, the step counter and the step count run,
all on the device, and buffers padded to a whole number of chunks. The
host replays a chunk and reads ``done.all()`` once per chunk. A step of
a chunk that runs after every row is done (the JAX loop would have
stopped) writes the pre-fill, not its logits: ``active = ~done.all()``
is taken on the device before the step and selects what is written, so
the buffers equal the eager loop's everywhere, past each row's EOS too,
and no reset after the loop is needed. Steps past T write the padding,
which is cut off. The first decode of a key runs one chunk eagerly on a
side stream (it loads cuBLAS's handles, which a capture cannot), resets
the state and captures; a failed capture or replay raises, nothing falls
back to the eager loop.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

SOS_ID, EOS_ID = 0, 1
# decode steps per captured graph; the host reads done.all() once a chunk
CHUNK = 16


class SLADecoder(nn.Module):
    """A table head's decoder: ``vocab`` logits and ``loc_dim`` corners
    per step from a ``hidden``-wide state, at most ``steps`` steps."""

    def __init__(self, vocab: int, hidden: int, loc_dim: int, steps: int):
        super().__init__()
        self.vocab, self.hidden = vocab, hidden
        self.loc_dim, self.steps = loc_dim, steps

    def prepare(self, memory: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The loop-invariant tensors of a (B, L, C) float32 memory."""
        raise NotImplementedError

    def step(self, h: torch.Tensor, tok: torch.Tensor,
             ctx: Tuple[torch.Tensor, ...]):
        """(new_h, logits (B, vocab), corners (B, loc_dim)) of one step
        fed ``tok`` (B,) int64 from the hidden state ``h``."""
        raise NotImplementedError

    def prefill(self, b: int, length: int, device) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
        """The (B, length, vocab) and (B, length, loc) buffers, EOS logit
        1.0 (``slanet.py:101-104``)."""
        logits = torch.zeros((b, length, self.vocab), device=device)
        logits[:, :, EOS_ID] = 1.0
        return logits, torch.zeros((b, length, self.loc_dim), device=device)

    @torch.no_grad()
    def decode(self, memory: torch.Tensor):
        """The plain loop: (logits (B, T, vocab), corners (B, T, loc),
        steps run)."""
        b, dev = memory.shape[0], memory.device
        ctx = self.prepare(memory)
        h = torch.zeros((b, self.hidden), device=dev)
        tok = torch.full((b,), SOS_ID, dtype=torch.int64, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        lbuf, obuf = self.prefill(b, self.steps, dev)
        step = 0
        while step < self.steps and not bool(done.all()):
            h, logits, loc = self.step(h, tok, ctx)
            nxt = logits.argmax(-1)
            done_next = done | (nxt == EOS_ID)
            tok = torch.where(done, EOS_ID, nxt)
            lbuf[:, step] = logits
            obuf[:, step] = loc
            done = done_next
            step += 1
        return lbuf, obuf, step


class DecodeState:
    """The static buffers and graph of one (batch, memory shape) key."""

    def __init__(self, head: SLADecoder, memory: torch.Tensor):
        b, dev = memory.shape[0], memory.device
        self.head = head
        self.length = math.ceil(head.steps / CHUNK) * CHUNK
        self.memory = torch.zeros_like(memory)
        self.ctx = tuple(torch.zeros_like(t)
                         for t in head.prepare(self.memory))
        self.h = torch.zeros((b, head.hidden), device=dev)
        self.tok = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.eos = torch.full((b,), EOS_ID, dtype=torch.int64, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.step = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.ran = torch.zeros((), dtype=torch.int64, device=dev)
        self.lbuf, self.obuf = head.prefill(b, self.length, dev)
        self.blank_logits = self.lbuf[0, 0].clone()
        self.blank_loc = self.obuf[0, 0].clone()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_ms: Optional[float] = None

    def start(self, memory: torch.Tensor) -> None:
        """Load a decode's memory and reset the loop, in place."""
        self.memory.copy_(memory)
        for dst, src in zip(self.ctx, self.head.prepare(self.memory)):
            dst.copy_(src)
        self.h.zero_()
        self.tok.fill_(SOS_ID)
        self.done.zero_()
        self.step.zero_()
        self.ran.zero_()
        self.lbuf.copy_(self.blank_logits.expand_as(self.lbuf))
        self.obuf.zero_()

    def run_step(self) -> None:
        """One step in place; writes the pre-fill once every row is
        done."""
        active = ~self.done.all()
        h, logits, loc = self.head.step(self.h, self.tok, self.ctx)
        nxt = logits.argmax(-1)
        done_next = self.done | (nxt == EOS_ID)
        self.tok.copy_(torch.where(self.done, self.eos, nxt))
        self.lbuf.index_copy_(
            1, self.step, torch.where(active, logits,
                                      self.blank_logits)[:, None])
        self.obuf.index_copy_(
            1, self.step, torch.where(active, loc, self.blank_loc)[:, None])
        self.h.copy_(h)
        self.done.copy_(done_next)
        self.step += 1
        self.ran += active.to(torch.int64)

    def capture(self) -> None:
        """Record :data:`CHUNK` steps into a CUDA graph (it runs
        nothing)."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            for _ in range(CHUNK):
                self.run_step()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph


class DecodeGraphs:
    """A head's decode states by (batch, memory shape), each built at its
    key's first decode and kept with the model: a first-seen batch pays
    one eager chunk and a capture (PERF.md §5). A batch is not padded to
    a shared size, since cuBLAS picks its kernels by the batch, and the
    padded rows' products would move the bits away from the eager
    loop's. ``last`` describes the
    last decode: ``steps`` run, graph ``replays``, host ``syncs``."""

    def __init__(self, head: SLADecoder):
        self.head = head
        self.states: Dict[Tuple[int, ...], DecodeState] = {}
        self.last: dict = {}

    @torch.no_grad()
    def decode(self, memory: torch.Tensor):
        """(logits (B, T, vocab), corners (B, T, loc), steps run) of a
        (B, L, C) float32 memory: replays of its key's graph on a CUDA
        tensor, the plain loop on the CPU."""
        if memory.device.type != "cuda":
            out = self.head.decode(memory)
            self.last = {"steps": out[2], "replays": 0, "syncs": out[2]}
            return out
        key = tuple(memory.shape)
        st = self.states.get(key)
        if st is None:
            st = self.states[key] = DecodeState(self.head, memory)
            self._warm_up(st, memory)
            st.start(memory)
            st.capture()
        st.start(memory)
        replays = 0
        for _ in range(st.length // CHUNK):
            st.graph.replay()
            replays += 1
            if bool(st.done.all()):
                break
        steps = min(int(st.ran), self.head.steps)
        self.last = {"steps": steps, "replays": replays,
                     "syncs": replays + 1}
        t = self.head.steps
        return st.lbuf[:, :t].clone(), st.obuf[:, :t].clone(), steps

    @staticmethod
    def _warm_up(st: DecodeState, memory: torch.Tensor) -> None:
        """One chunk of steps eagerly on a side stream."""
        main = torch.cuda.current_stream(memory.device)
        side = torch.cuda.Stream(memory.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            st.start(memory)
            for _ in range(CHUNK):
                st.run_step()
        main.wait_stream(side)

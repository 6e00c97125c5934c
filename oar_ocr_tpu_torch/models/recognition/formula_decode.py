"""The default formula recognizer's decode loop: an eager loop, and the
whole fixed-length loop replayed as one CUDA graph on the card.

Counterpart of the ``nn.scan`` of ``oar_ocr_tpu/models/recognition/
formula.py:141-154``. Its semantics, kept exactly: ``max_len`` steps from
BOS, each step's ``argmax`` fed to the next, every step run (no early
exit), the self-attention cache zero at the start; step ``i`` writes its
k and v at position ``i`` and attends over the whole cache with −1e9
above ``i``; the outputs are each step's id and the max of its float32
softmax.

:func:`decode_eager` is the plain version: a Python loop over
:class:`~.formula.DecodeCell`, the CPU path and the card's reference.
Every position is known before the loop runs, so on the card
:class:`FormulaDecodeGraphs` captures all ``max_len`` steps as ONE CUDA
graph per (batch, memory length) on static buffers: the cross K/V
(layers, B, L, dim), the self-attention K/V (layers, B, max_len, dim),
zeroed inside the graph, and the (B, max_len) ids and probs. A decode
copies its cross K/V in, replays once, and reads nothing back; the
caller fetches ids and probs together (:meth:`FormulaDecodeGraphs.fetch`,
one host sync per decode). The graph runs the eager loop's kernels on the
same shapes, so the two agree bit for bit. The first decode of a key
runs the loop once eagerly on a side stream (it loads cuBLAS's handles,
which a capture cannot) and captures; a failed capture or replay
raises, nothing falls back to the eager loop. A graph is kept per exact
batch: padding the batch changes cuBLAS's kernels and so the bits
(PERF.md §6).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .formula import BOS_ID, DecodeCell


def causal_masks(max_len: int, device) -> torch.Tensor:
    """(max_len, max_len) bool: row ``pos`` is True above ``pos``."""
    t = torch.arange(max_len, device=device)
    return t[None, :] > t[:, None]


def run_steps(cell: DecodeCell, mem_k: torch.Tensor, mem_v: torch.Tensor,
              self_k: torch.Tensor, self_v: torch.Tensor, ids: torch.Tensor,
              probs: torch.Tensor, masks: torch.Tensor,
              feed: Optional[torch.Tensor] = None,
              logits_out: Optional[torch.Tensor] = None) -> None:
    """The loop body, in place on the buffers: the cache zeroed, then
    ``max_len`` steps writing ids and probs. ``feed`` (B, max_len) feeds
    its ids instead of each step's argmax (teacher forcing), and
    ``logits_out`` (B, max_len, vocab) keeps each step's logits."""
    b = mem_k.shape[1]
    self_k.zero_()
    self_v.zero_()
    tok = torch.full((b,), BOS_ID, dtype=torch.int64, device=mem_k.device)
    for pos in range(cell.max_len):
        logits = cell(tok, pos, self_k, self_v, mem_k, mem_v, masks[pos])
        nxt = logits.argmax(-1)
        ids[:, pos] = nxt
        probs[:, pos] = torch.softmax(logits, -1).amax(-1)
        if logits_out is not None:
            logits_out[:, pos] = logits
        tok = nxt if feed is None else feed[:, pos]


def _buffers(cell: DecodeCell, mem_k: torch.Tensor):
    _, b, _, d = mem_k.shape
    dev = mem_k.device
    cache = torch.zeros((cell.layers, b, cell.max_len, d), device=dev)
    return (cache, torch.zeros_like(cache),
            torch.zeros((b, cell.max_len), dtype=torch.int64, device=dev),
            torch.zeros((b, cell.max_len), device=dev))


@torch.no_grad()
def decode_eager(cell: DecodeCell, mem_k: torch.Tensor, mem_v: torch.Tensor,
                 feed: Optional[torch.Tensor] = None,
                 return_logits: bool = False):
    """The plain loop: (ids (B, max_len) int64, probs (B, max_len)
    float32), and the (B, max_len, vocab) step logits when
    ``return_logits``."""
    self_k, self_v, ids, probs = _buffers(cell, mem_k)
    logits = (torch.empty((mem_k.shape[1], cell.max_len,
                           cell.lm_head.out_features), device=mem_k.device)
              if return_logits else None)
    run_steps(cell, mem_k, mem_v, self_k, self_v, ids, probs,
              causal_masks(cell.max_len, mem_k.device), feed, logits)
    return (ids, probs, logits) if return_logits else (ids, probs)


class FormulaDecodeState:
    """The static buffers and the graph of one (batch, memory length)
    key."""

    def __init__(self, cell: DecodeCell, mem_k: torch.Tensor):
        self.cell = cell
        self.mem_k = torch.zeros_like(mem_k)
        self.mem_v = torch.zeros_like(mem_k)
        self.self_k, self.self_v, self.ids, self.probs = _buffers(cell,
                                                                  mem_k)
        self.masks = causal_masks(cell.max_len, mem_k.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_ms: Optional[float] = None

    def run(self) -> None:
        run_steps(self.cell, self.mem_k, self.mem_v, self.self_k,
                  self.self_v, self.ids, self.probs, self.masks)

    def capture(self) -> None:
        """Record the whole loop into a CUDA graph (it runs nothing)."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            self.run()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph


class FormulaDecodeGraphs:
    """A decoder's graphs by (batch, memory length), each captured at its
    key's first decode and kept with the model. ``last`` describes the
    last decode: ``steps`` run, graph ``replays``, host ``syncs`` (the
    one fetch)."""

    def __init__(self, cell: DecodeCell):
        self.cell = cell
        self.states: Dict[Tuple[int, ...], FormulaDecodeState] = {}
        self.last: dict = {}

    @torch.no_grad()
    def decode(self, mem_k: torch.Tensor, mem_v: torch.Tensor):
        """(ids, probs) on the device of the (layers, B, L, dim) cross K/V:
        a replay of the key's graph on a CUDA tensor, the plain loop on
        the CPU. A replay's outputs are the state's buffers, valid until
        the key's next decode."""
        steps = self.cell.max_len
        if mem_k.device.type != "cuda":
            self.last = {"steps": steps, "replays": 0, "syncs": 1}
            return decode_eager(self.cell, mem_k, mem_v)
        key = tuple(mem_k.shape)
        st = self.states.get(key)
        if st is None:
            st = self.states[key] = FormulaDecodeState(self.cell, mem_k)
            self._warm_up(st, mem_k, mem_v)
            st.capture()
        st.mem_k.copy_(mem_k)
        st.mem_v.copy_(mem_v)
        st.graph.replay()
        self.last = {"steps": steps, "replays": 1, "syncs": 1}
        return st.ids, st.probs

    @staticmethod
    def fetch(ids: torch.Tensor, probs: torch.Tensor
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Both outputs to the host with one sync: two non-blocking copies
        into pinned memory, then one event."""
        if ids.device.type != "cuda":
            return ids.numpy(), probs.numpy()
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (ids, probs)]
        for h, t in zip(host, (ids, probs)):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host[0].numpy(), host[1].numpy()

    @staticmethod
    def _warm_up(st: FormulaDecodeState, mem_k, mem_v) -> None:
        """The loop once, eagerly, on a side stream."""
        main = torch.cuda.current_stream(mem_k.device)
        side = torch.cuda.Stream(mem_k.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            st.mem_k.copy_(mem_k)
            st.mem_v.copy_(mem_v)
            st.run()
        main.wait_stream(side)

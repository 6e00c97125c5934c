"""The exact formula models' decode forwards: eager, and replayed as CUDA
graphs on the card.

Counterpart of the jitted ``decode`` of the JAX package's exact formula
recognizers, PP-FormulaNet-S/-L's
(``oar_ocr_tpu/models/recognition/pp_formulanet_exact.py:211-214``) and
UniMERNet's (``oar_ocr_tpu/models/recognition/unimernet.py:370-373``).
Their host loops (the port's ``decode_ids`` of each recognizer) right-pad
each query to a power-of-two length bucket (``unimernet.decode_bucket``),
so JAX compiles one program a bucket, and read the argmax of the read
rows once a forward (``pp_formulanet_exact.py:228-270``,
``unimernet.py:395-424``).

A *forward* takes a crop's cross-attention K/V once (``begin``), then
maps each padded query and its read rows to those rows' argmax ids with
one host read (``forward(query, rows)``). :class:`EagerForward` runs
:func:`forward_body` eagerly: the CPU path, and the card's reference.
:class:`ExactForwardGraphs` keeps one graph per key ``(bucket, rows,
memory length)`` of an ``MBartDecoder`` at batch 1, the batch both
packages decode a crop at, on static buffers:

- the query ids (1, bucket) and the read rows (rows,), int64: one device
  buffer a key, written by one copy a forward from a pinned staging
  buffer;
- each layer's cross-attention (k, v) of ``MBartDecoder.cross_kv`` at the
  memory length, shared by the keys of that length and copied once a
  crop.

The body is :func:`forward_body`: ``MBartDecoder.hidden`` on the static
ids and K/V, the rows gathered on the device, the tied LM head on those
rows alone (not on all ``bucket`` rows: at bucket 128 and vocab 50000
that would be 13 GFLOP a forward), the argmax. The graph runs the eager
forward's kernels on the same shapes, so the two agree bit for bit. The
ids are staged into one pinned host buffer: one host read a forward, as
in JAX. A key's first forward runs eagerly on a side stream and is then
captured (``vl/decode_graph.replay_or_capture``); a failed capture or
replay raises, nothing falls back to the eager forward. The keys of a
recognizer share one memory pool, since each forward's ids are read
before the next replay. With six buckets (8-256) and one memory length a
model (its canvas is fixed), the cache holds at most six keys and never
evicts. Past the last bucket (``decode_bucket`` then returns the exact
length, and JAX compiles one program per length) a forward runs
eagerly: no graph is captured per length. On the CPU the same body runs
on the static buffers, uncaptured.

The encoders stay eager, although JAX jits them: as for every vision
tower and backbone of the port, only the decode loop is graphed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...vl.decode_graph import CapturedGraph, replay_or_capture

# the query length buckets (``pp_formulanet_exact.py:180-186``)
DECODE_BUCKETS = (8, 16, 32, 64, 128, 256)

# each layer's cross-attention (k, v), (1, heads, memory length, head_dim)
CrossKV = List[Tuple[torch.Tensor, torch.Tensor]]


def forward_body(decoder, ids: torch.Tensor, rows: torch.Tensor,
                 cross: CrossKV) -> torch.Tensor:
    """The argmax ids (rows,) of the (1, T) query ``ids`` at ``rows``: the
    decoder on the whole query, the LM head on those rows alone."""
    h = decoder.hidden(ids, cross).index_select(1, rows)
    return decoder.logits(h)[0].argmax(-1)


class EagerForward:
    """:func:`forward_body` on each query as it comes, uploaded."""

    def __init__(self, decoder):
        self.decoder = decoder
        self.cross: Optional[CrossKV] = None

    def begin(self, cross: CrossKV) -> None:
        self.cross = cross

    def __call__(self, query: Sequence[int], rows: Sequence[int]
                 ) -> np.ndarray:
        dev = self.cross[0][0].device
        ids = torch.tensor(np.asarray(query, np.int64)[None], device=dev)
        at = torch.tensor(np.asarray(rows, np.int64), device=dev)
        return forward_body(self.decoder, ids, at, self.cross).cpu().numpy()


class ExactForwardGraphs:
    """A decoder's forward graphs by (bucket, rows, memory length), each
    captured at its key's first forward and kept with the recognizer.
    ``forwards`` counts the forwards run, ``reads`` their host reads and
    ``eager`` those past the last bucket."""

    def __init__(self, decoder):
        self.decoder = decoder
        self.graphs: Dict[tuple, CapturedGraph] = {}
        # key → (the device's ids + rows buffer, its pinned staging)
        self.inputs: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.cross: Dict[int, CrossKV] = {}       # memory length → K/V
        self.host: Dict[int, torch.Tensor] = {}   # rows → pinned ids
        self.pool = None
        self.forwards = self.reads = self.eager = 0
        self._memory: Optional[int] = None
        self._eager = EagerForward(decoder)

    @staticmethod
    def key(query_len: int, rows: int, memory: int) -> Optional[tuple]:
        """The graph key of a forward, None past the last bucket."""
        return ((query_len, rows, memory) if query_len in DECODE_BUCKETS
                else None)

    def begin(self, cross: CrossKV) -> None:
        """A crop's K/V into the static buffers of its memory length."""
        memory = cross[0][0].shape[2]
        static = self.cross.get(memory)
        if static is None:
            static = self.cross[memory] = [
                (torch.empty_like(k), torch.empty_like(v)) for k, v in cross]
        for (sk, sv), (k, v) in zip(static, cross):
            sk.copy_(k)
            sv.copy_(v)
        self._memory = memory
        self._eager.begin(cross)

    def _buffers(self, key: tuple, dev: torch.device):
        if key not in self.inputs:
            n = key[0] + key[1]
            buf = torch.zeros((n,), dtype=torch.int64, device=dev)
            staging = (torch.empty((n,), dtype=torch.int64, pin_memory=True)
                       if dev.type == "cuda" else buf)
            self.inputs[key] = (buf, staging)
        return self.inputs[key]

    def __call__(self, query: Sequence[int], rows: Sequence[int]
                 ) -> np.ndarray:
        self.forwards += 1
        key = self.key(len(query), len(rows), self._memory)
        if key is None:
            self.eager += 1
            self.reads += 1
            return self._eager(query, rows)
        cross = self.cross[self._memory]
        dev = cross[0][0].device
        buf, staging = self._buffers(key, dev)
        staging.numpy()[:] = np.concatenate(
            [np.asarray(query, np.int64), np.asarray(rows, np.int64)])
        bucket = key[0]
        ids, at = buf[:bucket].view(1, bucket), buf[bucket:]

        def body():
            return forward_body(self.decoder, ids, at, cross)

        if dev.type != "cuda":
            self.reads += 1
            return body().numpy()
        buf.copy_(staging, non_blocking=True)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        out = replay_or_capture(self.graphs, key, body, dev, self.pool)
        host = self.host.get(key[1])
        if host is None:
            host = self.host[key[1]] = torch.empty(
                (key[1],), dtype=torch.int64, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        self.reads += 1
        return host.numpy().copy()

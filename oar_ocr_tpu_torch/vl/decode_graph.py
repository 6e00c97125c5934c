"""The greedy decode loop of every VL decoder: one step on static
buffers, replayed as a CUDA graph on the card.

Counterpart of the JAX package's compiled decode loops, ``jax.lax.scan``
of one greedy step under ``jax.jit``, one program per (prompt bucket,
capacity): PaddleOCR-VL's and HunyuanOCR's
(``oar_ocr_tpu/vl/model.py:193-211``, ``oar_ocr_tpu/vl/hunyuan.py:477-490``),
the exact stacks' (``oar_ocr_tpu/vl/exact_models.py:401-445``) and the
families' (``oar_ocr_tpu/vl/families.py:449-486``); and of the
reference's decoder graph, one CUDA graph per power-of-two KV bucket
(``decoder_graph.rs``). Eagerly, a step issues several hundred launches
(HunyuanOCR: 24 layers of about 22), and their host cost, not the device
work, bounds the step; a replayed graph issues them all with one call.

:class:`DecodeState` holds one key's static buffers, for a batch size, a
KV capacity and the decoder's dtype: the fed token, the rotary positions
((axes, B, 1): (3, B, 1) MRoPE, (4, B, 1) XDRoPE; or (B, 1) plain
rope), the cache slot of the token (a 0-d int64 that the KV writes and K4
read on the device), the step counter, ``done``, the (B, C) id output,
the static :class:`KVCache`, the decoder's recurrent states (OvisOCR2's
gated-delta carry: the step writes them in place, so a replay reads what
the last one wrote) and, once captured, the graph with the step's
(B, vocab) logits. :meth:`DecodeState.run_step` is the scan body: the
step's logits, then ``argmax → where(done, eos, ·) → done |= (nxt ==
eos)``, the fed token written into the id output at the step counter,
and the positions, the slot and the cache length advanced, all in place
on the device. Nothing in it reads a Python int that changes from step
to step, so one capture serves every step of every request of its key.

:class:`DecodeGraphs` keeps a model's states and runs the loop. On a
CUDA tensor the first request of a key runs its first
:data:`WARMUP_STEPS` steps eagerly on a side stream (PyTorch's recipe;
they load K3's and K4's modules and the library handles, since a first
load inside a capture fails), captures one step with
``torch.cuda.graph``, and replays it for the rest; later requests of the
key replay from their first step. The host loop is ``replay()`` per
token and one readback per request. ``graph=False`` runs the same step
body eagerly on the card, for comparison; on the CPU it always runs
eagerly, and that is the plain version the tests hold to the JAX scan.
A capture or a replay that fails raises; nothing falls back to the
eager loop.

The launch counts of the kernel wrappers follow what runs: the capture
records K3's and K4's launches into the graph without running them, and
each replay adds them (``ops/cuda_build.CapturedLaunches``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..errors import InvalidInputError
from ..ops.cuda_build import CapturedLaunches
from .kv_cache import KVCache

WARMUP_STEPS = 2

# (tok, positions, cache, slot, *states) → float32 (B, vocab) logits;
# the step advances the cache and writes the states in place
DecodeStep = Callable[..., torch.Tensor]
# (batch, device) → the zero recurrent states of a key
StateFactory = Callable[[int, torch.device], Sequence[torch.Tensor]]


class DecodeState:
    """The static buffers, cache and graph of one (batch, capacity,
    dtype) key."""

    def __init__(self, cache: KVCache, axes: Optional[int], eos_id: int,
                 states: Sequence[torch.Tensor] = ()):
        """``axes`` None gives plain rope's (B, 1) positions."""
        b, dev = cache.k.shape[1], cache.k.device
        self.cache = cache
        self.states = tuple(states)
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.positions = torch.zeros((b, 1) if axes is None
                                     else (axes, b, 1), dtype=torch.int32,
                                     device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.step = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.eos = torch.full((b,), eos_id, dtype=torch.int32, device=dev)
        self.ids = torch.zeros((b, cache.capacity), dtype=torch.int32,
                               device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None   # the graph's output
        self.launches = CapturedLaunches()
        self.capture_ms: Optional[float] = None
        self.first_slot = 0

    def start(self, first: torch.Tensor,
              positions: Union[int, torch.Tensor], slot: int,
              states: Sequence[torch.Tensor] = ()) -> None:
        """Load a request's prefill results: the first token (B,), the
        first decode step's positions (a tensor broadcastable to the
        positions' shape, or one int for all), its cache slot and the
        recurrent states the prefill left, one for each static state."""
        if len(states) != len(self.states):
            raise InvalidInputError("one prefill state per static state",
                                    given=len(states),
                                    static=len(self.states))
        for buf, value in zip(self.states, states):
            buf.copy_(value)
        self.tok.copy_(first)
        if isinstance(positions, torch.Tensor):
            self.positions.copy_(positions)
        else:
            self.positions.fill_(positions)
        self.slot.fill_(slot)
        self.first_slot = slot
        self.step.zero_()
        torch.eq(first, self.eos, out=self.done)

    def run_step(self, decode_step: DecodeStep) -> torch.Tensor:
        """One greedy step in place (the scan body); returns its float32
        (B, vocab) logits."""
        logits = decode_step(self.tok, self.positions, self.cache,
                             self.slot, *self.states)
        self.ids.index_copy_(1, self.step, self.tok[:, None])
        nxt = torch.where(self.done, self.eos,
                          logits.argmax(-1).to(torch.int32))
        self.done |= nxt == self.eos
        self.tok.copy_(nxt)
        self.positions += 1
        self.slot += 1
        self.step += 1
        return logits

    def capture(self, decode_step: DecodeStep) -> None:
        """Record one step into a CUDA graph; the buffers are left as
        they were (a capture runs nothing)."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with self.launches.recording():
            with torch.cuda.graph(graph):
                self.logits = self.run_step(decode_step)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replayed()


class DecodeGraphs:
    """A model's decode states by (batch, capacity, dtype), each built at
    its key's first request and kept with the model, as the JAX jit
    cache keeps its programs."""

    def __init__(self, decode_step: DecodeStep, cfg, axes: Optional[int],
                 states: Optional[StateFactory] = None):
        """``decode_step`` is the network's (tok, positions, cache, slot,
        *states) → logits step; ``cfg`` its config (``layers``,
        ``kv_heads``, ``head_dim``, ``eos_id``); ``axes`` its rotary
        position axes (None: plain rope's (B, 1)); ``states``, when the
        step carries recurrent states, makes a key's static ones."""
        self._decode_step = decode_step
        self._cfg, self._axes = cfg, axes
        self._states = states
        self.states: Dict[Tuple[int, int, torch.dtype], DecodeState] = {}

    def state(self, batch: int, capacity: int, dtype: torch.dtype,
              device: torch.device) -> DecodeState:
        """The key's state (its cache reset by the caller's prefill)."""
        key = (batch, capacity, dtype)
        if key not in self.states:
            c = self._cfg
            self.states[key] = DecodeState(
                KVCache.create(c.layers, batch, c.kv_heads, capacity,
                               c.head_dim, dtype=dtype, device=device),
                self._axes, c.eos_id,
                self._states(batch, device) if self._states else ())
        return self.states[key]

    def decode(self, st: DecodeState, max_new: int, *, graph: bool = True,
               step_logits: Optional[List[torch.Tensor]] = None
               ) -> torch.Tensor:
        """``max_new`` greedy steps from the state :meth:`DecodeState.start`
        loaded; the (B, max_new) int32 ids, on the device. Each step's
        logits are appended to ``step_logits`` when it is a list (a copy
        of the graph's output after a replay)."""
        if st.first_slot + max_new > st.cache.capacity:
            raise InvalidInputError("KV write past the cache capacity",
                                    pos=st.first_slot, tokens=max_new,
                                    capacity=st.cache.capacity)
        replay = graph and st.cache.k.device.type == "cuda"
        i = 0
        if replay and st.graph is None:
            i = min(WARMUP_STEPS, max_new)
            self._warm_up(st, i, step_logits)
            if i < max_new:
                st.capture(self._decode_step)
        for _ in range(i, max_new):
            if replay:
                st.replay()
                if step_logits is not None:
                    step_logits.append(st.logits.clone())
            else:
                logits = st.run_step(self._decode_step)
                if step_logits is not None:
                    step_logits.append(logits)
        return st.ids[:, :max_new].clone()

    def _warm_up(self, st: DecodeState, n: int,
                 step_logits: Optional[List[torch.Tensor]]) -> None:
        """The request's first ``n`` steps, eagerly on a side stream."""
        main = torch.cuda.current_stream(st.cache.k.device)
        side = torch.cuda.Stream(st.cache.k.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(n):
                logits = st.run_step(self._decode_step)
                if step_logits is not None:
                    step_logits.append(logits)
        main.wait_stream(side)

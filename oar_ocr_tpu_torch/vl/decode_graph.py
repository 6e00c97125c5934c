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
read on the device; or, for a key with per-row slots, a (B,) int64 vector,
one slot per row: HPD-Parsing's children forked at their own depths, the
JAX scan's per-row ``wpos``), the step counter, ``done``, the (B, C) id output,
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
eager loop. A tensor-parallel decoder whose ``model`` shards lie on one
device (the CPU, or two shards on one card) captures its step like any
other. One whose shards span several cards captures one graph over all
of them (:func:`forked`): each other card runs its part on a side stream
of its own that waits for the capture's stream and that the capture's
stream waits for at the end, its allocations in a memory pool of its
own kept with the graph, and the all-reduces between the cards (NCCL)
are captured on those streams.

The launch counts of the kernel wrappers follow what runs: the capture
records K3's and K4's launches into the graph without running them, and
each replay adds them (``ops/cuda_build.CapturedLaunches``).

The speculative rounds use the same machinery (:class:`CapturedGraph`,
:func:`warm_up`). Counterpart of the JAX package's jitted rounds, one
program each, whose host reads one accept count a round: HunyuanOCR's
DFlash round (``oar_ocr_tpu/vl/hunyuan.py:635``, one jit per page
bucket), the families' MTP and DFlash rounds
(``oar_ocr_tpu/vl/families.py:489, 584``) and the exact stacks' n-gram
and GLM-MTP rounds (``oar_ocr_tpu/vl/exact_models.py:533, 883``).
:class:`RoundState` holds one round key's static buffers: the bonus
token, the block's first KV slot ``wpos`` (a 0-d int64), each row's
next rotary position ``cpos``, the drafts, the emitted ids and accept
count (staged into one pinned host buffer), the target cache and the
model's own (the draft's paged context, an MTP cache and hidden state,
the delta carry, the n-gram history). A round is two halves, captured
as two graphs and replayed back to back with no host read between them:
the draft half writes ``drafts``, the verify half reads them, so a
forced accept writes ids into ``drafts`` and replays the verify half
alone. Everything a round changes (cache lengths, ``wpos``, ``cpos``,
the history) advances in place on the device. :class:`SpecRounds` keeps
a model's round states and runs them: on the card a key's first round
(and a new page bucket's) runs eagerly on a side stream, then its
halves are captured; later rounds replay. ``graph=False`` runs the same
halves eagerly, and on the CPU they always run eagerly: the plain
version the tests hold to the JAX rounds.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..errors import InvalidInputError
from ..ops.cuda_build import CapturedLaunches
from .kv_cache import KVCache, RowBuffers

WARMUP_STEPS = 2

# (tok, positions, cache, slot, *states) → float32 (B, vocab) logits;
# the step advances the cache and writes the states in place
DecodeStep = Callable[..., torch.Tensor]
# (batch, device) → the zero recurrent states of a key
StateFactory = Callable[[int, torch.device], Sequence[torch.Tensor]]


class CapturedGraph:
    """One body recorded as a CUDA graph: the graph, the body's return
    value (tensors of the graph's pool, rewritten by every replay), the
    kernel launches it holds and the capture's host ms."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pools: list = []
        self.out = None
        self.launches = CapturedLaunches()
        self.capture_ms: Optional[float] = None

    def capture(self, body: Callable[[], object], pool=None,
                sides: Sequence[torch.cuda.Stream] = ()):
        """Record ``body`` into a new graph and keep what it returns; the
        buffers are left as they were (a capture runs nothing). ``pool``
        (``torch.cuda.graph_pool_handle()``) shares one memory pool among
        graphs that always replay in one order on one stream. ``sides``:
        one stream a card other than the current one that ``body`` runs
        on (:func:`forked`); each card's allocations go to a memory pool
        of its own, kept as long as the graph."""
        graph = torch.cuda.CUDAGraph()
        pools = []
        for side in sides:
            with torch.cuda.device(side.device):
                pools.append(torch.cuda.MemPool())
        t0 = time.perf_counter()
        with self.launches.recording():
            with torch.cuda.graph(graph, pool=pool, capture_error_mode=(
                    "relaxed" if sides else "global")):
                with forked(sides, pools):
                    self.out = body()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph
        self.pools = pools
        return self.out

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replayed()


def warm_up(device: torch.device, body: Callable[[], None],
            sides: Sequence[torch.cuda.Stream] = ()) -> None:
    """``body`` eagerly on a side stream, which the current stream then
    waits for: PyTorch's recipe before a capture (a first load of a
    kernel's module or a library handle inside a capture fails). The
    other cards' work runs on ``sides`` (:func:`forked`), the streams
    their part of the capture will run on."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side), forked(sides):
        body()
    main.wait_stream(side)


@contextlib.contextmanager
def forked(sides: Sequence[torch.cuda.Stream], pools: Sequence = ()):
    """The other cards of a multi-card body on ``sides``, one stream a
    card, each current on its card: forked from the current stream (it
    waits for it) and joined back (the current stream waits for each at
    the end), so one capture holds every card's work. With ``pools`` (one
    ``torch.cuda.MemPool`` a side, made on its card) each card's
    allocations go to its pool. The current device stays as it was."""
    if not sides:
        yield
        return
    main = torch.cuda.current_stream()
    with contextlib.ExitStack() as stack:
        here = torch.cuda.current_device()
        for i, side in enumerate(sides):
            side.wait_stream(main)
            if pools:
                stack.enter_context(
                    torch.cuda.use_mem_pool(pools[i], device=side.device))
            stack.enter_context(torch.cuda.stream(side))
        stack.enter_context(torch.cuda.device(here))
        yield
        for side in sides:
            main.wait_stream(side)


def replay_or_capture(graphs: Dict[object, CapturedGraph], key,
                      body: Callable[[], object], device: torch.device,
                      pool=None):
    """``body`` through ``graphs[key]``: when the key has no graph yet,
    its run is eager on a side stream (:func:`warm_up`) and the body is
    then captured into one (in memory pool ``pool``); later runs replay
    it. → the body's return value (the graph's output after a
    replay)."""
    g = graphs.get(key)
    if g is None:
        out = []
        warm_up(device, lambda: out.append(body()))
        graphs[key] = CapturedGraph()
        graphs[key].capture(body, pool)
        return out[0]
    g.replay()
    return g.out


class DecodeState(CapturedGraph):
    """The static buffers, cache and graph of one (batch, capacity,
    dtype) key."""

    def __init__(self, cache: KVCache, axes: Optional[int], eos_id: int,
                 states: Sequence[torch.Tensor] = (), per_row: bool = False):
        """``axes`` None gives plain rope's (B, 1) positions; ``per_row``
        a (B,) slot vector in place of the 0-d slot."""
        super().__init__()
        b, dev = cache.k.shape[1], cache.k.device
        self.cache = cache
        # a stream on every other card the cache spans (a tensor-parallel
        # decoder's shards): their part of the step runs there
        self.sides = ([torch.cuda.Stream(d)
                       for d in getattr(cache, "devices", (dev,)) if d != dev]
                      if dev.type == "cuda" else [])
        self.states = tuple(states)
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.positions = torch.zeros((b, 1) if axes is None
                                     else (axes, b, 1), dtype=torch.int32,
                                     device=dev)
        self.slot = torch.zeros((b,) if per_row else (), dtype=torch.int64,
                                device=dev)
        self.step = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.eos = torch.full((b,), eos_id, dtype=torch.int32, device=dev)
        self.ids = torch.zeros((b, cache.capacity), dtype=torch.int32,
                               device=dev)
        self.first_slot: Optional[int] = 0

    def start(self, first: torch.Tensor,
              positions: Union[int, torch.Tensor],
              slot: Union[int, torch.Tensor],
              states: Optional[Sequence[torch.Tensor]] = ()) -> None:
        """Load a request's prefill results: the first token (B,), the
        first decode step's positions (a tensor broadcastable to the
        positions' shape, or one int for all), its cache slot (an int, or
        a (B,) tensor of per-row slots for a per-row key) and the
        recurrent states the prefill left, one for each static state
        (None: zero states)."""
        if states is None:
            for buf in self.states:
                buf.zero_()
            states = self.states
        if len(states) != len(self.states):
            raise InvalidInputError("one prefill state per static state",
                                    given=len(states),
                                    static=len(self.states))
        for buf, value in zip(self.states, states):
            if buf is not value:
                buf.copy_(value)
        self.tok.copy_(first)
        if isinstance(positions, torch.Tensor):
            self.positions.copy_(positions)
        else:
            self.positions.fill_(positions)
        if self.slot.ndim:
            # per-row slots clamp to [0, C − 1] as the JAX vmap'd write
            # does, so no capacity check applies
            self.slot.copy_(torch.as_tensor(slot).expand(self.slot.shape))
            self.first_slot = None
        else:
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


class DecodeGraphs:
    """A model's decode states by (batch, capacity, dtype), and by
    (batch, capacity, dtype, "rows") for per-row slots, each built at its
    key's first request and kept with the model, as the JAX jit cache
    keeps its programs. The per-row keys (HPD-Parsing's children, one
    key per child count) take their caches from one buffer per capacity
    and dtype (``kv_cache.RowBuffers``)."""

    def __init__(self, decode_step: DecodeStep, cfg, axes: Optional[int],
                 states: Optional[StateFactory] = None,
                 make_cache: Optional[Callable[..., KVCache]] = None):
        """``decode_step`` is the network's (tok, positions, cache, slot,
        *states) → logits step; ``cfg`` its config (``layers``,
        ``kv_heads``, ``head_dim``, ``eos_id``); ``axes`` its rotary
        position axes (None: plain rope's (B, 1)); ``states``, when the
        step carries recurrent states, makes a key's static ones;
        ``make_cache`` (batch, capacity, dtype, device) → a key's cache,
        where it is not one ``KVCache`` (a tensor-parallel decoder's
        ``ShardedKVCache``)."""
        self._decode_step = decode_step
        self._cfg, self._axes = cfg, axes
        self._states = states
        self._make_cache = make_cache
        self.states: Dict[tuple, DecodeState] = {}
        self.rows = RowBuffers(cfg.layers, cfg.kv_heads,
                               cfg.head_dim).join(self)

    def state(self, batch: int, capacity: int, dtype: torch.dtype,
              device: torch.device, per_row: bool = False) -> DecodeState:
        """The key's state (its cache reset by the caller's prefill);
        ``per_row`` keys hold a (B,) slot vector."""
        key = (batch, capacity, dtype) + (("rows",) if per_row else ())
        if key not in self.states:
            c = self._cfg
            if per_row:
                cache = self.rows.cache(batch, capacity, dtype, device)
            elif self._make_cache is not None:
                cache = self._make_cache(batch, capacity, dtype, device)
            else:
                cache = KVCache.create(c.layers, batch, c.kv_heads,
                                       capacity, c.head_dim, dtype=dtype,
                                       device=device)
            self.states[key] = DecodeState(
                cache, self._axes, c.eos_id,
                self._states(batch, device) if self._states else (),
                per_row=per_row)
        return self.states[key]

    def drop_rows(self, capacity: int, dtype: torch.dtype) -> None:
        """Drop the per-row states (their graphs with them) on the
        (capacity, dtype) buffer that ``self.rows`` is replacing."""
        for key in [k for k in self.states
                    if k[1:] == (capacity, dtype, "rows")]:
            del self.states[key]

    def decode(self, st: DecodeState, max_new: int, *, graph: bool = True,
               step_logits: Optional[List[torch.Tensor]] = None
               ) -> torch.Tensor:
        """``max_new`` greedy steps from the state :meth:`DecodeState.start`
        loaded; the (B, max_new) int32 ids, on the device. Each step's
        logits are appended to ``step_logits`` when it is a list (a copy
        of the graph's output after a replay)."""
        if st.first_slot is not None and \
                st.first_slot + max_new > st.cache.capacity:
            raise InvalidInputError("KV write past the cache capacity",
                                    pos=st.first_slot, tokens=max_new,
                                    capacity=st.cache.capacity)
        dev = st.cache.k.device
        replay = graph and dev.type == "cuda"
        i = 0
        if replay and st.graph is None:
            i = min(WARMUP_STEPS, max_new)

            def first_steps():
                for _ in range(i):
                    logits = st.run_step(self._decode_step)
                    if step_logits is not None:
                        step_logits.append(logits)

            warm_up(dev, first_steps, st.sides)
            if i < max_new:
                with torch.cuda.device(dev):
                    st.capture(lambda: st.run_step(self._decode_step),
                               sides=st.sides)
        for _ in range(i, max_new):
            if replay:
                st.replay()
                if step_logits is not None:
                    step_logits.append(st.out.clone())
            else:
                logits = st.run_step(self._decode_step)
                if step_logits is not None:
                    step_logits.append(logits)
        return st.ids[:, :max_new].clone()


# ---------------------------- speculative rounds ----------------------------

class RoundState:
    """The static buffers of one speculative round key: the target cache,
    the model's own round buffers (keyword arguments, kept as attributes:
    ``ctx``, ``h``, ``mtp_cache``, ``dstate``, …) and these:

    - ``tok`` (B,) int32, the bonus token the round starts from;
    - ``wpos``, a 0-d int64: the block's first KV slot (every row's);
    - ``cpos`` (B,) int64: each row's next rotary position;
    - ``drafts`` (B, k) int32, written by the draft half, read by the
      verify half;
    - ``out`` (B, k + 2) int32: the verify's emitted ids (k + 1, −1
      padded) and its accept count, and ``host``, the pinned host buffer
      the one read a round copies them into (``out`` itself on the CPU).

    ``at`` is the host's copy of ``wpos``, which each read advances; the
    model's page bucket follows from it, as the JAX host's ``wpos``
    picks the bucket's jit. Each graph is kept by its half: the draft
    half's by page bucket (``None`` where there is none), the verify
    half's under ``None``. On the card the key's graphs share one memory
    pool, ``pool``: the halves replay back to back on one stream, the
    draft half's temporaries dead before the verify half runs."""

    def __init__(self, cache: KVCache, k: int, **buffers):
        b, dev = cache.k.shape[1], cache.k.device
        self.cache, self.k = cache, k
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.wpos = torch.zeros((), dtype=torch.int64, device=dev)
        self.cpos = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.drafts = torch.zeros((b, k), dtype=torch.int32, device=dev)
        self.out = torch.zeros((b, k + 2), dtype=torch.int32, device=dev)
        self.host = (torch.empty((b, k + 2), dtype=torch.int32,
                                 pin_memory=True)
                     if dev.type == "cuda" else self.out)
        self.at = 0
        self.draft_graphs: Dict[object, CapturedGraph] = {}
        self.verify_graphs: Dict[object, CapturedGraph] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if dev.type == "cuda" else None)
        for name, buf in buffers.items():
            setattr(self, name, buf)

    def begin(self, tok: torch.Tensor, wpos: int,
              cpos: Optional[torch.Tensor] = None) -> None:
        """Load a request's prefill results: the first token (B,), the
        first round's KV slot and, for rotary positions that are not the
        slot's, each row's next position."""
        self.tok.copy_(tok)
        self.wpos.fill_(wpos)
        self.at = wpos
        if cpos is None:
            self.cpos.fill_(wpos)
        else:
            self.cpos.copy_(cpos)

    def commit(self, emitted: torch.Tensor, accepted: torch.Tensor,
               nxt: torch.Tensor) -> None:
        """The verify half's end, in place: the emitted ids and accept
        count staged for the read, the next bonus token, and ``wpos`` and
        ``cpos`` advanced by 1 + row 0's accept count (batch 1, as the
        JAX rounds' ``a[0]``)."""
        self.out[:, :self.k + 1].copy_(emitted)
        self.out[:, self.k + 1].copy_(accepted)
        self.tok.copy_(nxt)
        step = accepted[0].to(torch.int64) + 1
        self.wpos += step
        self.cpos += step

    def read(self) -> Tuple[np.ndarray, int]:
        """The round's one host read: row 0's emitted ids (k + 1) and its
        accept count."""
        if self.host is not self.out:
            self.host.copy_(self.out, non_blocking=True)
            torch.cuda.current_stream(self.out.device).synchronize()
        row = self.host[0].numpy()
        n_acc = int(row[-1])
        self.at += 1 + n_acc
        return row[:-1].copy(), n_acc


# (state, page bucket or None) → None, writing ``state.drafts``
DraftHalf = Callable[[RoundState, object], None]
# state → the verify's float32 (B, k + 1, vocab) logits; ends with commit
VerifyHalf = Callable[[RoundState], torch.Tensor]


class SpecRounds:
    """A model's speculative round states by key, each built at its
    key's first request and kept with the model, and the rounds they
    run: ``draft`` and ``verify`` are the model's two halves."""

    def __init__(self, draft: DraftHalf, verify: VerifyHalf):
        self._draft, self._verify = draft, verify
        self.states: Dict[tuple, RoundState] = {}

    def state(self, key: tuple, make: Callable[[], RoundState]
              ) -> RoundState:
        if key not in self.states:
            self.states[key] = make()
        return self.states[key]

    @torch.inference_mode()
    def run(self, st: RoundState, bucket=None, *, graph: bool = True,
            draft: bool = True,
            logits: Optional[List[torch.Tensor]] = None
            ) -> Tuple[np.ndarray, int]:
        """One round from the state's buffers: the draft half for page
        ``bucket`` (skipped when ``draft`` is False: the verify half then
        takes the drafts already written), the verify half, and the one
        host read → (row 0's emitted ids, its accept count). On a CUDA
        state unless ``graph`` is False, the halves replay their graphs;
        a half without one yet makes this round run eagerly on a side
        stream and is then captured. ``logits``, when a list, receives
        the verify's logits (a copy of the graph's output after a
        replay)."""
        if st.at + st.k + 1 > st.cache.capacity:
            raise InvalidInputError("speculative round past the KV "
                                    "capacity", wpos=st.at, tokens=st.k + 1,
                                    capacity=st.cache.capacity)
        halves = [(st.verify_graphs, None, lambda: self._verify(st))]
        if draft:
            halves.insert(0, (st.draft_graphs, bucket,
                              lambda: self._draft(st, bucket)))
        if graph and st.tok.device.type == "cuda":
            todo = [h for h in halves if h[1] not in h[0]]
            if todo:
                outs = []
                warm_up(st.tok.device,
                        lambda: outs.extend(body() for *_, body in halves))
                verify_logits = outs[-1]
                for graphs, key, body in todo:
                    graphs[key] = CapturedGraph()
                    graphs[key].capture(body, st.pool)
            else:
                for graphs, key, _ in halves:
                    graphs[key].replay()
                verify_logits = st.verify_graphs[None].out
                if logits is not None:
                    verify_logits = verify_logits.clone()
        else:
            verify_logits = [body() for *_, body in halves][-1]
        if logits is not None:
            logits.append(verify_logits)
        return st.read()

    def decode(self, st: RoundState, first: int, max_new: int, eos: int, *,
               bucket: Callable[[RoundState], object] = lambda st: None,
               graph: bool = True, rounds: Optional[List[int]] = None,
               logits: Optional[List[torch.Tensor]] = None) -> List[int]:
        """A request's rounds from the state :meth:`RoundState.begin`
        loaded, until ``max_new`` ids or EOS (the JAX host loops): the
        emitted ids, ``first`` first, EOS included when reached.
        ``bucket`` gives the state's next page bucket (from its ``at``);
        ``rounds``, when a list, receives each round's accept count and
        ``logits`` each round's verify logits."""
        ids = [first]
        while len(ids) < max_new and ids[-1] != eos:
            emitted, n_acc = self.run(st, bucket(st), graph=graph,
                                      logits=logits)
            if rounds is not None:
                rounds.append(n_acc)
            for v in emitted[:n_acc + 1].tolist():
                ids.append(int(v))
                if v == eos or len(ids) >= max_new:
                    break
        return ids

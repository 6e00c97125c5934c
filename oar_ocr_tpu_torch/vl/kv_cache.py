"""Preallocated KV cache and its power-of-two capacity rule.

Counterpart of ``oar_ocr_tpu/vl/kv_cache.py``. The JAX cache is an
immutable pytree whose every operation returns a new cache; this one is
a PyTorch object updated in place (the JAX package gets the same in-place
writes from buffer donation under jit). Each method still returns the
cache, so call sites read as in the JAX package.

Layout: k/v (L, B, Hkv, C, D); ``length`` (B,) int32, the slots written;
``pad`` (B,) int32, the left-padding slots of a left-padded prefill,
which decode masks out.

The position of ``append`` is a Python int (prefill, a verify block: a
fixed slice, bounds-checked on the host), a 0-d int64 tensor on the
cache's device shared by every row (decode: the JAX cache's
``lax.dynamic_update_slice`` at a traced scalar, ``kv_cache.py:68-86``,
as an ``index_copy_`` along the slot axis whose start is clamped to
[0, C − T] as there), so a captured decode step writes the slot the
graph has advanced to at every replay, or a (B,) integer vector, one
slot per row, each clamped alike (the JAX ``vmap`` of that write,
``:85-93``: forked branches at their own depths). ``k_slot`` takes all
three: K4 writes k at the int's slots through a view, and at a device
slot or at per-row slots into the layer's whole cache, reading the slots
on the device.

The rollback and fork methods follow ``kv_cache.py:97-143``:
``trim_to`` and ``with_lengths`` set ``length`` in place, from a host
value or a device tensor, with no host read; ``copy_row`` copies one
row's K/V, length and pad onto another in place; ``keep_indices``
changes the batch, so it returns a new cache, as the JAX one does; and
``pad_into`` is JAX's ``pad_batch`` into a larger cache's own buffers (a
static key's, ``vl/hpd_scheduler.py``).

:class:`ShardedKVCache` is the cache of a tensor-parallel decoder
(``parallel/tp.py``): one :class:`KVCache` a ``model`` shard, on the
shard's device, holding the kv heads that shard's q heads read (each of
a kv head shared by the shards' q heads). The JAX cache inherits a
head-sharded layout from the sharded k/v projections; the port keeps the
shards explicit. Lengths and pads are shard 0's, shared by every shard:
the attention reads its slots from the mask the caller builds from them.

:class:`RowBuffers` holds the static caches of keys that differ only in
their row count (HPD's slot pools, HPD-Parsing's children) as views of
the leading rows of one buffer per capacity and dtype, so they hold as
many rows as their largest key, not the sum of all keys' rows.

A cache may be reused request after request (``vl/decode_graph.py``
keeps one per batch and capacity): ``reset`` sets ``length`` and ``pad``
in place. The slots past ``length`` then still hold the previous
request's K/V. Decode masks them to ``finfo.min``, so their softmax
weights are exactly 0, which keeps them out of the result as long as
they are finite (0·NaN is NaN): the cache starts zeroed and only finite
K/V are ever written into it.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..errors import InvalidInputError
from ..ops.fused_norm_rope import row_slot_indices, slot_indices

KV_CAPACITY_MIN, KV_CAPACITY_MAX = 256, 16384


def set_lengths(length: torch.Tensor, new_length) -> None:
    """``length`` (B,) ← ``new_length``, an int or a tensor broadcast to
    (B,), in place."""
    if isinstance(new_length, torch.Tensor):
        length.copy_(new_length.to(length.dtype).expand_as(length))
    else:
        length.fill_(new_length)


def decoder_cache_capacity(prompt_len: int, max_new_tokens: int,
                           cap: int = KV_CAPACITY_MAX) -> int:
    """next-power-of-two(prompt + max_new) from 256, capped at ``cap``
    (``kv_cache.py:28-36``)."""
    need = prompt_len + max_new_tokens
    c = KV_CAPACITY_MIN
    while c < need and c < cap:
        c *= 2
    return min(c, cap)


class KVCache:
    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, pad: torch.Tensor):
        self.k, self.v, self.length, self.pad = k, v, length, pad

    @classmethod
    def create(cls, layers: int, batch: int, heads: int, capacity: int,
               head_dim: int, *, dtype: torch.dtype,
               device: torch.device) -> "KVCache":
        shape = (layers, batch, heads, capacity, head_dim)
        zeros = torch.zeros((batch,), dtype=torch.int32, device=device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   zeros, zeros.clone())

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    def with_pad(self, pad_lens: torch.Tensor) -> "KVCache":
        """Record each row's left-pad slot count (once, after prefill),
        in place, so a captured step that reads ``pad`` sees it."""
        self.pad.copy_(pad_lens)
        return self

    def reset(self, pad_lens: Optional[torch.Tensor] = None) -> "KVCache":
        """Make the cache empty for the next request: ``length`` 0 and
        ``pad`` the new rows' pad counts (0 without them), in place."""
        self.length.zero_()
        if pad_lens is None:
            self.pad.zero_()
        else:
            self.with_pad(pad_lens)
        return self

    def append(self, layer: int, k_new: Optional[torch.Tensor],
               v_new: torch.Tensor, pos: Union[int, torch.Tensor]
               ) -> "KVCache":
        """Write (B, Hkv, T_new, D) at slot ``pos`` of layer ``layer``
        (an int, a 0-d device slot or a (B,) vector of per-row slots).
        ``k_new`` None writes v alone: a kernel has already written k
        through :meth:`k_slot`. ``length`` moves separately, by
        :meth:`advance`."""
        t = v_new.shape[2]
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            idx = self._row_indices(pos, t)            # (B, T)
            for buf, new in ((self.k, k_new), (self.v, v_new)):
                if new is not None:
                    at = idx[:, None, :, None].expand(new.shape)
                    buf[layer].scatter_(2, at, new.to(buf.dtype))
            return self
        if isinstance(pos, torch.Tensor):
            self._check_device_pos(pos, t)
            idx = slot_indices(pos, t, self.capacity)
            if k_new is not None:
                self.k[layer].index_copy_(2, idx, k_new.to(self.k.dtype))
            self.v[layer].index_copy_(2, idx, v_new.to(self.v.dtype))
            return self
        if k_new is not None:
            self.k_slot(layer, pos, t).copy_(k_new)
        self.v[layer, :, :, self._span(pos, t)] = v_new
        return self

    def k_slot(self, layer: int, pos: Union[int, torch.Tensor],
               t: int) -> torch.Tensor:
        """Where a kernel writes layer ``layer``'s k for slots
        [pos, pos + t): for an int ``pos`` the (B, Hkv, t, D) view of
        those slots; for a device-scalar ``pos`` the layer's whole
        (B, Hkv, C, D) k, which the kernel, given ``pos`` as its slot,
        writes from there on (``fused_qk_norm_rope_qk``); for a (B,)
        vector of per-row slots the same whole layer, which the kernel
        writes from each row's own slot on, clamped as :meth:`append`
        clamps them."""
        if isinstance(pos, torch.Tensor):
            if pos.ndim == 1:
                self._row_indices(pos, t)              # validates
                return self.k[layer]
            self._check_device_pos(pos, t)
            return self.k[layer]
        return self.k[layer, :, :, self._span(pos, t)]

    def _row_indices(self, pos: torch.Tensor, t: int) -> torch.Tensor:
        """(B, t) int64 slots [p_b, p_b + t) per row, each start clamped
        to [0, C − t] as ``lax.dynamic_update_slice`` clamps."""
        b = self.k.shape[1]
        if tuple(pos.shape) != (b,) or pos.is_floating_point() \
                or t > self.capacity:
            raise InvalidInputError("per-row KV positions are a (B,) "
                                    "integer vector, for at most capacity "
                                    "tokens", shape=tuple(pos.shape),
                                    dtype=str(pos.dtype), batch=b, tokens=t,
                                    capacity=self.capacity)
        return row_slot_indices(pos.to(self.k.device), t, self.capacity)

    def _check_device_pos(self, pos: torch.Tensor, t: int) -> None:
        if pos.ndim != 0 or pos.dtype != torch.int64 \
                or pos.device != self.k.device or t > self.capacity:
            raise InvalidInputError("a device KV position is a 0-d int64 "
                                    "tensor on the cache's device, for at "
                                    "most capacity tokens",
                                    shape=tuple(pos.shape),
                                    dtype=str(pos.dtype),
                                    device=str(pos.device), tokens=t,
                                    capacity=self.capacity)

    def _span(self, pos: int, t: int) -> slice:
        if pos < 0 or pos + t > self.capacity:
            raise InvalidInputError("KV write past the cache capacity",
                                    pos=pos, tokens=t,
                                    capacity=self.capacity)
        return slice(pos, pos + t)

    def advance(self, n: int) -> "KVCache":
        self.length += n
        return self

    def layer(self, i: int):
        return self.k[i], self.v[i]

    def trim_to(self, new_length) -> "KVCache":
        """Speculative rollback (``kv_cache.py:97-103``): every row's
        length becomes ``new_length`` (an int, or a tensor broadcast to
        (B,): a device length is copied on the device, so a captured
        round trims without a host read); the slots past it are masked
        out, never cleared."""
        set_lengths(self.length, new_length)
        return self

    def with_lengths(self, lengths) -> "KVCache":
        """Per-row lengths (``:105-108``): each branch at its own depth.
        ``lengths`` is a (B,) tensor, copied in place on its device (a
        captured round sets them without a host read), or host values."""
        if not isinstance(lengths, torch.Tensor):
            lengths = torch.as_tensor(lengths, dtype=torch.int32)
        set_lengths(self.length, lengths)
        return self

    def copy_row(self, src: int, dst: int, new_length) -> "KVCache":
        """Row ``src``'s K/V and pad onto row ``dst``, whose length becomes
        ``new_length``, an int or a device scalar (``:110-122``, the
        branch-fork primitive), all in place."""
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]
        set_lengths(self.length[dst:dst + 1], new_length)
        self.pad[dst] = self.pad[src]
        return self

    def rows(self, b: int) -> "KVCache":
        """A cache of the leading ``b`` rows, sharing this one's buffers
        (each layer's rows stay contiguous)."""
        return KVCache(self.k[:, :b], self.v[:, :b], self.length[:b],
                       self.pad[:b])

    def pad_into(self, dst: "KVCache") -> "KVCache":
        """JAX's ``pad_batch`` (``:124-136``) into ``dst``'s own buffers,
        in place: these rows first, in their order, then zero-filled,
        zero-length ones (``dst`` has as many rows or more, and the same
        layers, heads, capacity and head size) → ``dst``. Rows that
        already are ``dst``'s leading rows (:meth:`rows` of it, or of
        the buffer both view) are not copied."""
        b = self.k.shape[1]
        if dst.k.shape[1] < b or dst.k.shape[:1] + dst.k.shape[2:] != \
                self.k.shape[:1] + self.k.shape[2:]:
            raise InvalidInputError("pad_into takes a cache of as many rows "
                                    "or more and the same layout",
                                    src=tuple(self.k.shape),
                                    dst=tuple(dst.k.shape))
        for buf, rows in ((dst.k, self.k), (dst.v, self.v),
                          (dst.length, self.length), (dst.pad, self.pad)):
            dim = 1 if buf.ndim > 1 else 0             # the row axis
            lead = buf.narrow(dim, 0, b)
            if (lead.data_ptr(), lead.stride()) != (rows.data_ptr(),
                                                    rows.stride()):
                lead.copy_(rows)
            buf.narrow(dim, b, buf.shape[dim] - b).zero_()
        return dst

    def keep_indices(self, indices) -> "KVCache":
        """A new cache of the rows ``indices``, in that order (``:138-143``,
        branch reordering; an index may repeat)."""
        idx = torch.as_tensor(indices, dtype=torch.int64,
                              device=self.k.device)
        return KVCache(self.k[:, idx], self.v[:, idx], self.length[idx],
                       self.pad[idx])


class ShardedKVCache(KVCache):
    """One cache a ``model`` shard (``shards``); as a :class:`KVCache` it
    is shard 0's, whose ``length`` and ``pad`` every shard shares, so
    ``reset``, ``advance`` and the masks act on all of them."""

    def __init__(self, shards):
        first = shards[0]
        super().__init__(first.k, first.v, first.length, first.pad)
        self.shards = [KVCache(c.k, c.v, first.length, first.pad)
                       for c in shards]

    @classmethod
    def create_sharded(cls, layers: int, batch: int, heads, capacity: int,
                       head_dim: int, *, dtype: torch.dtype,
                       devices) -> "ShardedKVCache":
        """``heads[s]`` kv heads on ``devices[s]`` for every shard."""
        return cls([KVCache.create(layers, batch, h, capacity, head_dim,
                                   dtype=dtype, device=d)
                    for h, d in zip(heads, devices)])

    @property
    def devices(self) -> List[torch.device]:
        """The distinct devices of the shards, shard 0's first."""
        return list(dict.fromkeys(c.k.device for c in self.shards))


class RowBuffers:
    """One KV buffer per (capacity, dtype) whose leading rows are the
    static caches of every key of that capacity and dtype, whatever its
    row count: HPD's slot pools (``vl/hpd_scheduler.py``) and
    HPD-Parsing's per-row children keys (``vl/decode_graph.py``). Those
    keys run one at a time, so they may share rows: the buffer holds as
    many rows as the largest key, where one cache per key held their
    sum. A key of more rows than the buffer replaces it by one of its
    size; every owner (``join``) then drops its keys on the old buffer
    (``drop_rows(capacity, dtype)``), since their graphs hold its
    addresses, and the old buffer is freed once the caller has copied
    out of it."""

    def __init__(self, layers: int, heads: int, head_dim: int):
        self._dims = (layers, heads, head_dim)
        self.buffers: Dict[Tuple[int, torch.dtype], KVCache] = {}
        self._owners: "weakref.WeakSet" = weakref.WeakSet()

    def join(self, owner) -> "RowBuffers":
        """Register ``owner`` (held weakly), whose ``drop_rows`` is called
        when a buffer it may view is replaced."""
        self._owners.add(owner)
        return self

    def cache(self, rows: int, capacity: int, dtype: torch.dtype,
              device: torch.device) -> KVCache:
        """The leading ``rows`` rows of the (capacity, dtype) buffer."""
        key = (capacity, dtype)
        buf = self.buffers.get(key)
        if buf is None or buf.k.shape[1] < rows:
            for owner in list(self._owners):
                owner.drop_rows(capacity, dtype)
            layers, heads, head_dim = self._dims
            buf = self.buffers[key] = KVCache.create(
                layers, rows, heads, capacity, head_dim, dtype=dtype,
                device=device)
        return buf.rows(rows)

    def nbytes(self) -> int:
        """The K/V bytes the buffers hold."""
        return sum(b.k.nbytes + b.v.nbytes for b in self.buffers.values())

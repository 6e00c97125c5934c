"""Preallocated KV cache and its power-of-two capacity rule.

Counterpart of ``oar_ocr_tpu/vl/kv_cache.py``. The JAX cache is an
immutable pytree whose every operation returns a new cache; this one is
a PyTorch object updated in place (the JAX package gets the same in-place
writes from buffer donation under jit). Each method still returns the
cache, so call sites read as in the JAX package.

Layout: k/v (L, B, Hkv, C, D); ``length`` (B,) int32, the slots written;
``pad`` (B,) int32, the left-padding slots of a left-padded prefill,
which decode masks out.

Ported are the methods of the greedy generate path: ``append`` at a
scalar position, ``k_slot`` (the view a kernel writes k into),
``advance``, ``with_pad``, ``layer``. ``trim_to``,
``copy_row``, ``keep_indices`` and a per-row position vector serve the
speculative and continuous-batching paths, which are not ported yet, and
raise ``UnsupportedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import InvalidInputError, UnsupportedError

KV_CAPACITY_MIN, KV_CAPACITY_MAX = 256, 16384


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
        """Record each row's left-pad slot count (once, after prefill)."""
        self.pad = pad_lens.to(device=self.k.device, dtype=torch.int32)
        return self

    def append(self, layer: int, k_new: Optional[torch.Tensor],
               v_new: torch.Tensor, pos: int) -> "KVCache":
        """Write (B, Hkv, T_new, D) at slot ``pos`` of layer ``layer``.
        ``k_new`` None writes v alone: a kernel has already written k
        through :meth:`k_slot`. ``length`` moves separately, by
        :meth:`advance`."""
        t = v_new.shape[2]
        if k_new is not None:
            self.k_slot(layer, pos, t).copy_(k_new)
        self.v[layer, :, :, self._span(pos, t)] = v_new
        return self

    def k_slot(self, layer: int, pos: int, t: int) -> torch.Tensor:
        """The (B, Hkv, t, D) view of layer ``layer``'s k at slots
        [pos, pos + t), for a kernel that writes k in place."""
        return self.k[layer, :, :, self._span(pos, t)]

    def _span(self, pos: int, t: int) -> slice:
        if isinstance(pos, torch.Tensor):
            raise UnsupportedError("per-row KV positions belong to the "
                                   "continuous-batching path, not ported")
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
        raise UnsupportedError("KVCache.trim_to serves speculative "
                               "decoding, not ported yet")

    def copy_row(self, src: int, dst: int, new_length) -> "KVCache":
        raise UnsupportedError("KVCache.copy_row serves branch forks, "
                               "not ported yet")

    def keep_indices(self, indices) -> "KVCache":
        raise UnsupportedError("KVCache.keep_indices serves branch "
                               "reordering, not ported yet")

"""Paged KV cache: a page pool per sequence, appended a block at a time.

Counterpart of ``oar_ocr_tpu/vl/paged_kv.py``. The DFlash draft keeps
its context K/V here: storage is ``num_pages`` pages of ``page_size``
rows per sequence, laid out in order (pages are private to a sequence),
``append`` writes only the rows of the block (at an int start, or at a
0-d device start that a captured round reads on the device), and
``view(n_pages)`` gives the contiguous K/V of the first ``n_pages``
pages, so the draft's attention reads pages in use, not the whole pool.
``page_bucket`` rounds a host-known length up to a power-of-two page
count, as in the JAX package, where it bounds the number of compiled
programs; here it bounds the distinct attention shapes and the draft
half's captured graphs. The JAX host sizes each request's pool to its
rows (prompt + max_new + block), which caps that bucket; here the pool
is sized once per round key, and ``reset(rows)`` keeps the request's cap
in ``page_cap``, which :meth:`PagedKVCache.bucket` applies.

The JAX cache is an immutable pytree; this one is updated in place, and
each method returns the cache, as ``vl/kv_cache.KVCache`` does.

Layout: k/v (L, B, n_pages, page_size, Hkv, D); ``length`` (B,) int32;
``pad`` (B,) int32, the left-padding rows readers mask out.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..errors import InvalidInputError
from ..ops.fused_norm_rope import slot_indices
from .kv_cache import set_lengths


class PagedKVCache:
    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, pad: torch.Tensor):
        self.k, self.v, self.length, self.pad = k, v, length, pad
        self.page_cap = self.num_pages

    @classmethod
    def create(cls, layers: int, batch: int, heads: int, num_pages: int,
               page_size: int, head_dim: int, *, dtype: torch.dtype,
               device: torch.device) -> "PagedKVCache":
        shape = (layers, batch, num_pages, page_size, heads, head_dim)
        zeros = torch.zeros((batch,), dtype=torch.int32, device=device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   zeros, zeros.clone())

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[2]

    @property
    def capacity(self) -> int:
        return self.num_pages * self.page_size

    def pages_used(self) -> torch.Tensor:
        """(B,) number of pages holding live rows."""
        ps = self.page_size
        return (self.length + ps - 1) // ps

    def reset(self, rows: Optional[int] = None) -> "PagedKVCache":
        """Make the pool empty for the next request (``length`` and
        ``pad`` 0, in place; the rows stay, masked out), whose page
        buckets are capped at the pages its ``rows`` fill, the JAX host's
        pool (``hunyuan.py:723-724``); all the pages when ``rows`` is
        None."""
        self.length.zero_()
        self.pad.zero_()
        pages = self.num_pages if rows is None else -(-rows // self.page_size)
        self.page_cap = min(self.num_pages, max(1, pages))
        return self

    def bucket(self, length: int) -> int:
        """The page bucket of a host-known ``length``, capped at the
        request's pool."""
        return page_bucket(length, self.page_size, self.page_cap)

    def append(self, layer: int, k: torch.Tensor, v: torch.Tensor,
               start: Union[int, torch.Tensor]) -> "PagedKVCache":
        """Write (B, Hkv, T, D) rows at [start, start + T) of every row
        (``paged_kv.py:67-91``). ``start`` is an int or a 0-d integer
        tensor on the pool's device (a captured round's slot, read on
        the device); either is clamped to [0, C − T], as
        ``lax.dynamic_update_slice`` clamps."""
        L, B, P, S, H, D = self.k.shape
        t = k.shape[2]
        if t > P * S:
            raise InvalidInputError("paged KV write larger than the pool",
                                    tokens=t, capacity=P * S)
        idx = None
        if isinstance(start, torch.Tensor):
            if start.ndim != 0 or start.is_floating_point() \
                    or start.device != self.k.device:
                raise InvalidInputError(
                    "a device paged-KV start is a 0-d integer tensor on "
                    "the pool's device", shape=tuple(start.shape),
                    dtype=str(start.dtype), device=str(start.device))
            idx = slot_indices(start.to(torch.int64), t, P * S)
        else:
            s = min(max(start, 0), P * S - t)
        for buf, new in ((self.k, k), (self.v, v)):
            flat = buf[layer].view(B, P * S, H, D)
            rows = new.transpose(1, 2).to(buf.dtype)
            if idx is None:
                flat[:, s:s + t] = rows
            else:
                flat.index_copy_(1, idx, rows)
        return self

    def advance(self, n: int) -> "PagedKVCache":
        self.length += n
        return self

    def trim_to(self, new_length) -> "PagedKVCache":
        """Speculative rollback: every row's length becomes
        ``new_length`` (an int, or a tensor copied on the device); pages
        are never freed."""
        set_lengths(self.length, new_length)
        return self

    def view(self, n_pages: int, layer: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, Hkv, n_pages·S, D) K/V over the first ``n_pages`` pages."""
        L, B, P, S, H, D = self.k.shape
        k = self.k[layer, :, :n_pages].reshape(B, n_pages * S, H, D)
        v = self.v[layer, :, :n_pages].reshape(B, n_pages * S, H, D)
        return k.transpose(1, 2), v.transpose(1, 2)


def page_bucket(length: int, page_size: int, num_pages: int) -> int:
    """Page count for a host-known length: the next power of two pages,
    at most ``num_pages`` (``paged_kv.py:116-125``)."""
    need = max(1, -(-length // page_size))
    b = 1
    while b < need:
        b *= 2
    return min(b, num_pages)

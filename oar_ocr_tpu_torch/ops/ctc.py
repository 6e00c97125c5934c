"""Greedy CTC decode on the device and the host dictionary decoder.

Counterpart of ``oar_ocr_tpu/ops/ctc.py``. Parity-critical semantics, as
there: last-max-wins argmax (``torch.argmax`` returns the FIRST max, so
the vocab axis is flipped, ``ctc.py:123-127``); keep a timestep iff its
index is not blank (0) and differs from the previous RAW timestep index
(dedup before blank filtering, ``ctc.py:152-154``); confidence is the
mean of the kept probabilities.

:func:`pack_ctc_raw` folds each timestep into 6 bytes — int16 index
where kept else −1, then the float32 probability, little-endian
(``ctc.py:42-56``) — so the host fetches one small array per chunk. The
host side (:func:`unpack_ctc_raw`, :class:`CTCLabelDecoder`) is a
jax-free copy of the JAX package's.
"""

from __future__ import annotations

import functools
import re
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..errors import InvalidInputError


class CTCRaw(NamedTuple):
    indices: torch.Tensor   # (B, T) int32 argmax (last-max-wins)
    probs: torch.Tensor     # (B, T) float32 probability of the argmax
    keep: torch.Tensor      # (B, T) bool: contributes a character


def argmax_last(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n = x.shape[dim]
    return (n - 1) - torch.argmax(torch.flip(x, (dim,)), dim=dim)


def ctc_greedy_decode(probs: torch.Tensor, *, blank: int = 0) -> CTCRaw:
    """Greedy CTC decode of (B, T, V) probabilities on their device."""
    b = probs.shape[0]
    idx = argmax_last(probs, -1)
    p = torch.gather(probs, -1, idx[..., None])[..., 0]
    prev = torch.cat([torch.full((b, 1), -1, dtype=idx.dtype,
                                 device=idx.device), idx[:, :-1]], dim=1)
    keep = (idx != blank) & (idx != prev)
    return CTCRaw(idx.to(torch.int32), p.to(torch.float32), keep)


def pack_ctc_raw(raw: CTCRaw) -> torch.Tensor:
    """(indices, probs, keep) → one (B, T, 6) uint8 array: bytes 0-1 the
    int16 index where kept else −1, bytes 2-5 the float32 probability."""
    idx = torch.where(raw.keep, raw.indices, -1).to(torch.int16)
    ib = idx.contiguous()[..., None].view(torch.uint8)        # (B, T, 2)
    pb = raw.probs.to(torch.float32).contiguous()[..., None].view(
        torch.uint8)                                          # (B, T, 4)
    return torch.cat([ib, pb], dim=-1)


def unpack_ctc_raw(packed: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host inverse of pack_ctc_raw → (indices, probs, keep)."""
    flat = np.ascontiguousarray(packed, np.uint8).reshape(-1, 6)
    idx16 = flat[:, :2].copy().view("<i2")[:, 0]
    prob = flat[:, 2:].copy().view("<f4")[:, 0]
    shape = packed.shape[:-1]
    keep = (idx16 >= 0).reshape(shape)
    idx = np.where(idx16 >= 0, idx16, 0).astype(np.int32).reshape(shape)
    return idx, prob.reshape(shape), keep


class CTCLabelDecoder:
    """Host dictionary mapping: vocab = [blank] + charset (+ ' '), blank
    index 0 (``ctc.py:161-212``). ``reverse``: reverse the run order of
    each decoded text (:func:`pred_reverse`, for RTL scripts)."""

    def __init__(self, charset: Sequence[str], *, use_space_char: bool = True,
                 reverse: bool = False):
        chars = list(charset)
        if use_space_char:
            chars.append(" ")
        self.charset: List[str] = chars
        self.vocab_size = 1 + len(chars)
        if self.vocab_size > 32767:       # pack_ctc_raw int16 domain
            raise InvalidInputError(
                "charset too large for the int16 CTC transfer packing",
                vocab_size=self.vocab_size)
        self.reverse = reverse

    def __call__(self, raw) -> List[Tuple[str, float]]:
        return [r[:2] for r in self.decode_with_positions(raw)]

    def decode_with_positions(self, raw) -> List[Tuple[str, float, List[int]]]:
        """(text, confidence, kept column indices) per row."""
        idx, prob, keep = (np.asarray(a) for a in raw)
        out: List[Tuple[str, float, List[int]]] = []
        for bi in range(idx.shape[0]):
            cols = np.nonzero(keep[bi])[0]
            chars = []
            for c in cols:
                ci = int(idx[bi, c]) - 1          # shift past blank
                chars.append(self.charset[ci]
                             if 0 <= ci < len(self.charset) else "")
            text = "".join(chars)
            if self.reverse:
                text = pred_reverse(text)
            conf = float(prob[bi, cols].mean()) if cols.size else 0.0
            out.append((text, conf, cols.tolist()))
        return out


_LATIN_RUN = re.compile(r"[a-zA-Z0-9 :*\./%+-]+")


def pred_reverse(text: str) -> str:
    """RTL reversal (``ctc.py:220-237``): alphanumeric runs stay as they
    are, every other character is a run of its own, and the run order is
    reversed."""
    if not text:
        return text
    runs: List[str] = []
    pos = 0
    for m in _LATIN_RUN.finditer(text):
        runs.extend(text[pos:m.start()])
        runs.append(m.group(0))
        pos = m.end()
    runs.extend(text[pos:])
    return "".join(reversed(runs))


def load_charset(path: str) -> List[str]:
    """A PP-OCR dictionary file, one character per line (``ctc.py:
    240-244``): only ``"\\n"`` is stripped and empty lines are skipped, so a
    ``"\\r"`` or a space in a line survives."""
    with open(path, "r", encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n") != ""]


@functools.lru_cache(maxsize=1)
def default_charset() -> Tuple[str, ...]:
    """Printable-ASCII fallback charset (development and tests)."""
    return tuple(chr(c) for c in range(33, 127))

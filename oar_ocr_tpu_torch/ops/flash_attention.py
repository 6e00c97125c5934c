"""Blockwise (flash) attention: the K2 kernel and its plain version.

Counterpart of ``oar_ocr_tpu/ops/flash_attention.py``. The CUDA kernels
(``csrc/flash_attention.cu``) replace the Pallas ``_flash_kernel`` and
compute softmax(q·kᵀ/√D + mask)·v over (B, H, T, D) tensors (H = the kv
heads after any GQA repeat) with the online-softmax recurrence, so the
(Tq, Tk) score matrix never exists in device memory. The mask is
``key < valid_len[b]`` and, when ``causal``, ``key <= query``; a row
whose keys are all masked outputs exactly 0.

- **bfloat16** runs on the tensor cores (``flash_wgmma_kernel``): wgmma
  for q·kᵀ and for P·v, K and V streamed by TMA, softmax in registers.
  Its bound is operations — 4·T²·D per head at 989 TFLOP/s — and, at
  D = 72, the T² exponentials nearly as much; the exponentials of one key
  block run while the tensor cores do P·v of the block before. P is
  rounded to bfloat16 for P·v, as the JAX fallback rounds its weights to
  ``v.dtype``.
- **float32** runs float32 FMAs (``flash_fma_kernel``), bound by
  operations at 67 TFLOP/s; kept off the tensor cores on purpose, since
  TF32 would round q, k and v to 10 bits. Each thread holds a register
  tile of scores (several query rows × several keys) fed by 128-bit
  shared-memory loads, P goes through shared memory for P·v, K and V
  stream through a ``cp.async`` ring, the softmax runs in registers with
  exp2 and shuffles, and causal grids launch their longest query tiles
  first. A key block that straddles valid_len scores and sums only the
  keys below it.

**The float32 launch rule** (:func:`fma_grid`, a pure function of the
shape, the causal flag, whether valid_len is given and the SM count):
the tiles grid launches a CTA per (b, h, query tile), which runs in
``ceil(CTAs / slots)`` waves of the SMs × CTAs-per-SM slots. Where that
leaves the last wave part empty — HPD's InternViT tiles, 16 heads × 17
tiles of 1025 rows, overshoot the H100's 264 slots by 8 at every image
count — D = 64 runs the stream grid instead, on its own instance of
32-key blocks that fits three CTAs an SM (396 slots): one CTA a slot,
each taking an equal run of the (b·h, tile, key block) units, a tile cut
between CTAs merged from the pieces (m, l, unnormalized O) each leaves
in a workspace the wrapper allocates. The rule takes the stream grid
only when an SM is predicted to compute fewer (query, key) pairs, and
never with valid_len (the work per head is then on the card) or causal
masks. The same shape always gets the same grid, so the same bits.
D = 72 and 80 have the tiles grid alone: MinerU's 448×448 crop,
(1, 16, 1024, 80) unmasked, fills 0.97 of a wave, and its 32-key,
three-CTA tiling ran slower there on either grid (H100).

Both read q, k and v through their (batch, head, token) strides — the
towers pass transposed (B, T, H, D) projections — and write the output in
(B, T, H, D) memory, returned as the (B, H, T, D) view, so neither side
of the call copies. :func:`kernel_strides` computes the strides the
kernel is passed and refuses a layout the kernels cannot read: TMA's
16-byte rule for bfloat16, and the same for the 16-byte ``cp.async``
copies and vector loads of float32.

A tensor on the CPU takes :func:`flash_attention_ref`, the JAX module's
XLA fallback (``flash_attention.py:118-134``): −1e30 masking, a float32
softmax, fully-masked rows zeroed, weights cast to ``v.dtype`` before PV.
A CUDA tensor launches a kernel at every length, and a failed build or
launch raises. ``KERNEL.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..errors import InvalidInputError, UnsupportedError
from .cuda_build import CudaKernel

_NEG_INF = -1e30
_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# the template instances in the source, by dtype: float32 also has D = 80
# (MinerU's float32 tower), bfloat16 not (no bfloat16 caller runs it)
KERNEL_HEAD_DIMS = (64, 72, 80, 128)
_HEAD_DIMS = {torch.float32: KERNEL_HEAD_DIMS,
              torch.bfloat16: (64, 72, 128)}
_ALIGN = 16                    # byte strides and base addresses (TMA, cp.async)

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "oar_flash_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
    replaces="oar_ocr_tpu/ops/flash_attention.py:33")


class FmaTiling(NamedTuple):
    """A float32 instance of ``flash_fma_kernel`` as the source declares it
    (``oar_flash_fma_info`` reports the same numbers; chip_smoke's phase 2
    holds the two equal): query rows a tile, keys a block, threads and
    CTAs an SM, and CTAs a tile."""

    name: str
    bq: int
    bk: int
    threads: int
    ctas_per_sm: int
    split: int


# the tiles grid's instance of each head dim, and the stream grid's
FMA_TILINGS = {
    64: FmaTiling("FmaD64", 64, 64, 128, 2, 1),
    72: FmaTiling("FmaD72", 64, 64, 128, 2, 1),
    80: FmaTiling("FmaD80", 64, 56, 128, 2, 1),
    128: FmaTiling("FmaD128", 128, 64, 256, 1, 2),
}
STREAM_TILINGS = {64: FmaTiling("FmaD64S", 64, 32, 128, 3, 1)}
GRIDS = {"tiles": 0, "stream": 1}     # the C entry's grid argument


class FmaGrid(NamedTuple):
    """A float32 launch: the grid (``tiles`` or ``stream``), its CTAs,
    the slots it runs on (SMs × CTAs an SM), the key blocks its busiest
    slot runs, and the (query, key) pairs an SM computes for the CTAs it
    holds at once (blocks × BK × BQ × CTAs an SM: the rule's measure of
    time)."""

    kind: str
    ctas: int
    slots: int
    blocks: int
    sm_pairs: int

    @property
    def waves(self) -> float:
        return self.ctas / self.slots


def _units(t: FmaTiling, bh: int, tq: int, tk: int) -> int:
    """The (b·h, query tile, key block) units of a tiling."""
    return bh * -(-tq // t.bq) * -(-tk // t.bk)


def fma_grid(bh: int, tq: int, tk: int, d: int, causal: bool,
             masked: bool, sms: int) -> FmaGrid:
    """The float32 launch rule. The tiles grid runs ``ceil(CTAs / slots)``
    waves, each of a tile's ``ceil(tk / BK)`` key blocks; the stream grid
    (D = 64 only, on its own 32-key, three-CTA instance) gives each of
    ``min(slots, units)`` CTAs an equal run of the units (b·h, tile, key
    block), ``ceil(units / CTAs)`` blocks, and one more for the pieces it
    writes and merges. It is taken only where an SM computes fewer
    (query, key) pairs, and never for a causal grid or with valid_len
    (``masked``): the host does not know the work valid_len leaves."""
    t = FMA_TILINGS[d]
    slots = sms * t.ctas_per_sm
    ctas = bh * -(-tq // t.bq) * t.split
    blocks = -(-ctas // slots) * -(-tk // t.bk // t.split)
    tiles_grid = FmaGrid("tiles", ctas, slots, blocks,
                         blocks * t.bk * t.bq * t.ctas_per_sm)
    s = STREAM_TILINGS.get(d)
    if s is None or causal or masked or ctas == 0:
        return tiles_grid
    units = _units(s, bh, tq, tk)
    n = min(sms * s.ctas_per_sm, units)
    blocks = -(-units // n) + 1
    stream = FmaGrid("stream", n, sms * s.ctas_per_sm, blocks,
                     blocks * s.bk * s.bq * s.ctas_per_sm)
    return stream if stream.sm_pairs < tiles_grid.sm_pairs else tiles_grid


def stream_workspace_floats(d: int, ctas: int) -> int:
    """Floats of the stream grid's workspace: two slots a CTA of m, l and
    O (BQ·(D + 2) floats), then a count a CTA (int32)."""
    return 2 * ctas * STREAM_TILINGS[d].bq * (d + 2) + ctas


def check_grid(grid: FmaGrid, dtype: torch.dtype, d: int, causal: bool,
               units: int) -> None:
    """Refuse a grid the C entry does not have (it would return
    cudaErrorNotSupported): the stream grid is float32 D = 64's, not
    causal, and has from 1 to ``units`` CTAs (its instance's (b·h, tile,
    key block) units, fewer than 2^31)."""
    if grid.kind not in GRIDS or (grid.kind == "stream" and not (
            dtype == torch.float32 and d in STREAM_TILINGS
            and not causal and 1 <= grid.ctas <= units < 2 ** 31)):
        raise UnsupportedError("flash_attention has no such grid",
                               grid=grid.kind, ctas=grid.ctas, units=units,
                               dtype=str(dtype), head_dim=d, causal=causal)


INFO_FIELDS = ("d", "bq", "bk", "threads", "smem_bytes", "split",
               "ctas_per_sm", "declared_ctas")


def fma_instances(lib) -> list:
    """Every float32 instance in a built K2 library, by name: the fields
    of ``oar_flash_fma_info`` (its shape, threads, shared memory, CTAs a
    tile, the CTAs an SM the occupancy calculator finds and those the
    design declares) and its return code."""
    lib.oar_flash_fma_name.restype = ctypes.c_char_p
    lib.oar_flash_fma_name.argtypes = [ctypes.c_int]
    lib.oar_flash_fma_info.restype = ctypes.c_int
    lib.oar_flash_fma_info.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    out = []
    for i in itertools.count():
        name = lib.oar_flash_fma_name(i)
        if name is None:
            return out
        vals = (ctypes.c_int * len(INFO_FIELDS))()
        rc = lib.oar_flash_fma_info(i, vals)
        out.append({"name": name.decode(), **dict(zip(INFO_FIELDS, vals)),
                    "rc": rc})


def check_instances(instances) -> None:
    """The library's float32 instances must be the launch rule's: a tiles
    instance a head dim as :data:`FMA_TILINGS` declares it and a stream
    one as :data:`STREAM_TILINGS` does (shape, threads, CTAs a tile and an
    SM), each fitting on an SM the CTAs it declares. Raises
    AssertionError."""
    want = {f"{t.name} {g}": (d, t.bq, t.bk, t.threads, t.split,
                              t.ctas_per_sm)
            for g, table in (("tiles", FMA_TILINGS),
                             ("stream", STREAM_TILINGS))
            for d, t in table.items()}
    got = {f["name"]: (f["d"], f["bq"], f["bk"], f["threads"], f["split"],
                       f["declared_ctas"]) for f in instances}
    for f in instances:
        if f["rc"] != 0 or f["ctas_per_sm"] < f["declared_ctas"]:
            raise AssertionError(
                f"float32 K2 instance {f['name']}: {f['ctas_per_sm']} CTAs "
                f"per SM (rc {f['rc']}), {f['declared_ctas']} declared")
    if got != want:
        raise AssertionError(f"float32 K2 instances (D, BQ, BK, threads, "
                             f"CTAs a tile, CTAs an SM) {got}, the launch "
                             f"rule's {want}")




def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, valid_len: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version (any device): q (B, H, Tq, D), k/v
    (B, H, Tk, D), valid_len (B,) valid key count."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    mask = None
    if valid_len is not None:
        keys = torch.arange(tk, device=q.device)[None, :]
        mask = (keys < valid_len.to(q.device)[:, None])[:, None, None, :]
    if causal:
        cm = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        mask = cm[None, None] if mask is None else (mask & cm)
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(logits.float(), dim=-1)
    if mask is not None:
        w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)
    return torch.matmul(w.to(v.dtype), v)


def kernel_strides(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> Tuple[int, ...]:
    """The (batch, head, token) element strides of q, k and v, in turn,
    that the kernel reads them through. The last axis must be unit-stride,
    and every stride in bytes and every base address a multiple of 16
    (TMA's rule for bfloat16; the 16-byte ``cp.async`` copies and vector
    loads of float32); anything else raises :class:`InvalidInputError` — the
    wrapper never copies to make a layout fit. The stride of an axis of
    size 1 is never followed, so it is given as the contiguous one."""
    out = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        shape = t.shape
        contiguous = (shape[1] * shape[2] * shape[3], shape[2] * shape[3],
                      shape[3])
        strides = [t.stride(a) if shape[a] > 1 else contiguous[a]
                   for a in range(3)]
        if (shape[3] > 1 and t.stride(3) != 1) \
                or any(s < 0 or (s * size) % _ALIGN for s in strides) \
                or t.data_ptr() % _ALIGN:
            raise InvalidInputError(
                "flash_attention reads a (B, H, T, D) view with unit stride "
                f"in D and strides and base address in multiples of "
                f"{_ALIGN} bytes", tensor=name, shape=tuple(shape),
                stride=tuple(t.stride()), byte_offset=t.data_ptr() % _ALIGN)
        out.extend(strides)
    return tuple(out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    valid_len: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Attention over (B, H, T, D) tensors with per-batch key lengths;
    output (B, H, Tq, D) in q's dtype. On the card it is a view of
    (B, Tq, H, D) memory."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise InvalidInputError("flash_attention expects q (B, H, Tq, D) "
                                "and k, v (B, H, Tk, D)", q=tuple(q.shape),
                                k=tuple(k.shape), v=tuple(v.shape))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KINDS:
        raise InvalidInputError("flash_attention takes float32 or bfloat16 "
                                "q, k, v of one dtype", dtype=str(q.dtype))
    if not (q.device == k.device == v.device):
        raise InvalidInputError("flash_attention takes q, k, v on one device",
                                devices=[str(t.device) for t in (q, k, v)])
    b, h, tq, d = q.shape
    if valid_len is not None and tuple(valid_len.shape) != (b,):
        raise InvalidInputError("valid_len must be (B,)",
                                shape=tuple(valid_len.shape))
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, valid_len=valid_len,
                                   causal=causal)
    if q.device.type != "cuda":
        raise UnsupportedError("flash_attention runs on CPU or CUDA tensors",
                               device=str(q.device))
    if d not in _HEAD_DIMS[q.dtype]:
        raise UnsupportedError("the flash kernel is built for head dims "
                               f"{_HEAD_DIMS[q.dtype]} in {q.dtype}",
                               head_dim=d)
    grid = FmaGrid("tiles", 0, 0, 0, 0)
    if q.dtype == torch.float32:
        grid = fma_grid(b * h, tq, k.shape[2], d, bool(causal),
                        valid_len is not None,
                        torch.cuda.get_device_properties(
                            q.device).multi_processor_count)
    return launch(q, k, v, valid_len, bool(causal), grid)


def launch(q, k, v, valid_len, causal: bool,
           grid: FmaGrid) -> torch.Tensor:
    """K2 on the card on ``grid`` (:func:`flash_attention` takes it from
    :func:`fma_grid`; the card tests also pass others), with the stream
    grid's workspace: one launch, or none where there is no query or key
    (every row is then fully masked: 0)."""
    b, h, tq, d = q.shape
    units = 0
    if d in STREAM_TILINGS:
        units = _units(STREAM_TILINGS[d], b * h, tq, k.shape[2])
    check_grid(grid, q.dtype, d, causal, units)
    strides = (ctypes.c_longlong * 9)(*kernel_strides(q, k, v))
    out = torch.empty((b, tq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if tq == 0 or k.shape[2] == 0:
        return out.zero_()
    vl = None
    if valid_len is not None:
        vl = valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    work = None
    if grid.kind == "stream":
        work = torch.empty(stream_workspace_floats(d, grid.ctas),
                           dtype=torch.float32, device=q.device)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  vl.data_ptr() if vl is not None else None,
                  _KINDS[q.dtype], b, h, tq, k.shape[2], d,
                  ctypes.addressof(strides), 1.0 / math.sqrt(d),
                  int(causal), GRIDS[grid.kind], grid.ctas,
                  work.data_ptr() if work is not None else None,
                  torch.cuda.current_stream(q.device).cuda_stream,
                  device=q.device,
                  what=f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
                       f"{grid.kind} grid")
    return out

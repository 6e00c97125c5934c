"""The K2 flash-attention, K3 add+RMSNorm and K4 qk-norm+rope ports
against the JAX package.

CPU tensors take the port's plain versions (``flash_attention_ref``,
``add_rmsnorm_ref``, ``qk_norm_rope_ref``); they are held against the JAX
Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU
(``tests/test_flash_attention.py``, ``tests/test_fused_norm_rope.py``).
Inputs are seeded numpy, float32; tolerance 1e-5 absolute (values are
O(1); the two sum in different orders), 1e-6 for K4. K2 also takes the
vision towers' layout, (B, T, H, D) projections seen as (B, H, T, D): on
the CPU that view gives the contiguous input's output, and
``kernel_strides`` (the strides the CUDA kernel is passed, checked against
TMA's 16-byte rule) is held here. The CUDA kernels against the plain
versions need a card and are marked ``cuda``.
"""

import ctypes

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from oar_ocr_tpu.ops.flash_attention import flash_attention as j_flash
from oar_ocr_tpu.ops.fused_norm_rope import fused_add_rmsnorm as j_add_rms
from oar_ocr_tpu.ops.fused_norm_rope import fused_qk_norm_rope as j_qk_rope
from oar_ocr_tpu_torch.errors import InvalidInputError, UnsupportedError
from oar_ocr_tpu_torch.ops import flash_attention as fa
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr

TOL = 1e-5


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for t in (tq, tk, tk)]


# (B, H, Tq, Tk, D, valid_len, causal); Tq >= 128 so the JAX side takes
# its Pallas kernel, T unaligned to its 128 blocks
FLASH_CASES = [
    (2, 2, 200, 200, 72, [200, 0], False),      # a fully masked row
    (2, 3, 130, 130, 16, [77, 130], False),
    (1, 2, 128, 300, 72, [300], False),         # Tq != Tk
    (1, 2, 160, 160, 72, None, True),
    (2, 2, 140, 140, 16, [140, 50], True),
    (1, 2, 129, 129, 128, [129], False),        # valid_len == Tk, D = 128
    (2, 1, 128, 333, 72, [333, 129], False),    # valid_len past a block
    (2, 2, 150, 150, 64, [150, 61], False),     # D = 64, the family towers
    # D = 64 tails: one row or key past a 64-row tile or block, one valid
    # key, and HPD's 1025 keys at one head
    (3, 2, 129, 129, 64, [129, 1, 65], False),
    (3, 2, 161, 161, 64, [161, 1, 65], False),
    (1, 1, 128, 1025, 64, None, False),
]


def _tower_view(a):
    """(B, H, T, D) data laid out as the towers' (B, T, H, D) projection,
    seen as (B, H, T, D)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                            ).transpose(1, 2)


@pytest.mark.parametrize("b,h,tq,tk,d,vlen,causal", FLASH_CASES)
def test_flash_ref_matches_jax_kernel(b, h, tq, tk, d, vlen, causal):
    q, k, v = _qkv(0, b, h, tq, tk, d)
    jv = None if vlen is None else jnp.asarray(vlen, jnp.int32)
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             valid_len=jv, causal=causal, use_pallas=True,
                             interpret=True))
    before = fa.KERNEL.launches
    tv = None if vlen is None else torch.tensor(vlen, dtype=torch.int32)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), valid_len=tv,
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # the towers' strided layout: the same output
    views = [_tower_view(a) for a in (q, k, v)]
    assert h == 1 or not views[0].is_contiguous()
    strided = fa.flash_attention(*views, valid_len=tv, causal=causal)
    np.testing.assert_allclose(strided.numpy(), got.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(strided.numpy(), ref, atol=TOL, rtol=0)
    assert fa.KERNEL.launches == before        # CPU tensors never launch
    if vlen is not None and 0 in vlen:
        assert np.all(got.numpy()[vlen.index(0)] == 0.0)
        assert np.all(strided.numpy()[vlen.index(0)] == 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d", [(1, 16, 40, 72), (2, 16, 33, 72),
                                     (2, 4, 9, 128), (1, 1, 5, 72)])
def test_kernel_strides_of_tower_views(dtype, b, h, t, d):
    """The towers' q/k/v: (B, T, H, D) projections viewed as (B, H, T, D),
    read through (batch, head, token) strides (T·H·D, D, H·D); contiguous
    inputs through (H·T·D, T·D, D). An axis of size 1 gets the contiguous
    stride, which the kernel never follows."""
    proj = torch.zeros((b, t, h, d), dtype=dtype)
    view = proj.transpose(1, 2)
    dense = torch.zeros((b, h, t, d), dtype=dtype)
    tower = (t * h * d if b > 1 else h * t * d, d if h > 1 else t * d,
             h * d if t > 1 else d)
    contiguous = (h * t * d, t * d, d)
    assert fa.kernel_strides(view, view, view) == tower * 3
    assert fa.kernel_strides(dense, view, dense) == \
        contiguous + tower + contiguous


@pytest.mark.parametrize("bad", ["d_stride", "row_pitch", "head_pitch",
                                 "batch_pitch", "base_offset"])
def test_kernel_strides_reject_layouts_tma_cannot_read(bad):
    """No silent copy: a layout TMA cannot read raises."""
    bf16 = torch.bfloat16
    ok = torch.zeros((2, 2, 8, 72), dtype=bf16)
    bad_t = {
        "d_stride": torch.zeros((2, 2, 8, 144), dtype=bf16)[..., ::2],
        "row_pitch": torch.zeros((2, 2, 8, 73), dtype=bf16)[..., :72],
        "head_pitch": torch.zeros((2, 8, 2, 73), dtype=bf16
                                  )[..., :72].transpose(1, 2),
        "batch_pitch": torch.zeros(2 * 1156, dtype=bf16).as_strided(
            (2, 2, 8, 72), (1156, 576, 72, 1)),            # 2312 bytes
        "base_offset": torch.zeros((2, 2, 8, 80), dtype=bf16
                                   )[..., 1:73],           # 2-byte offset
    }[bad]
    assert bad_t.shape == ok.shape
    with pytest.raises(InvalidInputError):
        fa.kernel_strides(ok, bad_t, ok)


def test_flash_rejects_bad_shapes():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(InvalidInputError):
        fa.flash_attention(q, torch.zeros((1, 3, 4, 8)),
                           torch.zeros((1, 3, 4, 8)))
    with pytest.raises(InvalidInputError):
        fa.flash_attention(q, q, q.double())
    with pytest.raises(InvalidInputError):
        fa.flash_attention(q, q, q, valid_len=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(InvalidInputError):      # no pointer crosses devices
        fa.flash_attention(q, q.to("meta"), q)


# decode rows (1 and 2 of the decoders' 1024), an odd width, prefill rows
@pytest.mark.parametrize("shape", [(2, 5, 64), (300, 1024), (1, 1024),
                                   (2, 1024), (3, 100)])
def test_add_rmsnorm_ref_matches_jax_kernel(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    j_normed, j_sum = j_add_rms(jnp.asarray(x), jnp.asarray(r),
                                jnp.asarray(scale), eps=1e-5, interpret=True)
    before = fnr.KERNEL.launches
    normed, total = fnr.fused_add_rmsnorm(torch.from_numpy(x),
                                          torch.from_numpy(r),
                                          torch.from_numpy(scale), eps=1e-5)
    np.testing.assert_allclose(normed.numpy(), np.asarray(j_normed),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(total.numpy(), np.asarray(j_sum), atol=TOL,
                               rtol=0)
    assert fnr.KERNEL.launches == before


def test_add_rmsnorm_rejects_mixed_dtypes():
    x = torch.zeros((2, 8))
    with pytest.raises(InvalidInputError):
        fnr.fused_add_rmsnorm(x, x, torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(InvalidInputError):
        fnr.fused_add_rmsnorm(x, torch.zeros((2, 4)), torch.ones(8))
    with pytest.raises(InvalidInputError):
        fnr.fused_add_rmsnorm(x, x.to("meta"), torch.ones(8))


def _qk_inputs(seed, r, t, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, t, d)).astype(np.float32) * 3.0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    ang = rng.uniform(0.0, 20.0, (t, d // 2))
    return (x, scale, np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


# (R, T, D): the Hunyuan q/k shapes at prefill (cut in T) and decode, the
# tiny config's D = 16, and T over the JAX kernel's 256-row blocks
QK_CASES = [(16, 1, 128), (4, 1, 128), (4, 37, 128), (2, 300, 64),
            (8, 9, 16)]


@pytest.mark.parametrize("r,t,d", QK_CASES)
def test_qk_norm_rope_ref_matches_jax_kernel(r, t, d):
    x, scale, cos, sin = _qk_inputs(4, r, t, d)
    ref = np.asarray(j_qk_rope(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(cos), jnp.asarray(sin), eps=1e-5,
                               interpret=True))
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(cos), torch.from_numpy(sin),
                                 eps=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert fnr.KERNEL_QK.launches == before     # CPU tensors never launch


def test_qk_norm_rope_takes_strided_rows():
    """The decoder passes (B, T, H, D) projections viewed as (H, T, D)."""
    x, scale, cos, sin = _qk_inputs(5, 4, 6, 16)
    view = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))
                            ).transpose(0, 1)
    assert not view.is_contiguous()
    args = (torch.from_numpy(scale), torch.from_numpy(cos),
            torch.from_numpy(sin))
    np.testing.assert_array_equal(
        fnr.fused_qk_norm_rope(view, *args).numpy(),
        fnr.qk_norm_rope_ref(torch.from_numpy(x), *args).numpy())


@pytest.mark.parametrize("bad", ["odd_d", "rank", "scale", "cos", "dtype",
                                 "scale_dtype", "cos_dtype", "device"])
def test_qk_norm_rope_rejects_bad_input(bad):
    x, scale = torch.zeros((2, 4, 8)), torch.ones(8)
    cos, sin = torch.ones((4, 4)), torch.zeros((4, 4))
    args = {
        "odd_d": (torch.zeros((2, 4, 7)), torch.ones(7), torch.ones((4, 3)),
                  torch.zeros((4, 3))),
        "rank": (torch.zeros((4, 8)), scale, cos, sin),
        "scale": (x, torch.ones(4), cos, sin),
        "cos": (x, scale, torch.ones((3, 4)), sin),
        "dtype": (x.double(), scale.double(), cos, sin),
        "scale_dtype": (x, scale.bfloat16(), cos, sin),
        "cos_dtype": (x, scale, cos.bfloat16(), sin.bfloat16()),
        "device": (x, scale.to("meta"), cos, sin),
    }[bad]
    with pytest.raises(InvalidInputError):
        fnr.fused_qk_norm_rope(*args)


def test_qk_norm_rope_other_devices_raise():
    x = torch.zeros((2, 4, 8), device="meta")
    with pytest.raises(UnsupportedError):
        fnr.fused_qk_norm_rope(x, torch.ones(8, device="meta"),
                               torch.ones((4, 4), device="meta"),
                               torch.zeros((4, 4), device="meta"))


def _qk_batch(seed, b, t, hq, hk, d):
    """The decoder's K4 inputs: q (B, T, Hq, D) and k (B, T, Hk, D) as
    strided views of one wider (B, T, Hq + Hk + 1, D) buffer, the scales,
    and per-row float32 cos/sin (B, T, D/2)."""
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, t, hq + hk + 1, d)).astype(np.float32) * 3
    ang = rng.uniform(0.0, 20.0, (b, t, d // 2))
    return (buf, rng.uniform(0.5, 1.5, d).astype(np.float32),
            rng.uniform(0.5, 1.5, d).astype(np.float32),
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _qk_views(buf, hq, hk):
    return buf[:, :, :hq], buf[:, :, hq:hq + hk]


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("t", [1, 7])
def test_qk_norm_rope_qk_ref_matches_jax_kernel(b, t):
    """The one-launch form's plain version against the Pallas kernel per
    batch row: q comes back (B, Hq, T, D), k lands in a strided KV-cache
    slot, and nothing else of the cache changes."""
    from oar_ocr_tpu_torch.vl.kv_cache import KVCache

    hq, hk, d, pos = 4, 2, 16, 3
    buf, qs, ks, cos, sin = _qk_batch(7, b, t, hq, hk, d)
    tbuf = torch.from_numpy(buf)
    q, k = _qk_views(tbuf, hq, hk)
    assert b * t == 1 or not (q.is_contiguous() or k.is_contiguous())
    cache = KVCache.create(2, b, hk, 12, d, dtype=torch.float32,
                           device=torch.device("cpu"))
    k_out = cache.k_slot(1, pos, t)
    assert not k_out.is_contiguous()
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope_qk(
        q, k, *(torch.from_numpy(a) for a in (qs, ks, cos, sin)),
        k_out=k_out, eps=1e-5)
    assert fnr.KERNEL_QK.launches == before     # CPU tensors never launch
    assert got.shape == (b, hq, t, d) and got.is_contiguous()
    jq, jk = _qk_views(buf, hq, hk)
    for i in range(b):
        for x, scale, out in ((jq, qs, got[i]), (jk, ks, k_out[i])):
            ref = j_qk_rope(jnp.asarray(x[i].transpose(1, 0, 2)),
                            jnp.asarray(scale), jnp.asarray(cos[i]),
                            jnp.asarray(sin[i]), eps=1e-5, interpret=True)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=1e-6, rtol=0)
    rest = cache.k.clone()
    rest[1, :, :, pos:pos + t] = 0
    assert not rest.any() and not cache.v.any()


@pytest.mark.parametrize("bad", ["rank", "k_shape", "k_out_shape", "cos",
                                 "scale", "dtype", "device"])
def test_qk_norm_rope_qk_rejects_bad_input(bad):
    q, k = torch.zeros((2, 3, 4, 8)), torch.zeros((2, 3, 2, 8))
    k_out, scale = torch.zeros((2, 2, 3, 8)), torch.ones(8)
    cos = sin = torch.zeros((2, 3, 4))
    args = dict(q=q, k=k, q_scale=scale, k_scale=scale, cos=cos, sin=sin,
                k_out=k_out)
    args.update({
        "rank": dict(q=torch.zeros((3, 4, 8))),
        "k_shape": dict(k=torch.zeros((2, 4, 2, 8))),
        "k_out_shape": dict(k_out=torch.zeros((2, 3, 2, 8))),
        "cos": dict(cos=torch.zeros((3, 4))),      # the JAX form's (T, D/2)
        "scale": dict(k_scale=torch.ones(4)),
        "dtype": dict(k_out=k_out.bfloat16()),
        "device": dict(k_out=k_out.to("meta")),
    }[bad])
    with pytest.raises(InvalidInputError):
        fnr.fused_qk_norm_rope_qk(**args)


# ------------------------------ on the card ------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


# K2 on the card: tile edges of both kernels (f32: 64-row CTAs and
# 64-key blocks at D = 64 and 72, with one key or one valid key in the
# last block, and the stream grid the launch rule gives D = 64 without
# valid_len (HPD's 16 heads × 1025 tokens among them);
# 64-key blocks at D = 64 and 72; at D = 128 the split tiling's 128-row
# CTAs and 64-key blocks, lengths 31-33 and 127-129 for the 32-key and
# 64-row edges it has replaced; bf16: 128-row CTAs, 128- and 64-key
# blocks), valid_len mid-block, 0 and equal to Tk, causal at D = 128 with
# Tq = Tk and Tq != Tk, D = 72 and 128, GLM-OCR's 12 heads at D = 128, and
# key lengths past one lap of each K/V ring (f32: 2 stages; bf16: 4 of
# 128 keys at D = 72, 3 of 64 at D = 128), with a ragged last block
CUDA_FLASH_CASES = [
    (2, 2, 129, 1100, 72, [1100, 700], False),
    (1, 2, 400, 400, 128, [400], False),
    (1, 2, 400, 400, 128, None, True),
    (2, 16, 333, 333, 72, [333, 0], False),
    (1, 4, 257, 257, 128, None, True),
    (2, 2, 64, 190, 128, [190, 65], False),
    (2, 2, 129, 129, 72, [129, 65], False),
    (1, 2, 127, 333, 72, [333], False),
    (1, 3, 200, 200, 128, [200], True),
    (1, 2, 100, 300, 128, None, True),
    (1, 2, 300, 100, 128, None, True),
    (1, 2, 65, 33, 128, [31], False),
    (1, 2, 63, 97, 128, None, False),
    (2, 2, 129, 1100, 64, [1100, 700], False),  # D = 64: no tail
    (2, 16, 333, 333, 64, [333, 0], False),
    (1, 2, 65, 65, 64, None, False),
    (2, 12, 333, 333, 128, [333, 100], False),  # GLM's heads, mid-block
    (1, 2, 129, 300, 128, [300], False),       # past one lap, ragged
    (1, 2, 129, 129, 128, None, True),         # BQ + 1, causal
    (2, 2, 200, 457, 128, [457, 0], False),    # a row with no key
] + [(1, 2, t, t, 72, None, False)
     for t in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129)] \
  + [(1, 2, t, t, 128, None, False)
     for t in (31, 32, 33, 63, 64, 65, 127, 128, 129)] \
  + [(1, 2, t, t, 64, None, False) for t in (1, 63, 64, 65, 129)] \
  + [
    # one key in the last 64-key block (a ragged block scores one column
    # a thread and runs P·V over its keys alone), at D = 64 and 72
    (1, 2, 100, 193, 64, None, False),
    (1, 2, 100, 193, 72, None, False),
    (2, 2, 130, 300, 64, [257, 129], False),   # valid_len: one key left
    (2, 2, 130, 300, 72, [257, 129], False),
    (1, 16, 1025, 1025, 64, None, False),      # an HPD tile, B = 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhtd", "tower"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,tq,tk,d,vlen,causal", CUDA_FLASH_CASES)
def test_cuda_flash_matches_plain(layout, dtype, b, h, tq, tk, d, vlen,
                                  causal):
    """float32 within 2e-5 of the plain version; bfloat16 within 1.6e-2 and
    2^-6·max|ref| (a few bf16 ulps of the largest output) of the float32
    plain version on the same rounded inputs, and within 4e-2
    of the bfloat16 plain version, which also rounds P to bfloat16 but
    takes q·kᵀ in bfloat16 (an ulp of 2^-3 at |q·k| >= 32, ~1.5e-2 in the
    logits after the 1/sqrt(D) scale). Fully masked rows exactly 0; the
    output is a (B, H, Tq, D) view of (B, Tq, H, D) memory."""
    _need_card()
    dt = getattr(torch, dtype)
    q, k, v = ((_tower_view(a) if layout == "tower" else torch.from_numpy(a))
               .cuda().to(dt) for a in _qkv(2, b, h, tq, tk, d))
    tv = None if vlen is None else torch.tensor(vlen, dtype=torch.int32,
                                                device="cuda")
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, valid_len=tv, causal=causal)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    assert got.shape == (b, h, tq, d) and got.transpose(1, 2).is_contiguous()
    ref = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                 valid_len=tv, causal=causal)
    tol = (2e-5 if dtype == "float32"
           else min(1.6e-2, 2.0 ** -6 * float(ref.abs().max())))
    assert float((got.float() - ref).abs().max()) <= tol
    if dtype == "bfloat16":
        plain = fa.flash_attention_ref(q, k, v, valid_len=tv, causal=causal)
        assert float((got.float() - plain.float()).abs().max()) <= 4e-2
    if vlen is not None and 0 in vlen:
        assert bool((got[vlen.index(0)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhtd", "tower"])
@pytest.mark.parametrize("b,h,tq,tk,vlen", [
    (1, 16, 333, 333, None), (2, 4, 129, 1100, [1100, 700]),
    (2, 2, 65, 33, [31, 0]), (1, 2, 57, 57, None),
    (1, 4, 100, 169, None), (2, 2, 100, 225, [169, 57])])
def test_cuda_flash_d80_matches_plain(layout, b, h, tq, tk, vlen):
    """The float32 D = 80 instance (MinerU's tower; 56-key blocks) within
    2e-5 of the plain version, ragged tiles, one key (or one valid key) in
    the last block and a fully masked row included; bfloat16 has no D = 80
    instance and raises."""
    _need_card()
    q, k, v = ((_tower_view(a) if layout == "tower" else torch.from_numpy(a))
               .cuda() for a in _qkv(4, b, h, tq, tk, 80))
    tv = None if vlen is None else torch.tensor(vlen, dtype=torch.int32,
                                                device="cuda")
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, valid_len=tv)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    ref = fa.flash_attention_ref(q, k, v, valid_len=tv)
    assert float((got - ref).abs().max()) <= 2e-5
    if vlen is not None and 0 in vlen:
        assert bool((got[vlen.index(0)] == 0).all())
    with pytest.raises(UnsupportedError):
        fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())


def _fused_qkv(seed, b, h, t, d):
    """q, k and v as HPD's InternViT passes them: views of one
    (B, T, 3, H, D) projection, seen as (B, H, T, D)."""
    qkv = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, t, 3, h, d)).astype(np.float32)).cuda()
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t", [(1, 16, 1025), (3, 2, 1025),
                                   (5, 16, 1025)])
def test_cuda_flash_fused_qkv_matches_plain(b, h, t):
    """HPD's tiles through the fused-qkv view on the grid the launch rule
    picks (the stream grid: at (3, 2, 1025) 102 tiles over 396 CTAs, so
    every tile is cut mid-way), within 2e-5 of the plain version, one
    launch, and the same bits on a second call."""
    _need_card()
    q, k, v = _fused_qkv(7, b, h, t, 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fa.fma_grid(b * h, t, t, 64, False, False, sms).kind == "stream"
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    ref = fa.flash_attention_ref(q, k, v)
    assert float((got - ref).abs().max()) <= 2e-5
    assert torch.equal(fa.flash_attention(q, k, v), got)


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [1, 7, 100, 395, 396, 792, 1000])
@pytest.mark.parametrize("tq,vlen", [(1025, None), (200, [1025, 0, 300])])
def test_cuda_flash_stream_grid_at_every_cut(ctas, tq, vlen):
    """The stream grid of any CTA count, the launch rule's or not: runs
    cut anywhere in a tile (one CTA holding every unit; a unit a CTA at
    792 and 200 tokens; 1000 CTAs at 1025: runs of three or four blocks
    of 32 keys, a tile over nine to twelve CTAs), Tq != Tk, and valid_len
    (which the rule
    never gives it) with a batch of no key and one that ends mid-block:
    within 2e-5 of the plain version, that batch all 0. Inputs differ by
    case and the output's memory was last NaN, so no case can pass on a
    result an earlier one left. More CTAs than units are refused."""
    _need_card()
    b, h, tk = 3, 2, 1025
    q, _, _ = _fused_qkv(8 + ctas, b, h, tq, 64)
    _, k, v = _fused_qkv(9 + ctas, b, h, tk, 64)
    tv = None if vlen is None else torch.tensor(vlen, dtype=torch.int32,
                                                device="cuda")
    grid = fa.FmaGrid("stream", ctas, ctas, 0, 0)
    if ctas > fa._units(fa.STREAM_TILINGS[64], b * h, tq, tk):
        with pytest.raises(UnsupportedError):
            fa.launch(q, k, v, tv, False, grid)
        return
    torch.full((b, tq, h, 64), float("nan"), device="cuda")
    got = fa.launch(q, k, v, tv, False, grid)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, valid_len=tv)
    assert float((got - ref).abs().max()) <= 2e-5
    if vlen is not None:
        assert bool((got[1] == 0).all())


@pytest.mark.cuda
def test_cuda_flash_refuses_a_grid_it_does_not_have():
    """The stream grid is float32 D = 64's, not causal: the wrapper
    refuses any other before the C entry, which refuses it too."""
    _need_card()
    q = torch.zeros((1, 2, 70, 72), device="cuda")
    grid = fa.FmaGrid("stream", 4, 4, 0, 0)
    with pytest.raises(UnsupportedError):
        fa.launch(q, q, q, None, False, grid)
    lib = fa.KERNEL.build().lib
    work = torch.empty(fa.stream_workspace_floats(64, 4), device="cuda")
    for d, causal in ((72, 0), (64, 1)):
        x = torch.zeros((1, 2, 70, d), device="cuda")
        strides = (ctypes.c_longlong * 9)(*fa.kernel_strides(x, x, x))
        rc = lib.oar_flash_attention(
            x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), None, 0,
            1, 2, 70, 70, d, ctypes.addressof(strides), 0.125, causal, 1, 4,
            work.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 801                      # cudaErrorNotSupported


@pytest.mark.cuda
def test_cuda_flash_refuses_layouts_without_copying():
    _need_card()
    q = torch.zeros((1, 2, 8, 73), dtype=torch.bfloat16,
                    device="cuda")[..., :72]
    before = fa.KERNEL.launches
    with pytest.raises(InvalidInputError):
        fa.flash_attention(q, q, q)
    assert fa.KERNEL.launches == before


# (rows, d, offset): rows on both sides of the SM count (a CTA per row
# below it, a warp per row above), d = 1024 with 16-byte vectors; d = 100
# (not a multiple of 8) and inputs starting 4 bytes past a 16-byte
# boundary take the scalar loops
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,offset", [
    (1, 1024, 0), (2, 1024, 0), (3, 1024, 0), (9, 1024, 0), (131, 1024, 0),
    (2508, 1024, 0), (3, 100, 0), (2508, 100, 0), (2, 1024, 4),
    (2508, 1024, 4)])
def test_cuda_add_rmsnorm_matches_plain(dtype, rows, d, offset):
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    skip = offset // torch.tensor([], dtype=dt).element_size()
    x, r = (torch.randn(rows * d + skip, generator=g, device="cuda").to(dt)
            [skip:].view(rows, d) for _ in range(2))
    assert x.data_ptr() % 16 == offset
    scale = torch.rand((d,), generator=g, device="cuda").to(dt) + 0.5
    before = fnr.KERNEL.launches
    normed, total = fnr.fused_add_rmsnorm(x, r, scale, eps=1e-5)
    torch.cuda.synchronize()
    assert fnr.KERNEL.launches == before + 1
    ref_n, ref_s = fnr.add_rmsnorm_ref(x, r, scale, eps=1e-5)
    if dt == torch.float32:
        rel = (normed - ref_n).abs().max() / ref_n.abs().max()
        assert float(rel) <= 1e-5
        assert float((total - ref_s).abs().max()) <= 1e-6
    else:
        assert torch.equal(total, ref_s)
        ulps = (normed.view(torch.int16).int()
                - ref_n.view(torch.int16).int()).abs().max()
        assert int(ulps) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,t,d", [(16, 1249, 128), (4, 1, 128), (8, 9, 16)])
def test_cuda_qk_norm_rope_matches_plain(dtype, r, t, d):
    _need_card()
    dt = getattr(torch, dtype)
    x, scale, cos, sin = (torch.from_numpy(a).cuda()
                          for a in _qk_inputs(6, r, t, d))
    x, scale = x.to(dt), scale.to(dt)
    # the decoder's strided view: (1, T, R, D) projections seen as (R, T, D)
    view = x.transpose(0, 1).contiguous().transpose(0, 1)
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope(view, scale, cos, sin, eps=1e-5)
    torch.cuda.synchronize()
    assert fnr.KERNEL_QK.launches == before + 1
    ref = fnr.qk_norm_rope_ref(x, scale, cos, sin, eps=1e-5)
    if dt == torch.float32:
        rel = (got - ref).abs().max() / ref.abs().max()
        assert float(rel) <= 1e-5
    else:
        # 1 bf16 ulp of the plain version; where the rotary's difference
        # cancels to near 0, float32 noise of 1e-6·max|ref| is many ulps
        # of the tiny result, so that much absolute error is allowed
        diff = (got.float() - ref.float()).abs()
        a = ref.float().abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
        assert bool((diff <= ulp + 1e-6 * a.max()).all())


# the one-launch K4 on the card: the tiny config's D = 16 with Hq = 4,
# Hk = 2 at B = 1-3, and HunyuanOCR's D = 128, Hq = 16, Hk = 4 at prefill
# (T = 1249) and decode (B = 1 and 2)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,hq,hk,d", [
    (1, 1, 4, 2, 16), (2, 7, 4, 2, 16), (3, 7, 4, 2, 16),
    (1, 1249, 16, 4, 128), (1, 1, 16, 4, 128), (2, 1, 16, 4, 128)])
def test_cuda_qk_norm_rope_qk_matches_plain(dtype, b, t, hq, hk, d):
    """One launch per call; q and the cache slot within the K4 gates of
    the plain version (float32 ≤ 1e-5 relative, bfloat16 ≤ 1 ulp +
    1e-6·max|ref|); the cache outside the slot untouched."""
    _need_card()
    from oar_ocr_tpu_torch.vl.kv_cache import KVCache

    dt = getattr(torch, dtype)
    buf, qs, ks, cos, sin = (torch.from_numpy(a).cuda()
                             for a in _qk_batch(8, b, t, hq, hk, d))
    buf, qs, ks = buf.to(dt), qs.to(dt), ks.to(dt)
    q, k = _qk_views(buf, hq, hk)
    pos = 5
    caches = [KVCache.create(2, b, hk, t + 8, d, dtype=dt,
                             device=torch.device("cuda")) for _ in range(2)]
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin,
                                    k_out=caches[0].k_slot(1, pos, t),
                                    eps=1e-5)
    torch.cuda.synchronize()
    assert fnr.KERNEL_QK.launches == before + 1
    ref = fnr.qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin,
                                  k_out=caches[1].k_slot(1, pos, t), eps=1e-5)
    outside = caches[0].k.clone()
    outside[1, :, :, pos:pos + t] = 0
    assert not outside.any()
    for out, want in ((got, ref), (caches[0].k[1, :, :, pos:pos + t],
                                   caches[1].k[1, :, :, pos:pos + t])):
        diff = (out.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if dt == torch.float32:
            assert float(diff.max()) <= 1e-5 * top
        else:
            a = want.float().abs().clamp_min(2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
            assert bool((diff <= ulp + 1e-6 * top).all())

"""The port's device ops against the JAX ops on the same numpy inputs.

Covers ``ops/det_device`` (separable resize+normalize at the det and rec
pads, bit-packing with and without the 2×2 dilation, quad scores in both
windings), ``ops/warp`` (the separable rec warp for direct and swapped
crops, the gather warp's border clamp, the host matrix builders) and
``ops/ctc`` (last-max-wins ties, dedup before blank, the 6-byte packing).
Float tolerances: 1e-4 absolute on the normalized tiles — they come
from float32 matmuls whose dot products run over a few hundred source
pixels, summed in another order by each framework, so the bound is
about n·ε·255·α ≈ 256 × 6e-8 × 255 × 0.0175 ≈ 7e-5 — and 1e-6 on mean
probabilities; integer and byte outputs must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.ops import ctc as jctc
from oar_ocr_tpu.ops import det_device as jdet
from oar_ocr_tpu.ops import warp as jwarp
from oar_ocr_tpu_torch.ops import ctc, det_device, warp

TILE_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _page(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["det", "rec"])
def test_separable_resize_normalize_matches_jax(kind):
    rng = np.random.default_rng(0)
    imgs = np.stack([_page(rng, 40, 56), _page(rng, 40, 56)])
    src_h = np.array([40, 23], np.int32)
    src_w = np.array([56, 31], np.int32)
    if kind == "det":
        dst_h, dst_w = np.array([32, 64], np.int32), np.array([64, 32], np.int32)
        alpha, beta, pad, out_hw = (0.017, 0.018, 0.019), (-2.1, -2.0, -1.8), 0.0, (64, 96)
    else:
        dst_h, dst_w = np.array([48, 48], np.int32), np.array([70, 20], np.int32)
        alpha, beta, pad, out_hw = (2 / 255,) * 3, (-1.0,) * 3, -1.0, (48, 80)
    ref = np.asarray(jdet.separable_resize_normalize(
        jnp.asarray(imgs), *map(jnp.asarray, (src_h, src_w, dst_h, dst_w)),
        jnp.asarray(alpha, jnp.float32), jnp.asarray(beta, jnp.float32),
        out_h=out_hw[0], out_w=out_hw[1], out_dtype=jnp.float32,
        pad_value=pad))
    got = det_device.separable_resize_normalize(
        _t(imgs), *map(_t, (src_h, src_w, dst_h, dst_w)), alpha, beta,
        out_h=out_hw[0], out_w=out_hw[1], out_dtype=torch.float32,
        pad_value=pad)
    np.testing.assert_allclose(got.numpy(), ref, atol=TILE_TOL, rtol=0)
    g = got.numpy()
    if kind == "det":
        assert np.all(g[0, 32:] == pad) and np.all(g[1, :, 32:] == pad)
    else:
        assert np.all(g[1, :, 20:] == pad)


def test_swap_rb_equals_flipping_the_input():
    """The rec gather path flips BGR before the resample in JAX
    (recognizer.py:165); the port swaps inside the normalize."""
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 255, (1, 20, 30, 3)).astype(np.float32)
    args = [_t(np.array([20], np.int32)), _t(np.array([30], np.int32)),
            _t(np.array([48], np.int32)), _t(np.array([60], np.int32))]
    kw = dict(out_h=48, out_w=80, out_dtype=torch.float32, pad_value=-1.0)
    a = det_device.separable_resize_normalize(
        _t(imgs), *args, (2 / 255,) * 3, (-1.0,) * 3, swap_rb=True, **kw)
    b = det_device.separable_resize_normalize(
        _t(imgs[..., ::-1]), *args, (2 / 255,) * 3, (-1.0,) * 3, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TILE_TOL, rtol=0)


@pytest.mark.parametrize("dilate", [False, True])
def test_pack_bits_matches_jax(dilate):
    rng = np.random.default_rng(2)
    bitmap = rng.random((2, 9, 32)) > 0.8
    jb = jnp.asarray(bitmap)
    if dilate:      # detector.py:135-141
        jb = jax.lax.reduce_window(jb, False, jax.lax.bitwise_or, (1, 2, 2),
                                   (1, 1, 1), [(0, 0), (0, 1), (0, 1)])
    ref = np.asarray(jdet.pack_bits(jb))
    tb = _t(bitmap)
    if dilate:
        tb = det_device.dilate2x2(tb)
    got = det_device.pack_bits(tb)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        np.unpackbits(got.numpy(), axis=-1).astype(bool), np.asarray(jb))


def test_quad_scores_matches_jax_both_windings():
    rng = np.random.default_rng(3)
    prob = rng.random((2, 24, 40)).astype(np.float32)
    quads = [[[2, 3], [20, 3], [20, 10], [2, 10]],
             [[5, 5], [30, 8], [28, 16], [3, 13]],
             [[39, 23], [0, 23], [0, 0], [39, 0]]]
    quads = np.array(quads + [q[::-1] for q in quads], np.float32)
    img_idx = np.array([0, 1, 1, 0, 1, 1], np.int32)
    kq = np.zeros((8, 4, 2), np.float32)   # JAX needs K % chunk == 0
    kq[:6] = quads
    ki = np.zeros(8, np.int32)
    ki[:6] = img_idx
    ref = np.asarray(jdet.quad_scores(jnp.asarray(prob), jnp.asarray(kq),
                                      jnp.asarray(ki)))[:6]
    got = det_device.quad_scores(_t(prob), _t(quads), _t(img_idx), chunk=4)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy()[:3], got.numpy()[3:], atol=1e-6)


def _crop_inputs(rng):
    pages = np.stack([_page(rng, 160, 200), _page(rng, 160, 200)])
    quads = [np.array([[20, 30], [140, 30], [140, 60], [20, 60]], np.float32),
             np.array([[50, 20], [80, 20], [80, 120], [50, 120]], np.float32),
             np.array([[10, 90], [180, 90], [180, 118], [10, 118]],
                      np.float32)]
    return pages, quads


def test_warp_rec_tiles_separable_matches_jax():
    """Direct and swapped crop groups (test_warp.py TestSeparableWarp)."""
    rng = np.random.default_rng(4)
    pages, quads = _crop_inputs(rng)
    nat_hb, nat_wb, out_w, band_h = 64, 256, 320, 72
    seen = set()
    for want_swap in (False, True):
        src = pages.transpose(0, 2, 1, 3).copy() if want_swap else pages
        rows, cols, y0s, idx, nh, nw, ws = [], [], [], [], [], [], []
        for i, q in enumerate(quads):
            m, rw, rh = warp.build_native_crop_matrix(q)
            swapped, rc, cc = warp.separable_coefs(m)
            if swapped != want_swap:
                continue
            rows.append(rc)
            cols.append(cc)
            y0s.append(warp.band_origin(rc, rh, src.shape[1], band_h))
            idx.append(i % 2)
            nh.append(rh)
            nw.append(rw)
            ws.append(min(int(np.ceil(48 * rw / rh)), out_w))
        seen.add(want_swap)
        arrays = [np.array(rows, np.float32), np.array(cols, np.float32),
                  np.array(idx, np.int32), np.array(y0s, np.int32),
                  np.array(nh, np.int32), np.array(nw, np.int32),
                  np.array(ws, np.int32)]
        statics = dict(out_h=48, out_w=out_w, nat_h_bucket=nat_hb,
                       nat_w_bucket=nat_wb, band_h=band_h)
        ref = np.asarray(jwarp.warp_rec_tiles_separable(
            jnp.asarray(src), *map(jnp.asarray, arrays),
            norm=jwarp.NormSpec.rec_bgr(), out_dtype=jnp.float32, **statics))
        got = warp.warp_rec_tiles_separable(
            _t(src), *map(_t, arrays), norm=warp.NormSpec.rec_bgr(),
            out_dtype=torch.float32, **statics)
        np.testing.assert_allclose(got.numpy(), ref, atol=TILE_TOL, rtol=0)
        assert np.all(got.numpy()[0, :, ws[0]:] == -1.0)
    assert seen == {False, True}


def test_sample_transform_clamps_before_floor():
    """A source coordinate in (−1, 0) samples pixel 0, not a blend of
    pixels 0 and 1 with inverted weights (warp.py:106-112); the whole
    4× upscale matches the JAX op."""
    rng = np.random.default_rng(5)
    img = _page(rng, 8, 10)
    mats = jwarp.resize_matrix(8, 10, 32, 40)[None]
    args = [np.zeros(1, np.int32), np.array([40], np.int32),
            np.array([32], np.int32)]
    ref = np.asarray(jwarp.sample_transform(
        jnp.asarray(img[None]), jnp.asarray(mats), *map(jnp.asarray, args),
        out_h=32, out_w=40, norm=jwarp.NormSpec.identity()))
    got = warp.sample_transform(_t(img[None]), _t(mats), *map(_t, args),
                                out_h=32, out_w=40,
                                norm=warp.NormSpec.identity()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert mats[0, 0, 2] < 0                     # first column at x < 0
    np.testing.assert_array_equal(got[0, 0, 0], img[0, 0].astype(np.float32))


def test_slanted_crop_chain_matches_jax():
    """The slanted-crop chain of the recognizer (recognizer.py:151-176):
    the JAX side masks the gather beyond the valid native extent before
    the resize; the port's raw gather (``sample_pixels``) skips that mask
    and the identity normalize, since the resize never reads those pixels
    and normalizes itself, and must give the same rec tiles."""
    rng = np.random.default_rng(8)
    pages = np.stack([_page(rng, 160, 200), _page(rng, 160, 200)])
    quads = [np.array([[30, 30], [120, 50], [110, 80], [20, 60]], np.float32),
             np.array([[40, 100], [170, 90], [172, 118], [42, 128]],
                      np.float32)]
    nat_hb, nat_wb, out_w = 64, 192, 320
    mats, nw, nh, ws = [], [], [], []
    for q in quads:
        m, rw, rh = warp.build_native_crop_matrix(q)
        assert warp.separable_coefs(m) is None       # a slanted crop
        mats.append(m)
        nw.append(rw)
        nh.append(rh)
        ws.append(min(int(np.ceil(48 * rw / rh)), out_w))
    assert max(nh) < nat_hb and max(nw) < nat_wb     # a masked margin exists
    mats = np.stack(mats).astype(np.float32)
    idx = np.array([0, 1], np.int32)
    nw, nh, ws = (np.array(v, np.int32) for v in (nw, nh, ws))
    rec_h = np.full(2, 48, np.int32)
    alpha, beta = (2 / 255,) * 3, (-1.0,) * 3
    jnative = jwarp.sample_transform(
        jnp.asarray(pages), jnp.asarray(mats), jnp.asarray(idx),
        jnp.asarray(nw), jnp.asarray(nh), out_h=nat_hb, out_w=nat_wb,
        norm=jwarp.NormSpec.identity())[..., ::-1]
    ref = np.asarray(jdet.separable_resize_normalize(
        jnative, *map(jnp.asarray, (nh, nw, rec_h, ws)),
        jnp.asarray(alpha, jnp.float32), jnp.asarray(beta, jnp.float32),
        out_h=48, out_w=out_w, out_dtype=jnp.float32, pad_value=-1.0))
    native = warp.sample_pixels(_t(pages), _t(mats), _t(idx),
                                out_h=nat_hb, out_w=nat_wb)
    got = det_device.separable_resize_normalize(
        native, *map(_t, (nh, nw, rec_h, ws)), alpha, beta, out_h=48,
        out_w=out_w, swap_rb=True, out_dtype=torch.float32, pad_value=-1.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=TILE_TOL, rtol=0)
    assert np.all(got.numpy()[0, :, ws[0]:] == -1.0)


def test_host_builders_match_jax():
    rng = np.random.default_rng(6)
    _, quads = _crop_inputs(rng)
    quads.append(np.array([[30, 30], [120, 50], [110, 80], [20, 60]],
                          np.float32))           # slanted
    for q in quads:
        assert warp.crop_geometry(q) == jwarp.crop_geometry(q)
        m, rw, rh = warp.build_native_crop_matrix(q)
        jm, jrw, jrh = jwarp.build_native_crop_matrix(q)
        np.testing.assert_array_equal(m, jm)
        assert (rw, rh) == (jrw, jrh)
        assert warp.separable_coefs(m) == jwarp.separable_coefs(jm)
        got = warp.separable_coefs(m)
        if got is not None:
            assert warp.band_origin(got[1], rh, 160, 72) == \
                jwarp.band_origin(got[1], rh, 160, 72)
    assert warp.separable_coefs(warp.build_native_crop_matrix(quads[-1])[0]) \
        is None


def _ctc_case():
    """Ties (last max wins), repeats (dedup before blank), blanks."""
    v = 5
    probs = np.full((3, 7, v), 0.01, np.float32)
    seq = [[1, 1, 0, 1, 2, 2, 0], [3, 0, 3, 3, 4, 0, 4], [0, 0, 0, 0, 0, 0, 0]]
    for b, s in enumerate(seq):
        for t, c in enumerate(s):
            probs[b, t, c] = 0.5 + 0.01 * t
    probs[0, 6, 2] = probs[0, 6, 4] = 0.9        # tie: index 4 must win
    probs[1, 1, 1] = probs[1, 1, 0]              # tie with blank: 1 wins
    return probs


def test_ctc_greedy_and_pack_match_jax():
    probs = _ctc_case()
    jraw = jctc.ctc_greedy_decode(jnp.asarray(probs))
    raw = ctc.ctc_greedy_decode(_t(probs))
    np.testing.assert_array_equal(raw.indices.numpy(), np.asarray(jraw.indices))
    np.testing.assert_array_equal(raw.keep.numpy(), np.asarray(jraw.keep))
    np.testing.assert_array_equal(raw.probs.numpy(), np.asarray(jraw.probs))
    assert raw.indices[0, 6] == 4 and raw.indices[1, 1] == 1
    packed = ctc.pack_ctc_raw(raw)
    assert packed.shape == (3, 7, 6) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jctc.pack_ctc_raw(jraw)))
    for a, b in zip(ctc.unpack_ctc_raw(packed.numpy()),
                    jctc.unpack_ctc_raw(np.asarray(jctc.pack_ctc_raw(jraw)))):
        np.testing.assert_array_equal(a, b)


def test_ctc_decoder_matches_jax_and_pad_rows():
    probs = _ctc_case()
    packed = ctc.pack_ctc_raw(ctc.ctc_greedy_decode(_t(probs))).numpy()
    # a merged fetch pads short rows with 0xFF: index −1, never kept
    padded = np.concatenate([packed, np.full((3, 2, 6), 255, np.uint8)], 1)
    raw = ctc.unpack_ctc_raw(padded)
    assert not raw[2][:, 7:].any()
    chars = list("abcd")
    ours = ctc.CTCLabelDecoder(chars, use_space_char=False)
    theirs = jctc.CTCLabelDecoder(chars, use_space_char=False)
    assert ours.decode_with_positions(raw) == \
        theirs.decode_with_positions(jctc.unpack_ctc_raw(padded))
    assert [t for t, _, _ in ours.decode_with_positions(raw)] == \
        ["aabd", "cacdd", ""]

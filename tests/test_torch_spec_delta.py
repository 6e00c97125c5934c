"""The shared decoder's entry points and the hybrid gated-delta family
(OvisOCR2) against the JAX package's, on the CPU; the verify block
against sequential decode steps; the delta rule's per-step states
against prefix recomputation (the rollback invariant of
``vl/speculative.py``).

Weights as in ``test_torch_vl_families.py``. Float32 results within
1e-4 · max(1, max|ref|); ids and texts identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.vl import families as jfam
from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.vl import decoder, gated_delta
from oar_ocr_tpu_torch.vl.kv_cache import KVCache
from test_torch_vl_families import _img, make_pair
from torch_jax_tree import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got.astype(np.float32) - ref).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), err


def test_delta_per_step_states_match_prefix():
    rng = np.random.default_rng(0)
    b, h, t, dk, dv = 2, 3, 7, 4, 5
    q, k = (torch.from_numpy(rng.normal(size=(b, h, t, dk)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(b, h, t, dv)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 1, (b, h, t)).astype(np.float32))
    bt = torch.from_numpy(rng.uniform(0, 1, (b, h, t)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(size=(b, h, dk, dv)).astype(np.float32))
    out, states = gated_delta.gated_delta_rule(q, k, v, a, bt, s0,
                                               return_all_states=True)
    for j in (0, 3, t - 1):
        out_j, s_j = gated_delta.gated_delta_rule(
            q[:, :, :j + 1], k[:, :, :j + 1], v[:, :, :j + 1],
            a[:, :, :j + 1], bt[:, :, :j + 1], s0, return_state=True)
        assert torch.equal(states[:, j], s_j)
        assert torch.equal(out[:, :, :j + 1], out_j)


@pytest.fixture(scope="module")
def ovis():
    return make_pair("ovisocr2")


def _caches(cfg, b, cap, pad):
    c = cfg.decoder
    ours = KVCache.create(c.layers, b, c.kv_heads, cap, c.head_dim,
                          dtype=torch.float32, device=CPU)
    ours.with_pad(torch.tensor(pad, dtype=torch.int32))
    ref = JKVCache.create(c.layers, b, c.kv_heads, cap, c.head_dim,
                          dtype=jnp.float32).with_pad(jnp.asarray(pad))
    return ours, ref


def _same_cache(ours, ref, upto):
    _close(ours.k[:, :, :, :upto], ref.k[:, :, :, :upto])
    _close(ours.v[:, :, :, :upto], ref.v[:, :, :, :upto])
    assert ours.length.tolist() == np.asarray(ref.length).tolist()


def _jit(ref, method, **kw):
    return jax.jit(functools.partial(ref.module.apply, method=getattr(
        jfam.FamilyModule, method), **kw))


def test_decoder_entry_points_match_jax(ovis):
    """prefill (left-padded rows neutralised in the delta folds), three
    decode steps carrying the delta state, a causal and a bidirectional
    block and logits_for, on the hybrid stack (delta, delta, delta, attn
    cycled over two layers: delta, delta)."""
    ours, ref = ovis
    lm = ours.module.lm
    cfg = ours.cfg
    rng = np.random.default_rng(1)
    b, t, cap = 2, 9, 32
    emb = rng.standard_normal((b, t, cfg.decoder.hidden)).astype(np.float32)
    pids = np.broadcast_to(np.arange(t, dtype=np.int32), (3, b, t)).copy()
    pad = [0, 3]
    cache, jcache = _caches(cfg, b, cap, pad)
    causal = torch.ones((t, t), dtype=torch.bool).tril()
    keys = torch.arange(t)[None, :] >= torch.tensor(pad)[:, None]
    full = torch.cat([(causal[None] & keys[:, None, :])[:, None],
                      torch.zeros((b, 1, t, cap - t), dtype=torch.bool)], -1)
    pm = keys
    with torch.inference_mode():
        logits, hidden, ds = lm.prefill(torch.from_numpy(emb),
                                        torch.from_numpy(pids), cache, full,
                                        pad_mask=pm)
    jl, jh, jcache, jds = _jit(ref, "prefill")(
        ref.params, jnp.asarray(emb), jnp.asarray(pids), jcache,
        jnp.asarray(full.numpy()), jnp.zeros_like(jnp.asarray(ds.numpy())),
        pad_mask=jnp.asarray(pm.numpy()))
    _close(logits, jl)
    _close(hidden, jh)
    _close(ds, jds)
    cache.advance(t)
    jcache = jcache.advance(t)
    _same_cache(cache, jcache, t)
    tok = logits.argmax(-1).to(torch.int32)
    jstep = _jit(ref, "decode_step")
    for i in range(3):
        p = torch.full((3, b, 1), t + i, dtype=torch.int32)
        with torch.inference_mode():
            lg, hd, ds = lm.decode_step(tok, p, cache, t + i, ds)
        jlg, jhd, jcache, jds = jstep(ref.params, jnp.asarray(tok.numpy()),
                                      jnp.asarray(p.numpy()), jcache, t + i,
                                      jds)
        _close(lg, jlg)
        _close(hd, jhd)
        _close(ds, jds)
        tok = lg.argmax(-1).to(torch.int32)
    _same_cache(cache, jcache, t + 3)
    block = rng.integers(0, cfg.decoder.vocab_size, (b, 4)).astype(np.int32)
    bp = np.broadcast_to((t + 3 + np.arange(4, dtype=np.int32)),
                         (3, b, 4)).copy()
    for method in ("decode_block", "decode_block_bidir"):
        c2, jc2 = cache.keep_indices([0, 1]), jcache
        with torch.inference_mode():
            lg, hd = getattr(lm, method)(torch.from_numpy(block),
                                         torch.from_numpy(bp), c2, t + 3)
        jlg, jhd, jc2 = _jit(ref, method)(ref.params, jnp.asarray(block),
                                          jnp.asarray(bp), jc2, t + 3)
        _close(lg, jlg)
        _close(hd, jhd)
        _same_cache(c2, jc2, t + 7)
        _close(lm.logits_for(hd), jlg)


def test_aux_entry_points_match_jax():
    """prefill_aux and decode_block_aux (the DFlash taps) on the
    HunyuanOCR family's XDRoPE stack."""
    ours, ref = make_pair("hunyuanocr", seed=2)
    lm, cfg = ours.module.lm, ours.cfg
    taps = ours.module.aux_taps()
    rng = np.random.default_rng(2)
    t, cap = 7, 16
    emb = rng.standard_normal((1, t, cfg.decoder.hidden)).astype(np.float32)
    pids = np.broadcast_to(np.arange(t, dtype=np.int32), (3, 1, t)).copy()
    cache, jcache = _caches(cfg, 1, cap, [0])
    full = torch.cat([torch.ones((t, t), dtype=torch.bool).tril()[None,
                                                                  None],
                      torch.zeros((1, 1, t, cap - t), dtype=torch.bool)], -1)
    with torch.inference_mode():
        lg, hd, aux = lm.prefill_aux(torch.from_numpy(emb),
                                     torch.from_numpy(pids), cache, full,
                                     taps)
    jlg, jhd, jcache, jaux = _jit(ref, "prefill_aux")(
        ref.params, jnp.asarray(emb), jnp.asarray(pids), jcache,
        jnp.asarray(full.numpy()))
    for a, b_ in ((lg, jlg), (hd, jhd), (aux, jaux)):
        _close(a, b_)
    assert aux.shape[-1] == cfg.decoder.hidden * len(taps)
    cache.advance(t)
    jcache = jcache.advance(t)
    block = np.asarray([[5, 6, 7, 8]], np.int32)
    bp = np.broadcast_to(t + np.arange(4, dtype=np.int32), (3, 1, 4)).copy()
    with torch.inference_mode():
        lg, hd, aux = lm.decode_block_aux(torch.from_numpy(block),
                                          torch.from_numpy(bp), cache, t,
                                          taps)
    jlg, jhd, jcache, jaux = _jit(ref, "decode_block_aux")(
        ref.params, jnp.asarray(block), jnp.asarray(bp), jcache, t)
    for a, b_ in ((lg, jlg), (hd, jhd), (aux, jaux)):
        _close(a, b_)
    _same_cache(cache, jcache, t + 4)


def test_verify_block_equals_sequential_steps(monkeypatch):
    """The causal block's logits at each position are the logits of
    feeding the same tokens one decode step at a time (GLM-OCR's
    attention-only stack), and its kernel sites are one forward's."""
    ours, _ = make_pair("glmocr", seed=4)
    lm, cfg = ours.module.lm, ours.cfg
    e, p, vl, t = ours._build_inputs([_img(2)], "ocr")
    toks = torch.tensor([[9, 40, 41, 42]], dtype=torch.int32)
    start = p.amax(dim=(0, 2)) + 1

    def fresh():
        c, full, _ = ours._new_cache(e, vl, 64)
        with torch.inference_mode():
            lm.prefill(e, p, c, full)
        return c.advance(t)

    c = fresh()
    calls = []
    real = fnr.fused_add_rmsnorm
    monkeypatch.setattr(decoder, "fused_add_rmsnorm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        block, _ = lm.decode_block(
            toks, (start + torch.arange(4))[None, None].expand(3, 1, 4), c, t)
    assert len(calls) == 2 * cfg.decoder.layers
    c = fresh()
    for j in range(4):
        with torch.inference_mode():
            lg, _, _ = lm.decode_step(toks[:, j], (start + j)[None, :, None]
                                      .expand(3, 1, 1), c, t + j)
        _close(block[:, j], lg.numpy())


def test_ovis_parse_and_batch_match(ovis):
    """Markdown through both packages, and an unequal left-padded batch
    through the delta stack equal to each image alone."""
    ours, ref = ovis
    img, img2 = _img(), _img(3, 32, 48)
    batch = ours.generate([img, img2], "markdown", max_new_tokens=6)
    assert batch == ref.generate([img, img2], "markdown", max_new_tokens=6)
    assert batch == [ours.generate([im], "markdown", max_new_tokens=6)[0]
                     for im in (img, img2)]
    for keep in (False, True):
        assert ours.parse([img], max_new_tokens=5, keep_image_tags=keep) == \
            ref.parse([img], max_new_tokens=5, keep_image_tags=keep)

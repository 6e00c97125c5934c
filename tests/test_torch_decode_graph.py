"""The port's decode loop on static buffers against the JAX package.

The KV cache at a device-scalar position and K4's plain version with a
device slot against the int path and the JAX cache's
``lax.dynamic_update_slice`` (bit-equal); the step body of
``vl/decode_graph.py``, run eagerly on the CPU (the plain version of the
captured graph), against the JAX ``jit(scan)`` programs on the tiny
configs of both VL models, float32: the same ids, and each step's logits
within 1e-4 of max|logit| of the JAX scan body's; a static cache reused
by a shorter request; the launch accounting of a captured graph. The
graph against the eager step, and K4's kernel with the device slot, need
a card: ``tests/test_torch_decode_graph_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.weights import flatten_params
from oar_ocr_tpu.vl import attention as jatt
from oar_ocr_tpu.vl import hunyuan as jhy
from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache
from oar_ocr_tpu.vl.model import PaddleOCRVL as JPaddleOCRVL
from oar_ocr_tpu.vl.paddleocr_vl import PaddleOCRVLModule
from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.ops import cuda_build
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import (hunyuan_params_from_jax,
                                               vl_params_from_jax)
from oar_ocr_tpu_torch.vl import PaddleOCRVL, PaddleOCRVLConfig
from oar_ocr_tpu_torch.vl import hunyuan as hy
from oar_ocr_tpu_torch.vl.kv_cache import KVCache, decoder_cache_capacity

VL_CFG = PaddleOCRVLConfig().tiny()
# the tiny HunyuanOCR config with its special ids inside the vocabulary,
# as tests/test_torch_hunyuan.py takes it
_IDS = dict(bos_id=1, eos_id=2, image_start_id=500, image_end_id=501,
            image_token_id=502)
HY_CFG = dataclasses.replace(hy.HunyuanOCRConfig().tiny(), **_IDS)
J_HY_CFG = dataclasses.replace(jhy.HunyuanOCRConfig().tiny(), **_IDS)
TOL = 1e-4
CPU = torch.device("cpu")


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (60, 90, 3), np.uint8),
            rng.integers(0, 256, (120, 56, 3), np.uint8),
            rng.integers(0, 256, (40, 28, 3), np.uint8)]


def _f32_runtime():
    return JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))


@pytest.fixture(scope="module")
def vl_pair():
    jvlm = JPaddleOCRVL(cfg=VL_CFG, runtime=_f32_runtime())
    ours = PaddleOCRVL(vl_params_from_jax(flatten_params(jvlm.params)),
                       cfg=VL_CFG, runtime=Runtime("float32", device="cpu"))
    step = jax.jit(lambda p, tok, pids, cache, pos: jvlm.module.apply(
        p, tok, pids, cache, pos, method=PaddleOCRVLModule.decode_step))
    return jvlm, ours, step


@pytest.fixture(scope="module")
def hy_pair():
    jm = jhy.HunyuanOCRModel(cfg=J_HY_CFG, seed=3, runtime=_f32_runtime())
    ours = hy.HunyuanOCRModel(hunyuan_params_from_jax(
        flatten_params(jm.params)), cfg=HY_CFG,
        runtime=Runtime("float32", device="cpu"))
    step = jax.jit(lambda p, tok, pids, cache, pos: jm.module.apply(
        p, tok, pids, cache, pos, method=jhy.HunyuanOCRModule.decode_step))
    return jm, ours, step


def _close_rows(got, ref):
    """Each step's logits within TOL of max|logit| of the JAX step's."""
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and np.isfinite(r).all()
        assert float(np.abs(g - r).max()) <= TOL * float(np.abs(r).max())


# ------------------------- the KV cache and K4 -------------------------

# (tokens, position): inside the cache, its last slot, and starts past
# the end, which the device path clamps to capacity − tokens as
# lax.dynamic_update_slice does
@pytest.mark.parametrize("t,pos", [(1, 0), (1, 5), (3, 4), (1, 8), (3, 7)])
def test_kv_cache_device_position_matches_int_and_jax(t, pos):
    rng = np.random.default_rng(pos + 10 * t)
    b, h, cap, d = 2, 2, 8, 4
    kv = [rng.standard_normal((b, h, t, d)).astype(np.float32)
          for _ in range(2)]
    base = [rng.standard_normal((2, b, h, cap, d)).astype(np.float32)
            for _ in range(2)]

    def cache():
        zeros = torch.zeros((b,), dtype=torch.int32)
        return KVCache(*(torch.from_numpy(a.copy()) for a in base), zeros,
                       zeros.clone())

    dev = cache().append(1, *(torch.from_numpy(a) for a in kv),
                         torch.tensor(pos))
    jc = JKVCache(*(jnp.asarray(a) for a in base),
                  jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32))
    jc = jc.append(1, *(jnp.asarray(a) for a in kv), jnp.int32(pos))
    np.testing.assert_array_equal(dev.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(dev.v.numpy(), np.asarray(jc.v))
    if pos + t <= cap:
        ref = cache().append(1, *(torch.from_numpy(a) for a in kv), pos)
        assert torch.equal(dev.k, ref.k) and torch.equal(dev.v, ref.v)
        # k_slot: a kernel given the slot writes the whole layer's k
        target = cache()
        whole = target.k_slot(1, torch.tensor(pos), t)
        assert whole.data_ptr() == target.k[1].data_ptr()
        assert whole.shape == (b, h, cap, d)


def test_kv_cache_position_forms():
    """A per-row position vector writes each row at its own slot, as the
    JAX cache's vmapped write, and K4's ``k_slot`` gives the whole layer
    for one (the kernel reads each row's slot); a device position is a
    0-d int64 tensor; ``reset`` empties in place."""
    from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache

    cache = KVCache.create(1, 2, 1, 4, 2, dtype=torch.float32, device=CPU)
    kv = torch.arange(8, dtype=torch.float32).reshape(2, 1, 2, 2)
    ref = JKVCache.create(1, 2, 1, 4, 2, dtype=jnp.float32)
    for pos in ([1, 2], [3, 0]):
        cache.append(0, kv, kv + 1, torch.tensor(pos))
        ref = ref.append(0, jnp.asarray(kv.numpy()),
                         jnp.asarray(kv.numpy() + 1), jnp.asarray(pos))
        assert torch.equal(cache.k, torch.from_numpy(np.array(ref.k)))
        assert torch.equal(cache.v, torch.from_numpy(np.array(ref.v)))
        whole = cache.k_slot(0, torch.tensor(pos), 1)
        assert whole.data_ptr() == cache.k[0].data_ptr()
        assert whole.shape == cache.k[0].shape
    with pytest.raises(InvalidInputError):
        cache.append(0, kv, kv, torch.tensor([1]))
    with pytest.raises(InvalidInputError):
        cache.append(0, kv, kv, torch.tensor(1, dtype=torch.int32))
    with pytest.raises(InvalidInputError):
        cache.append(0, torch.ones((2, 1, 5, 2)), torch.ones((2, 1, 5, 2)),
                     torch.tensor(0))
    pad, length = cache.pad, cache.length
    cache.advance(3).with_pad(torch.tensor([1, 0]))
    cache.reset(torch.tensor([2, 1]))
    assert cache.pad is pad and cache.length is length
    assert cache.pad.tolist() == [2, 1] and cache.length.tolist() == [0, 0]


@pytest.mark.parametrize("b,t,pos", [(1, 1, 6), (2, 1, 0), (2, 3, 2),
                                     (1, 3, 11)])
def test_qk_norm_rope_qk_slot_matches_int_slot(b, t, pos):
    """K4's plain version and its CPU wrapper with the device slot write
    the same k, at the same slots, as the int slot's view (bit-equal);
    a start past the end clamps as the KV cache's does."""
    rng = np.random.default_rng(b * 7 + t + pos)
    hq, hk, d, cap = 4, 2, 16, 12
    q, k = (torch.from_numpy(rng.standard_normal((b, t, h, d))
                             .astype(np.float32)) for h in (hq, hk))
    qs, ks = (torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
              for _ in range(2))
    ang = rng.uniform(0.0, 20.0, (b, t, d // 2))
    cos, sin = (torch.from_numpy(f(ang).astype(np.float32))
                for f in (np.cos, np.sin))
    at = min(pos, cap - t)
    want = torch.zeros((b, hk, cap, d))
    want_q = fnr.qk_norm_rope_qk_ref(q, k, qs, ks, cos, sin,
                                     k_out=want[:, :, at:at + t], eps=1e-5)
    for fn in (fnr.qk_norm_rope_qk_ref, fnr.fused_qk_norm_rope_qk):
        got = torch.zeros((b, hk, cap, d))
        got_q = fn(q, k, qs, ks, cos, sin, k_out=got, slot=torch.tensor(pos),
                   eps=1e-5)
        assert torch.equal(got_q, want_q) and torch.equal(got, want)
    with pytest.raises(InvalidInputError):
        fnr.fused_qk_norm_rope_qk(q, k, qs, ks, cos, sin, k_out=got,
                                  slot=torch.tensor(pos, dtype=torch.int32))


def test_captured_launches_follow_replays():
    """A capture records its launches without running them: they leave
    the kernels' counts, and every replay adds them back."""
    a, b = cuda_build.KERNELS[:2]
    counts = (a.launches, b.launches)
    launches = cuda_build.CapturedLaunches()
    try:
        with launches.recording():
            a.launches += 3          # what wrappers count while capturing
            b.launches += 1
        assert (a.launches, b.launches) == counts
        assert launches.counts == {a: 3, b: 1}
        launches.replayed()
        launches.replayed()
        assert (a.launches, b.launches) == (counts[0] + 6, counts[1] + 2)
    finally:
        a.launches, b.launches = counts


# ------------------------- PaddleOCR-VL decode -------------------------

def _vl_request(ours, images):
    batch = ours.prepare_vision(images, "ocr")
    prompts = ours.build_prompts(batch, "ocr")
    return ours.fuse_embeds(prompts, ours.encode_vision(batch)), prompts


def _jax_vl_decode(jvlm, step, embeds, prompts, max_new, capacity):
    """The JAX prefill and ``max_new`` scan-body steps
    (``model.py:179-211``), unrolled to keep each step's logits."""
    c = VL_CFG
    b, t = prompts.ids.shape
    vl = jnp.asarray(prompts.valid_lengths)
    positions = jnp.asarray(prompts.positions)
    cache = JKVCache.create(c.layers, b, c.kv_heads, capacity, c.head_dim,
                            dtype=jnp.float32).with_pad(t - vl)
    full = jatt.combine_masks(jatt.create_causal_mask(t),
                              jatt.create_left_padding_mask(vl, t))
    full = jnp.concatenate([jnp.broadcast_to(full, (b, 1, t, t)),
                            jnp.zeros((b, 1, t, capacity - t), bool)], -1)
    logits, cache = jvlm.module.apply(jvlm.params, jnp.asarray(embeds),
                                      positions, cache, full,
                                      method=PaddleOCRVLModule.prefill)
    cache = cache.advance(t)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    done, npos, steps = tok == c.eos_id, jnp.max(positions, (0, 2)) + 1, []
    for i in range(max_new):
        pids = jnp.broadcast_to(npos[None, :, None], (3, b, 1))
        logits, cache = step(jvlm.params, tok, pids, cache, jnp.int32(t + i))
        steps.append(logits)
        nxt = jnp.where(done, c.eos_id,
                        jnp.argmax(logits, -1).astype(jnp.int32))
        done, tok, npos = done | (nxt == c.eos_id), nxt, npos + 1
    return steps


@pytest.mark.parametrize("images", [slice(0, 1), slice(0, 2)],
                         ids=["B1", "B2-left-padded"])
def test_vl_eager_step_matches_jax_scan(vl_pair, images):
    jvlm, ours, step = vl_pair
    embeds, prompts = _vl_request(ours, _images(5)[images])
    max_new = 6
    capacity = decoder_cache_capacity(prompts.ids.shape[1], max_new)
    steps = []
    ids, _ = ours.prefill_decode(
        embeds, torch.from_numpy(prompts.positions),
        torch.from_numpy(prompts.valid_lengths), max_new=max_new,
        capacity=capacity, step_logits=steps)
    ref = jvlm._prefill_decode(
        jvlm.params, jnp.asarray(embeds.numpy()),
        jnp.asarray(prompts.positions), jnp.asarray(prompts.valid_lengths),
        max_new=max_new, capacity=capacity)
    assert ids.numpy().tolist() == np.asarray(ref).tolist()
    assert int(ids[0, 0]) != VL_CFG.eos_id, "vacuous comparison"
    _close_rows(steps, _jax_vl_decode(jvlm, step, embeds.numpy(), prompts,
                                      max_new, capacity))


def test_vl_static_cache_reused_by_a_shorter_request(vl_pair):
    """A (batch, capacity) key's cache serves a longer prompt, then a
    shorter one, whose ids are still the JAX scan's."""
    jvlm, ours, _ = vl_pair
    imgs = _images(6)
    requests = [_vl_request(ours, [im]) for im in imgs]
    lengths = [p.ids.shape[1] for _, p in requests]
    order = sorted(range(len(imgs)), key=lambda i: -lengths[i])
    assert lengths[order[0]] > lengths[order[-1]]
    capacity, max_new, key = 256, 5, (1, 256, torch.float32)
    first = None
    for i in order:
        embeds, prompts = requests[i]
        ids, _ = ours.prefill_decode(
            embeds, torch.from_numpy(prompts.positions),
            torch.from_numpy(prompts.valid_lengths), max_new=max_new,
            capacity=capacity)
        ref = jvlm._prefill_decode(
            jvlm.params, jnp.asarray(embeds.numpy()),
            jnp.asarray(prompts.positions),
            jnp.asarray(prompts.valid_lengths), max_new=max_new,
            capacity=capacity)
        assert ids.numpy().tolist() == np.asarray(ref).tolist()
        first = first or ours.decode_graphs.states[key]
        assert ours.decode_graphs.states[key] is first


def test_decode_past_the_capacity_raises(vl_pair):
    _, ours, _ = vl_pair
    embeds, prompts = _vl_request(ours, _images(5)[:1])
    t = prompts.ids.shape[1]
    with pytest.raises(InvalidInputError):
        ours.prefill_decode(embeds, torch.from_numpy(prompts.positions),
                            torch.from_numpy(prompts.valid_lengths),
                            max_new=256 - t + 1, capacity=256)


# -------------------------- HunyuanOCR decode --------------------------

def _hy_batch(ours, b, seed):
    """``b`` rows of random ids with distinct per-axis XDRoPE positions
    (as ``test_batched_decoder_matches_jax``)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, HY_CFG.vocab_size, (b, 9)).astype(np.int32)
    pids = np.broadcast_to(np.arange(9, dtype=np.int32)[None, None],
                           (4, b, 9)).copy()
    pids[1] += 1
    pids[2] += 2
    pids[3] = 0
    with torch.inference_mode():
        embeds = ours.net.model.embed_tokens(torch.from_numpy(ids))
    return embeds, pids


def _jax_hy_decode(jm, step, embeds, pids, max_new, capacity):
    """The JAX prefill and ``max_new`` scan-body steps
    (``hunyuan.py:460-490``), unrolled to keep each step's logits."""
    c = HY_CFG
    b, t = embeds.shape[:2]
    cache = JKVCache.create(c.layers, b, c.kv_heads, capacity, c.head_dim,
                            dtype=jnp.float32)
    full = jnp.concatenate(
        [jnp.broadcast_to(jatt.create_causal_mask(t), (b, 1, t, t)),
         jnp.zeros((b, 1, t, capacity - t), bool)], -1)
    logits, _, cache = jm.module.apply(jm.params, jnp.asarray(embeds),
                                       jnp.asarray(pids), cache, full,
                                       method=jhy.HunyuanOCRModule.prefill)
    cache = cache.advance(t)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    done, steps = tok == c.eos_id, []
    for i in range(max_new):
        p = jnp.broadcast_to(jnp.int32(t + i), (4, b, 1))
        logits, _, cache = step(jm.params, tok, p, cache, jnp.int32(t + i))
        steps.append(logits)
        nxt = jnp.where(done, c.eos_id,
                        jnp.argmax(logits, -1).astype(jnp.int32))
        done, tok = done | (nxt == c.eos_id), nxt
    return steps


@pytest.mark.parametrize("b", [1, 2])
def test_hunyuan_eager_step_matches_jax_scan(hy_pair, b):
    jm, ours, step = hy_pair
    embeds, pids = _hy_batch(ours, b, 3 + b)
    max_new, capacity = 6, 256
    steps = []
    ids, _ = ours.prefill_decode(embeds, torch.from_numpy(pids),
                                 max_new=max_new, capacity=capacity,
                                 step_logits=steps)
    ref = jm._gen(jm.params, jnp.asarray(embeds.numpy()), jnp.asarray(pids),
                  max_new=max_new, capacity=capacity)
    assert ids.numpy().tolist() == np.asarray(ref).tolist()
    _close_rows(steps, _jax_hy_decode(jm, step, embeds.numpy(), pids,
                                      max_new, capacity))


def test_hunyuan_static_cache_reused_by_a_shorter_request(hy_pair):
    jm, ours, _ = hy_pair
    max_new, prompts = 5, []
    for img in _images(7):
        patches, gh, gw = ours.prepare_image(img)
        ids, pids, _ = ours.build_prompt(gh, gw, "OCR:")
        prompts.append((ours.fuse_embeds(ids, ours.encode_image(
            patches, ours.position_rows(gh, gw), gh, gw)), pids))
    prompts.sort(key=lambda p: -p[1].shape[1])
    assert prompts[0][1].shape[1] > prompts[-1][1].shape[1]
    key, first = (1, 256, torch.float32), None
    for embeds, pids in prompts:
        got, _ = ours.prefill_decode(embeds, torch.from_numpy(pids)[:, None],
                                     max_new=max_new, capacity=256)
        ref = jm._gen(jm.params, jnp.asarray(embeds.numpy()),
                      jnp.asarray(pids)[:, None, :], max_new=max_new,
                      capacity=256)
        assert got.numpy().tolist() == np.asarray(ref).tolist()
        first = first or ours.decode_graphs.states[key]
        assert ours.decode_graphs.states[key] is first

"""The port's VL decode mechanisms against the JAX package's, on the CPU:
the KV cache's rollback and fork methods and per-row writes, the paged
KV cache, speculative verification and drafting, the gated delta rule
(scan, chunked, step), the SDAR diffusion schedule and the sampling
helpers.

The same inputs, made from a seed with numpy, go through both functions.
Integer results (ids, accept counts, lengths, cache contents written by
copies) must be identical; float32 results within
1e-4 · max(1, max|ref|), the rounding of sums taken in another order.
``sample_with_confidence`` draws with a ``torch.Generator``, so its
random tokens are checked by property, not against JAX's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.vl import diffusion as j_diff
from oar_ocr_tpu.vl import gated_delta as j_gd
from oar_ocr_tpu.vl import kv_cache as j_kv
from oar_ocr_tpu.vl import paged_kv as j_paged
from oar_ocr_tpu.vl import sampling as j_samp
from oar_ocr_tpu.vl import speculative as j_spec
from oar_ocr_tpu_torch.vl import diffusion, gated_delta, kv_cache, paged_kv
from oar_ocr_tpu_torch.vl import sampling, speculative

CPU = torch.device("cpu")


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got.astype(np.float32) - ref).max()) if ref.size else 0
    assert err <= 1e-4 * max(1.0, float(np.abs(ref).max()) if ref.size
                             else 1.0), err


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------ gated delta ------------------------------

def _delta_inputs(seed, b, h, t, dk, dv, state=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, dk)).astype(np.float32)
    k = (rng.standard_normal((b, h, t, dk)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, h, t, dv)).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.standard_normal((b, h, t))))).astype(np.float32)
    be = (1 / (1 + np.exp(-rng.standard_normal((b, h, t))))).astype(
        np.float32)
    s0 = (rng.standard_normal((b, h, dk, dv)) * 0.2).astype(np.float32) \
        if state else None
    return q, k, v, a, be, s0


def test_delta_rule_matches_naive_recurrence():
    q, k, v, a, be, _ = _delta_inputs(0, 1, 2, 5, 4, 3, state=False)
    out = gated_delta.gated_delta_rule(*map(_t, (q, k, v, a, be))).numpy()
    ref = np.zeros((1, 2, 5, 3), np.float32)
    for hi in range(2):
        s = np.zeros((4, 3), np.float32)
        for ti in range(5):
            kt = k[0, hi, ti]
            s = a[0, hi, ti] * (s - be[0, hi, ti] * np.outer(kt, kt @ s))
            s = s + be[0, hi, ti] * np.outer(kt, v[0, hi, ti])
            ref[0, hi, ti] = s.T @ q[0, hi, ti]
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 7, 4, 5), (1, 2, 1, 8, 8)])
def test_delta_rule_scan_matches_jax(shape):
    q, k, v, a, be, s0 = _delta_inputs(1, *shape)
    args = tuple(map(_t, (q, k, v, a, be)))
    o, s = gated_delta.gated_delta_rule(*args, _t(s0), return_state=True)
    jo, js = j_gd.gated_delta_rule(q, k, v, a, be, s0, return_state=True)
    _close(o, jo)
    _close(s, js)
    o2, states = gated_delta.gated_delta_rule(*args, _t(s0),
                                              return_all_states=True)
    jo2, jstates = j_gd.gated_delta_rule(q, k, v, a, be, s0,
                                         return_all_states=True)
    assert states.shape == (shape[0], shape[2], shape[1], shape[3],
                            shape[4])
    _close(o2, jo2)
    _close(states, jstates)
    _close(gated_delta.gated_delta_rule(*args), j_gd.gated_delta_rule(
        q, k, v, a, be))


@pytest.mark.parametrize("shape,chunk", [((2, 3, 37, 16, 24), 8),
                                         ((1, 2, 64, 32, 32), 64),
                                         ((2, 1, 130, 8, 8), 32)])
def test_delta_rule_chunked_matches_jax_and_scan(shape, chunk):
    q, k, v, a, be, s0 = _delta_inputs(2, *shape)
    args = tuple(map(_t, (q, k, v, a, be)))
    o, s = gated_delta.gated_delta_rule_chunked(*args, _t(s0), chunk=chunk,
                                                return_state=True)
    jo, js = j_gd.gated_delta_rule_chunked(q, k, v, a, be, s0, chunk=chunk,
                                           return_state=True)
    _close(o, jo)
    _close(s, js)
    so, ss = gated_delta.gated_delta_rule(*args, _t(s0), return_state=True)
    _close(o, so.numpy())
    _close(s, ss.numpy())


def test_delta_step_matches_jax_and_scan():
    q, k, v, a, be, s0 = _delta_inputs(3, 2, 2, 4, 3, 5)
    full = gated_delta.gated_delta_rule(*map(_t, (q, k, v, a, be)), _t(s0))
    s, js = _t(s0), jnp.asarray(s0)
    for ti in range(4):
        step = [x[:, :, ti] for x in (q, k, v, a, be)]
        s, o = gated_delta.gated_delta_step(s, *map(_t, step))
        js, jo = j_gd.gated_delta_step(js, *map(jnp.asarray, step))
        _close(o, jo)
        _close(s, js)
        _close(o, full[:, :, ti].numpy())


# ------------------------------ speculative ------------------------------

def _logits_for(targets, vocab=10):
    logits = np.full((1, len(targets), vocab), -5.0, np.float32)
    for i, t in enumerate(targets):
        logits[0, i, t] = 5.0
    return logits


@pytest.mark.parametrize("draft,targets,accepted", [
    ([5, 6, 7], [5, 6, 7, 8], 3),         # all accepted + bonus
    ([5, 6, 7], [5, 9, 7, 8], 1),         # corrected at position 1
    ([3], [4, 1], 0),                      # none accepted
])
def test_verify_draft_matches_jax(draft, targets, accepted):
    d = np.asarray([draft], np.int32)
    logits = _logits_for(targets)
    got = speculative.verify_draft(_t(d), _t(logits))
    ref = j_spec.verify_draft(jnp.asarray(d), jnp.asarray(logits))
    assert int(got.accepted[0]) == int(ref.accepted[0]) == accepted
    assert got.next_tokens.tolist() == np.asarray(ref.next_tokens).tolist()
    assert got.num_emitted.tolist() == np.asarray(ref.num_emitted).tolist()
    assert got.next_tokens.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_draft_random_batches_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((4, 6, 7)).astype(np.float32)
    target = logits.argmax(-1)
    drafts = np.where(rng.random((4, 5)) < 0.7, target[:, :5],
                      rng.integers(0, 7, (4, 5))).astype(np.int32)
    got = speculative.verify_draft(_t(drafts), _t(logits))
    ref = j_spec.verify_draft(jnp.asarray(drafts), jnp.asarray(logits))
    assert got.accepted.tolist() == np.asarray(ref.accepted).tolist()
    assert got.next_tokens.tolist() == np.asarray(ref.next_tokens).tolist()


def test_rollback_and_recurrent_draft():
    cache = kv_cache.KVCache.create(1, 1, 1, 16, 4, dtype=torch.float32,
                                    device=CPU).advance(10)
    assert speculative.rollback_cache(cache, 6).length.tolist() == [6]

    def step(h, tok):
        logits = torch.zeros((1, 10))
        logits[0, int(tok[0]) + 1] = 5.0
        return h + 1.0, logits

    drafts, state = speculative.recurrent_draft(
        step, speculative.MTPDraftState(torch.zeros((1, 4)),
                                        torch.tensor([2])), 3)

    def j_step(h, tok):
        return h + 1.0, jnp.zeros((1, 10)).at[0, tok[0] + 1].set(5.0)

    j_drafts, j_state = j_spec.recurrent_draft(
        j_step, j_spec.MTPDraftState(jnp.zeros((1, 4)), jnp.asarray([2])), 3)
    assert drafts.tolist() == np.asarray(j_drafts).tolist() == [[3, 4, 5]]
    assert state.hidden.tolist() == np.asarray(j_state.hidden).tolist()


@pytest.mark.parametrize("seq,k,n", [
    ([5, 6, 7, 8, 5, 6], 3, 2),           # continuation of the earlier gram
    ([1, 2, 9, 1, 2, 8, 1, 2], 2, 2),     # the most recent occurrence
    ([3, 4, 5, 6], 3, 2),                 # no match: the last token
    ([7, 7, 7, 7, 7], 4, 1),              # continuation past the history
    ([1], 2, 2),                          # shorter than the gram
])
def test_ngram_draft_matches_jax(seq, k, n):
    hist = np.full((2, 16), -1, np.int32)
    hist[0, :len(seq)] = seq
    hist[1, :3] = [9, 9, 9]
    length = np.asarray([len(seq), 3], np.int32)
    got = speculative.ngram_draft(_t(hist), _t(length), k=k, n=n)
    ref = j_spec.ngram_draft(jnp.asarray(hist), jnp.asarray(length), k=k,
                             n=n)
    assert got.tolist() == np.asarray(ref).tolist()
    assert (got >= 0).all()


# ------------------------------ diffusion ------------------------------

def test_transfer_schedule_matches_jax():
    for steps in (1, 3, 4, 8):
        for block in (4, 16, 32):
            got = [diffusion.transfer_count(s, steps, block)
                   for s in range(-1, steps)]
            assert got == [j_diff.transfer_count(s, steps, block)
                           for s in range(-1, steps)]
            assert got[-1] == block


@pytest.mark.parametrize("seed,threshold,min_transfer", [
    (0, 0.9, 1), (1, 0.2, 2), (2, 0.0, 3), (3, 1.1, 4)])
def test_unmask_step_matches_jax(seed, threshold, min_transfer):
    rng = np.random.default_rng(seed)
    tokens = np.where(rng.random((3, 8)) < 0.5, diffusion.MASK_ID,
                      rng.integers(0, 6, (3, 8))).astype(np.int32)
    logits = (rng.standard_normal((3, 8, 6)) * 3).astype(np.float32)
    logits[0, :4] = 0.0                  # tied confidences
    got = diffusion.unmask_step(_t(tokens), _t(logits),
                                confidence_threshold=threshold,
                                min_transfer=min_transfer)
    ref = j_diff.unmask_step(jnp.asarray(tokens), jnp.asarray(logits),
                             confidence_threshold=threshold,
                             min_transfer=min_transfer)
    assert got.tolist() == np.asarray(ref).tolist()


@pytest.mark.parametrize("steps,threshold", [(4, 0.5), (3, 0.99), (2, 0.0)])
def test_decode_block_matches_jax(steps, threshold):
    """The same predictor in both: logits a fixed function of the block's
    current tokens."""
    table = np.random.default_rng(5).standard_normal((8, 9, 6)).astype(
        np.float32) * 2

    def predictor(tokens):
        idx = (tokens.long() % 9 if isinstance(tokens, torch.Tensor)
               else tokens % 9)
        return (_t(table)[torch.arange(8), idx[0]][None]
                if isinstance(tokens, torch.Tensor)
                else jnp.asarray(table)[jnp.arange(8), idx[0]][None])

    got = diffusion.decode_block(predictor, 8, 1, num_steps=steps,
                                 confidence_threshold=threshold)
    ref = j_diff.decode_block(predictor, 8, 1, num_steps=steps,
                              confidence_threshold=threshold)
    assert got.tolist() == np.asarray(ref).tolist()
    assert (got != diffusion.MASK_ID).all()


# ------------------------------ sampling ------------------------------

@pytest.mark.parametrize("penalty", [1.3, 0.7])
def test_repetition_penalty_and_mask_match_jax(penalty):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 11)).astype(np.float32)
    hist = rng.integers(-1, 11, (3, 5)).astype(np.int32)
    got = sampling.apply_repetition_penalty(_t(logits), _t(hist), penalty, 11)
    _close(got, j_samp.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(hist), penalty, 11))
    for banned in ([], [0, 4], [10]):
        assert torch.equal(sampling.mask_token_ids(_t(logits), banned),
                           _t(np.asarray(j_samp.mask_token_ids(
                               jnp.asarray(logits), banned))))


def test_sample_with_confidence():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((4, 9)) * 2).astype(np.float32)
    tok, p = sampling.sample_with_confidence(_t(logits), temperature=0.0)
    j_tok, j_p = j_samp.sample_with_confidence(jnp.asarray(logits),
                                               jax.random.PRNGKey(0),
                                               temperature=0.0)
    assert tok.tolist() == np.asarray(j_tok).tolist()
    _close(p, j_p)
    # the same generator state draws the same tokens; each token lies in
    # the top-p nucleus and comes with its renormalised probability
    draws = [sampling.sample_with_confidence(
        _t(logits), torch.Generator().manual_seed(3), temperature=0.8,
        top_p=0.6) for _ in range(2)]
    assert torch.equal(draws[0][0], draws[1][0])
    probs = torch.softmax(_t(logits) / 0.8, -1)
    for row in range(4):
        ranked = probs[row].sort(descending=True)
        keep = int((ranked.values.cumsum(0) < 0.6).sum()) + 1
        nucleus = set(ranked.indices[:keep].tolist())
        assert int(draws[0][0][row]) in nucleus
        want = probs[row, draws[0][0][row]] / ranked.values[:keep].sum()
        assert abs(float(draws[0][1][row]) - float(want)) < 1e-5


@pytest.mark.parametrize("text", [
    "abcd" * 8, "hello " + "xyz1" * 7, "no loop here", "",
    "ab" * 40, "tail " + "0123456789" * 11])
def test_truncate_repetition_matches_jax(text):
    for kw in ({}, {"min_len": 10, "min_repeats": 10}):
        assert sampling.truncate_repetition(text, **kw) == \
            j_samp.truncate_repetition(text, **kw)


# ------------------------------ KV caches ------------------------------

def _kv_pair(seed, layers=2, batch=3, heads=2, cap=8, d=4):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((layers, batch, heads, cap, d)).astype(np.float32)
    v = rng.standard_normal((layers, batch, heads, cap, d)).astype(np.float32)
    length = np.asarray([5, 2, 7][:batch], np.int32)
    pad = np.asarray([0, 1, 2][:batch], np.int32)
    ours = kv_cache.KVCache(_t(k.copy()), _t(v.copy()), _t(length.copy()),
                            _t(pad.copy()))
    ref = j_kv.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
                       jnp.asarray(pad))
    return ours, ref


def _same_cache(ours, ref):
    for name in ("k", "v", "length", "pad"):
        assert np.array_equal(getattr(ours, name).numpy(),
                              np.asarray(getattr(ref, name))), name


@pytest.mark.parametrize("op", ["trim", "trim_tensor", "with_lengths",
                                "copy_row", "pad_batch", "pad_batch_same",
                                "keep", "keep_repeat"])
def test_kv_cache_methods_match_jax(op):
    ours, ref = _kv_pair(7)
    if op == "trim":
        got, want = ours.trim_to(3), ref.trim_to(3)
    elif op == "trim_tensor":
        got, want = ours.trim_to(torch.tensor(4)), ref.trim_to(jnp.int32(4))
    elif op == "with_lengths":
        got, want = (ours.with_lengths([1, 6, 3]),
                     ref.with_lengths(jnp.asarray([1, 6, 3])))
    elif op == "copy_row":
        got, want = ours.copy_row(0, 2, 4), ref.copy_row(0, 2, 4)
    elif op == "pad_batch":
        # the port pads into a larger cache's own buffers (``pad_into``)
        into = kv_cache.KVCache.create(2, 5, 2, 8, 4, dtype=torch.float32,
                                       device=torch.device("cpu"))
        into.k.fill_(3.0)                       # stale rows are zeroed
        got, want = ours.pad_into(into), ref.pad_batch(5)
        assert got is into
    elif op == "pad_batch_same":
        # padding to no more rows keeps the cache: into itself
        got, want = ours.pad_into(ours), ref.pad_batch(2)
        assert got is ours
    elif op == "keep":
        got, want = ours.keep_indices([2, 0]), ref.keep_indices(
            jnp.asarray([2, 0]))
    else:
        got, want = ours.keep_indices([1, 1, 1, 0]), ref.keep_indices(
            jnp.zeros((4,), jnp.int32).at[3].set(0).at[:3].set(1))
    _same_cache(got, want)


@pytest.mark.parametrize("pos,t", [([0, 3, 6], 1), ([1, 4, 2], 3),
                                   ([7, 0, 6], 2)])
def test_kv_cache_per_row_append_matches_jax(pos, t):
    """Each row writes at its own slot; a start past C − T is clamped, as
    the JAX vmapped dynamic_update_slice clamps."""
    ours, ref = _kv_pair(8)
    rng = np.random.default_rng(9)
    k_new = rng.standard_normal((3, 2, t, 4)).astype(np.float32)
    v_new = rng.standard_normal((3, 2, t, 4)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    ours.append(1, _t(k_new), _t(v_new), _t(p))
    want = ref.append(1, jnp.asarray(k_new), jnp.asarray(v_new),
                      jnp.asarray(p))
    _same_cache(ours, want)
    ours.append(0, None, _t(v_new), torch.tensor(pos))      # v alone
    want = want.append(0, want.k[0], jnp.asarray(v_new), jnp.asarray(p))
    assert np.array_equal(ours.v.numpy(), np.asarray(want.v))


def test_paged_kv_matches_jax_and_flat():
    rng = np.random.default_rng(0)
    ours = paged_kv.PagedKVCache.create(2, 2, 3, 4, 8, 5,
                                        dtype=torch.float32, device=CPU)
    ref = j_paged.PagedKVCache.create(2, 2, 3, 4, 8, 5, dtype=jnp.float32)
    flat = np.zeros((2, 2, 3, 32, 5), np.float32)
    pos = 0
    for t in (3, 8, 1, 9):
        k = rng.standard_normal((2, 3, t, 5)).astype(np.float32)
        v = rng.standard_normal((2, 3, t, 5)).astype(np.float32)
        for li in range(2):
            ours.append(li, _t(k + li), _t(v - li), pos)
            ref = ref.append(li, jnp.asarray(k + li), jnp.asarray(v - li),
                             pos)
            flat[li, :, :, pos:pos + t] = k + li
        ours.advance(t)
        ref = ref.advance(t)
        pos += t
    assert ours.length.tolist() == np.asarray(ref.length).tolist() == [21, 21]
    assert ours.pages_used().tolist() == np.asarray(
        ref.pages_used()).tolist() == [3, 3]
    assert np.array_equal(ours.k.numpy(), np.asarray(ref.k))
    assert np.array_equal(ours.v.numpy(), np.asarray(ref.v))
    for li in range(2):
        n = paged_kv.page_bucket(21, 8, 4)
        ck, cv = ours.view(n, li)
        jk, jv = ref.view(n, li)
        assert ck.shape == (2, 3, n * 8, 5)
        assert np.array_equal(ck.numpy(), np.asarray(jk))
        assert np.array_equal(cv.numpy(), np.asarray(jv))
        assert np.array_equal(ck.numpy()[:, :, :21], flat[li][:, :, :21])
    ours.trim_to(3)
    ref = ref.trim_to(3)
    assert ours.length.tolist() == np.asarray(ref.length).tolist()
    assert ours.pages_used().tolist() == [1, 1]
    # a write past the pool is clamped to its end, as in JAX
    k = np.ones((2, 3, 4, 5), np.float32)
    ours.append(0, _t(k), _t(k), 30)
    ref = ref.append(0, jnp.asarray(k), jnp.asarray(k), 30)
    assert np.array_equal(ours.k.numpy(), np.asarray(ref.k))


def test_page_bucket_matches_jax():
    for length in (1, 15, 16, 17, 40, 129, 10_000):
        for ps, pages in ((16, 64), (128, 32), (8, 3)):
            assert paged_kv.page_bucket(length, ps, pages) == \
                j_paged.page_bucket(length, ps, pages)


def test_paged_growth_across_buckets():
    """The context grows across page buckets 1 → 2 → 4 → 8 and every view
    holds what was written."""
    ps = 8
    cache = paged_kv.PagedKVCache.create(1, 1, 2, 8, ps, 4,
                                         dtype=torch.float32, device=CPU)
    rng = np.random.default_rng(0)
    flat = np.zeros((1, 2, 64, 4), np.float32)
    pos, seen = 0, set()
    for t in (5, 6, 9, 14, 17):
        k = rng.standard_normal((1, 2, t, 4)).astype(np.float32)
        cache.append(0, _t(k), _t(k), pos).advance(t)
        flat[:, :, pos:pos + t] = k
        pos += t
        b = paged_kv.page_bucket(pos, ps, 8)
        seen.add(b)
        ck, _ = cache.view(b, 0)
        assert ck.shape[2] == b * ps >= pos
        assert np.array_equal(ck.numpy()[:, :, :pos], flat[:, :, :pos])
    assert len(seen) >= 3

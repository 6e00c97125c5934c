"""HPD's fork rounds and SDAR's block-diffusion passes on their static
buffers, against the JAX package, on the CPU.

On the card these bodies replay as CUDA graphs (``vl/hpd_scheduler.
SlotPool``, one graph per (slots, k, capacity); ``vl/diffusion.
DiffusionBlocks``, a trial and a commit graph per (block length,
capacity); HPD-Parsing's children through the decode graph at per-row
slots). On the CPU the same bodies run eagerly: the plain version these
tests hold to the JAX package's jitted round, scan and passes, at the
tiny configs in float32, on the port's seeded weights in both packages.
The gates: ids, accept counts and cache lengths identical; the slots a
pass wrote the same; hidden states, K/V and logits within
1e-5 · max(1, max|ref|). The card side (graph against eager, bit for
bit) is ``tests/test_torch_hpd_diffusion_graph_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.vl import exact_models as jem
from oar_ocr_tpu.vl import families as jfam
from oar_ocr_tpu.vl.diffusion import unmask_step as j_unmask_step
from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache
from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.vl import families as fam
from oar_ocr_tpu_torch.vl.diffusion import MASK_ID
from oar_ocr_tpu_torch.vl.exact_models import _causal_prefill_mask
from oar_ocr_tpu_torch.vl.kv_cache import (KVCache, RowBuffers,
                                          decoder_cache_capacity)
from test_torch_hpd_scheduler import MAX_NEW, pair  # noqa: F401
from test_torch_vl_families import _img
from test_torch_vl_families import make_pair as family_pair
from torch_exact_common import imgs, make_pair
from torch_jax_tree import one_torch_thread  # noqa: F401

TOL = 1e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _jcache(cache: KVCache) -> JKVCache:
    return JKVCache(*(jnp.asarray(x.numpy().copy()) for x in
                      (cache.k, cache.v, cache.length, cache.pad)))


@pytest.fixture(scope="module")
def hpd_family():
    return family_pair("hpd_parsing")


@pytest.fixture(scope="module")
def diffusion_family():
    return family_pair("mineru_diffusion")


@pytest.fixture(scope="module")
def sdar_exact():
    return make_pair("mineru_diffusion_exact")


# ------------------------------ HPD rounds ------------------------------

def _hpd_prefix(ours, img):
    """The parse prompt's batch-1 prefill → (cache, first token, last
    hidden (1, H), prompt length)."""
    embeds, pids, t = ours.prepare_prompt(img, "Parse:")
    cap = decoder_cache_capacity(t + MAX_NEW, MAX_NEW)
    cache = ours.new_cache(1, cap)
    with torch.no_grad():
        logits, hidden, _, _ = ours.net.prefill_hidden_all(
            embeds, torch.as_tensor(pids).long(), cache,
            _causal_prefill_mask(1, t, cap, ours.device),
            *ours.empty_states(1))
    cache.advance(t)
    return cache, int(logits.argmax(-1)[0]), hidden[:, -1], t


@pytest.mark.parametrize("k", [0, 6])
def test_round_matches_jax_round_impl(pair, k):
    """One round over a pool of 4 slots — the parent advancing, a child
    just forked from it (fresh, hidden 0), a frozen branch (advance off)
    and a free slot — against JAX's jitted ``_round_impl`` on the same
    cache, hidden states and inputs: targets, accept counts and cache
    lengths identical, the same slots written, K/V and hidden close."""
    ours, ref, img = pair
    use_mtp = k > 0
    sched = ours.scheduler(use_mtp)
    jsched = getattr(ref, "_sched_mtp" if use_mtp else "_sched")
    prefix, first, h0, t = _hpd_prefix(ours, img)
    p = sched.pool(4, prefix.capacity, torch.float32, ours.device)
    with torch.inference_mode():
        prefix.pad_into(p.cache)
        p.cache.copy_row(0, 1, t - 2)               # the fork
        p.cache.copy_row(0, 2, t - 1)               # frozen
        g = torch.Generator().manual_seed(k)
        p.hidden.copy_(torch.randn(p.hidden.shape, generator=g))
        p.hidden[0] = h0[0]
        p.hidden[1] = 0.0
        p.hidden[3] = 0.0
    before = [x.numpy().copy() for x in (p.cache.k, p.cache.v)]
    jcache = _jcache(p.cache)
    jhidden = jnp.asarray(p.hidden.numpy().copy())
    staged = p.staging.numpy()
    staged[:] = 0
    staged[:, 0] = (first, 0, 1)
    staged[:, 1] = (sched.child_token_id, 1, 1)
    staged[:, 2] = (first, 0, 0)
    pending, fresh, adv = (jnp.asarray(staged[i].copy()) for i in range(3))
    targets, matched = sched.round(p, k)
    jt, jm, jc, jh = jsched._round(4, k)(
        ref.params, jsched.mtp_params, jcache, jhidden, pending,
        fresh.astype(bool), adv.astype(bool))
    assert targets.shape == (4, k + 1)
    np.testing.assert_array_equal(targets, np.asarray(jt))
    np.testing.assert_array_equal(matched, np.asarray(jm))
    np.testing.assert_array_equal(p.cache.length.numpy(),
                                  np.asarray(jc.length))
    assert p.cache.length.tolist()[1:] == [t - 1, t - 1, 0]
    for got, want, old in zip((p.cache.k, p.cache.v), (jc.k, jc.v), before):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy() != old, want != old)
        _close(got.numpy(), want)
    _close(p.hidden.numpy(), np.asarray(jh))


def test_pool_grows_in_jax_row_order():
    """``pad_into`` a pool of 2, then of 4: the rows in their order, then
    zero-filled, zero-length rows, bit for bit JAX's ``pad_batch``; the
    larger pools' buffers keep their addresses."""
    g = torch.Generator().manual_seed(3)
    one = KVCache.create(2, 1, 2, 16, 4, dtype=torch.float32,
                         device=torch.device("cpu"))
    one.k.copy_(torch.randn(one.k.shape, generator=g))
    one.v.copy_(torch.randn(one.v.shape, generator=g))
    one.length.fill_(9)
    one.pad.fill_(2)
    pools = [KVCache.create(2, n, 2, 16, 4, dtype=torch.float32,
                            device=torch.device("cpu")) for n in (2, 4)]
    for pool in pools:                    # stale rows from an earlier run
        pool.k.fill_(7.0)
        pool.length.fill_(5)
    ptrs = [[x.data_ptr() for x in (c.k, c.v, c.length, c.pad)]
            for c in pools]
    one.pad_into(pools[0]).copy_row(0, 1, 4).pad_into(pools[1])
    want = _jcache(one).pad_batch(2).copy_row(0, 1, 4).pad_batch(4)
    for got, ref in zip((pools[1].k, pools[1].v, pools[1].length,
                         pools[1].pad), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ptrs == [[x.data_ptr() for x in (c.k, c.v, c.length, c.pad)]
                    for c in pools]
    with pytest.raises(InvalidInputError):
        pools[1].pad_into(pools[0])


def _pool_ptrs(sched):
    return {key: [x.data_ptr() for x in (p.cache.k, p.cache.v,
                                         p.cache.length, p.cache.pad,
                                         p.hidden, p.inputs)]
            for key, p in sched.pools.items()}


def _rows_ptr(m, key):
    """The data address of the row buffer a pool's key views."""
    return m.slot_rows.buffers[key[1:]].k.data_ptr()


@pytest.mark.parametrize("use_mtp", [False, True])
def test_second_request_reuses_its_pools(pair, use_mtp):
    """Every pool a request grows through views the leading rows of the
    model's one row buffer of its capacity: after a request has sized
    the buffer, the next requests fork and grow through the same pools,
    no new key, every static buffer at its address, the same output,
    JAX's."""
    ours, ref, img = pair
    kw = dict(max_new_tokens=MAX_NEW, use_mtp=use_mtp,
              num_speculative_tokens=6)
    first = ours.parse_with_forks(img, **kw)
    assert ours.parse_with_forks(img, **kw) == first
    sched = ours.scheduler(use_mtp)
    ptrs = _pool_ptrs(sched)
    assert len(ptrs) >= 2                       # the pool grew
    assert all(p.cache.k.data_ptr() == _rows_ptr(ours, key)
               for key, p in sched.pools.items())
    held = ours.slot_rows.nbytes()
    again = ours.parse_with_forks(img, **kw)
    assert again == first
    assert _pool_ptrs(sched) == ptrs and ours.slot_rows.nbytes() == held
    assert again["stats"]["forked_branches"] >= 1
    want = ref.parse_with_forks(img, **kw)
    for key in ("parent", "children", "token_ids", "stats"):
        assert again[key] == want[key]


def test_pools_share_one_row_buffer(pair):
    """Both modes' schedulers take their pools' caches from the model's
    one buffer per capacity: a pool of more rows than the buffer
    replaces it by one of its rows and drops every pool on the old one,
    both schedulers'; a smaller pool then views the new buffer's leading
    rows; other capacities keep theirs."""
    ours = pair[0]
    greedy, mtp = ours.scheduler(False), ours.scheduler(True)
    assert greedy.rows is mtp.rows is ours.slot_rows
    f32, cpu = torch.float32, torch.device("cpu")
    cap = 1024                                  # no other test's capacity
    others = {k: b.k.data_ptr() for k, b in ours.slot_rows.buffers.items()}
    g2 = greedy.pool(2, cap, f32, cpu)
    m1 = mtp.pool(1, cap, f32, cpu)
    assert m1.cache.k.data_ptr() == g2.cache.k.data_ptr()
    assert greedy.pool(2, cap, f32, cpu) is g2
    g4 = greedy.pool(4, cap, f32, cpu)
    assert (2, cap, f32) not in greedy.pools
    assert (1, cap, f32) not in mtp.pools
    buf = ours.slot_rows.buffers[(cap, f32)]
    assert buf.k.shape[1] == 4 and g4.cache.k.data_ptr() == buf.k.data_ptr()
    m1 = mtp.pool(1, cap, f32, cpu)
    assert m1.cache.k.shape[1] == 1
    assert m1.cache.k.data_ptr() == buf.k.data_ptr()
    assert {k: b.k.data_ptr() for k, b in ours.slot_rows.buffers.items()
            if k != (cap, f32)} == others


def test_pool_grows_in_place_on_shared_rows():
    """``pad_into`` between views of one buffer, a pool of 1 → 2 → 4
    with a fork, over a previous request's stale rows: the shared rows
    stay where they are, the new ones are zeroed, the result bit for bit
    JAX's ``pad_batch`` chain."""
    g = torch.Generator().manual_seed(4)
    rows = RowBuffers(2, 2, 4)
    cpu = torch.device("cpu")
    buf = rows.cache(4, 16, torch.float32, cpu)
    buf.k.copy_(torch.randn(buf.k.shape, generator=g))      # stale
    buf.v.fill_(7.0)
    buf.length.fill_(5)
    one = rows.cache(1, 16, torch.float32, cpu)
    one.k.copy_(torch.randn(one.k.shape, generator=g))
    one.v.copy_(torch.randn(one.v.shape, generator=g))
    one.length.fill_(9)
    one.pad.fill_(2)
    want = _jcache(one).pad_batch(2).copy_row(0, 1, 4).pad_batch(4)
    two = one.pad_into(rows.cache(2, 16, torch.float32, cpu))
    four = two.copy_row(0, 1, 4).pad_into(rows.cache(4, 16, torch.float32,
                                                     cpu))
    assert four.k.data_ptr() == one.k.data_ptr() == buf.k.data_ptr()
    for got, ref in zip((four.k, four.v, four.length, four.pad), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert rows.nbytes() == 2 * buf.k.nbytes


# ------------------- HPD-Parsing's children, per-row slots -------------------

def _family_prefill(m, img, max_new):
    """The port family's parse prefill into its parent key's cache →
    (first (1,), cache, npos, t)."""
    e, p, vl, t = m._build_inputs([img], "parse")
    st = m.decode_graphs.state(1, decoder_cache_capacity(t, max_new + 1),
                               e.dtype, e.device)
    with torch.inference_mode():
        cache, full, _ = m._new_cache(e, vl, st.cache.capacity,
                                      cache=st.cache)
        logits, _, _ = m.module.lm.prefill(e, p, cache, full)
        cache.advance(t)
    return logits.argmax(-1).to(torch.int32), cache, int(p.max()) + 1, t


@pytest.mark.parametrize("ends", [(2, 5), (1, 3, 6)])
def test_children_per_row_slots_match_jax_scan(hpd_family, ends):
    """The parent's decode at the 0-d slot, then children forked at
    ``ends`` of it from the parent's cache at per-row slots and
    positions (one per-row key), against JAX's jitted scan on the same
    caches: ids identical, the keys' caches close."""
    ours, ref = hpd_family
    n = 7
    first, cache, npos, t = _family_prefill(ours, _img(), n)
    jprefix = _jcache(cache)
    parent, pcache = ours._decode_from_cache(first, cache, npos, t, n)
    jparent, jpc = ref._decode_from_cache(jnp.asarray(first.numpy()),
                                          jprefix, npos, t, n)
    np.testing.assert_array_equal(parent, np.asarray(jparent))
    _close(pcache.k.numpy(), np.asarray(jpc.k))
    child = pcache.keep_indices([0] * len(ends)).with_lengths(
        [t + e for e in ends])
    seeds = torch.tensor([int(parent[0, e]) for e in ends],
                         dtype=torch.int32)
    jchild = _jcache(child)
    got, gcache = ours._decode_from_cache(
        seeds, child, torch.tensor([npos + e for e in ends]),
        torch.tensor([t + e for e in ends]), n)
    want, wcache = ref._decode_from_cache(
        jnp.asarray(seeds.numpy()), jchild,
        jnp.asarray([npos + e for e in ends], jnp.int32),
        jnp.asarray([t + e for e in ends], jnp.int32), n)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(gcache.length.numpy(),
                                  np.asarray(wcache.length))
    _close(gcache.k.numpy(), np.asarray(wcache.k))
    st = ours.decode_graphs.states[(len(ends), cache.capacity,
                                    torch.float32, "rows")]
    assert st.cache is gcache and st.slot.shape == (len(ends),)
    assert st.slot.tolist() == [t + e + n for e in ends]


def test_children_keys_share_one_row_buffer(hpd_family):
    """The per-row keys (one per child count) view one buffer per
    capacity: a key of more rows replaces it and drops the per-row keys
    on the old one, a smaller key then views the new one; the 0-d-slot
    keys keep their own caches."""
    ours = hpd_family[0]
    graphs = ours.decode_graphs
    f32, cpu, cap = torch.float32, torch.device("cpu"), 2048
    parent = graphs.state(1, cap, f32, cpu)
    two = graphs.state(2, cap, f32, cpu, per_row=True)
    assert graphs.state(2, cap, f32, cpu, per_row=True) is two
    three = graphs.state(3, cap, f32, cpu, per_row=True)
    assert (2, cap, f32, "rows") not in graphs.states
    buf = graphs.rows.buffers[(cap, f32)]
    assert buf.k.shape[1] == 3 and three.cache.k.data_ptr() == \
        buf.k.data_ptr()
    two = graphs.state(2, cap, f32, cpu, per_row=True)
    assert two.cache.k.shape[1] == 2
    assert two.cache.k.data_ptr() == buf.k.data_ptr()
    assert graphs.states[(1, cap, f32)] is parent
    assert parent.cache.k.data_ptr() != buf.k.data_ptr()


def test_parse_with_forks_reuses_its_keys(hpd_family, monkeypatch):
    """``parse_with_forks`` with two forks: the parent through the 0-d
    key, the children through the per-row key, JAX's result; a second
    call makes no new key and keeps every buffer's address."""
    ours, ref = hpd_family

    def forks(ids, pattern):
        return [(e, ids[e]) for e in (2, 4)]

    monkeypatch.setattr(fam, "_fork_points", forks)
    monkeypatch.setattr(jfam, "_fork_points", forks)
    img = _img(1)
    got = ours.parse_with_forks(img, max_new_tokens=6)
    assert got == ref.parse_with_forks(img, max_new_tokens=6)
    keys = {k: [x.data_ptr() for x in (st.cache.k, st.slot, st.ids)]
            for k, st in ours.decode_graphs.states.items()}
    assert any(k[-1] == "rows" for k in keys)
    assert ours.parse_with_forks(img, max_new_tokens=6) == got
    assert {k: [x.data_ptr() for x in (st.cache.k, st.slot, st.ids)]
            for k, st in ours.decode_graphs.states.items()} == keys


# ---------------------------- SDAR diffusion ----------------------------

def _check_block(st, blocks, trial, commit, jcache, jbpids, wpos, mask_tok,
                 steps=3):
    """One block through the port's trial and commit bodies and JAX's
    passes (``trial(feed, cache)`` → logits, ``commit(tokens, cache)`` →
    cache): each trial's logits close and its unmasked tokens identical,
    the cache rolled back after each trial, the commit's K/V close and
    its length identical."""
    from oar_ocr_tpu_torch.vl.diffusion import transfer_count

    L = st.block
    tokens = np.full((1, L), MASK_ID, np.int32)
    for s in range(steps):
        prev = transfer_count(s - 1, steps, L) if s else 0
        m = transfer_count(s, steps, L) - prev
        st.min_transfer.fill_(m)
        with torch.inference_mode():
            logits = blocks.trial_body(st)
        assert st.cache.length.tolist() == [wpos]
        feed = np.where(tokens == MASK_ID, mask_tok, tokens)
        jlogits = trial(jnp.asarray(feed, jnp.int32), jcache)
        _close(logits.numpy(), np.asarray(jlogits))
        tokens = np.asarray(j_unmask_step(
            jnp.asarray(tokens), jlogits, confidence_threshold=0.9,
            min_transfer=m))
        np.testing.assert_array_equal(st.read(), tokens[0])
    with torch.inference_mode():
        blocks.commit_body(st)
    jcache = commit(jnp.asarray(tokens, jnp.int32), jcache)
    assert st.cache.length.tolist() == [wpos + L] == \
        np.asarray(jcache.length).tolist()
    _close(st.cache.k.numpy(), np.asarray(jcache.k))
    _close(st.cache.v.numpy(), np.asarray(jcache.v))
    assert int(st.wpos) == wpos + L and (st.tokens == MASK_ID).all()
    np.testing.assert_array_equal(st.positions.numpy()[..., 0],
                                  np.asarray(jbpids)[..., 0] + L)


def test_exact_trial_and_commit_bodies_match_jax(sdar_exact):
    """SDAR's exact trial (bidirectional, rolled back) and commit
    (causal) bodies at the 0-d device slot against JAX's
    ``decode_block_bidir`` / ``decode_block_causal`` on the same cache."""
    ours, ref = sdar_exact
    c = ours.spec.text_cfg
    embeds, pids, t = ours.prepare_prompt(imgs()[0], "OCR:")
    st = ours.diffusion_start(embeds, torch.as_tensor(pids).long(),
                              max_new_tokens=8, block_len=8,
                              confidence_threshold=0.9)
    jcache = _jcache(st.cache)
    ds, cv = ref._empty_states(ref.params, 1)
    bpids = jnp.asarray(st.positions.numpy().copy())

    # the JAX generate's own jits (``exact_models.py:769-776``)
    bidir, causal = (ref._cached_jit(name, lambda name=name: jax.jit(
        functools.partial(ref.module.apply,
                          method=getattr(jem.ExactVLMModule, name))))
        for name in ("decode_block_bidir", "decode_block_causal"))

    def trial(feed, cache):
        return bidir(ref.params, feed, bpids, cache, t, ds, cv)[0]

    def commit(tokens, cache):
        return causal(ref.params, tokens, bpids, cache, t, ds, cv)[1]

    _check_block(st, ours.diffusion, trial, commit, jcache, bpids, t,
                 c.vocab_size - 1)


def test_family_trial_and_commit_bodies_match_jax(diffusion_family):
    """MinerU-Diffusion's family trial and commit bodies at the 0-d
    device slot and the family's positions (``cpos``) against JAX's
    ``decode_block_bidir`` / ``decode_block`` on the same cache."""
    ours, ref = diffusion_family
    c, L = ours.cfg.decoder, ours.cfg.diffusion_block
    e, p, vl, t = ours._build_inputs([_img()], "ocr")
    cap = decoder_cache_capacity(t, 2 * L)
    st = ours.diffusion_state(cap, e.dtype, e.device)
    with torch.inference_mode():
        cache, full, _ = ours._new_cache(e, vl, cap, cache=st.cache)
        ours.module.lm.prefill(e, p, cache, full)
        cache.advance(t)
        cpos = int(p.max()) + 1
        st.begin(t, cpos + torch.arange(L), 0.9)
    jcache = _jcache(st.cache)
    bpids = jnp.asarray(st.positions.numpy().copy())

    # the JAX family's own jits (``families.py:878-883``)
    def trial(feed, cache):
        return ref._bidir(ref.params, feed, bpids, cache, t)[0]

    def commit(tokens, cache):
        return ref._commit(ref.params, tokens, bpids, cache, t)[2]

    _check_block(st, ours.diffusion, trial, commit, jcache, bpids, t,
                 c.vocab_size - 1)


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=16, block_len=8),
    dict(max_new_tokens=12, block_len=4, num_unmask_steps=2,
         confidence_threshold=0.0)])
def test_exact_generate_matches_jax(sdar_exact, kw):
    """``SdarDiffusionExact.generate``'s ids and texts identical to JAX's;
    a second request replays its key (no new key, the same buffers)."""
    ours, ref = sdar_exact
    img = imgs()[1]
    ids = []
    got = ours.generate([img], token_ids=ids, **kw)
    assert got == ref.generate([img], **kw)
    key = next(k for k in ours.diffusion.states if k[0] == kw["block_len"])
    st = ours.diffusion.states[key]
    ptrs = [x.data_ptr() for x in (st.cache.k, st.tokens, st.wpos)]
    again = []
    assert ours.generate([img], token_ids=again, **kw) == got
    assert again == ids and ours.diffusion.states[key] is st
    assert ptrs == [x.data_ptr() for x in (st.cache.k, st.tokens, st.wpos)]


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=8, num_unmask_steps=3),
    dict(max_new_tokens=20, num_unmask_steps=4, confidence_threshold=0.0)])
def test_family_generate_matches_jax(diffusion_family, kw):
    """``MinerUDiffusion.generate``'s texts identical to JAX's, through one
    key's static buffers; a second request the same, on the same key."""
    ours, ref = diffusion_family
    img = _img()
    got = ours.generate([img], **kw)
    assert got == ref.generate([img], **kw)
    n = len(ours.diffusion.states)
    assert ours.generate([img], **kw) == got
    assert len(ours.diffusion.states) == n


# ------------------------- the cache's in-place ops -------------------------

@pytest.mark.parametrize("op", ["with_lengths_tensor", "with_lengths_list",
                                "copy_row_device", "trim_to_device"])
def test_cache_ops_write_in_place(op):
    """The ops a round or a fork runs on a static key: each writes the
    cache's own buffers (no reallocation) from a device tensor or a host
    value, with JAX's result."""
    g = torch.Generator().manual_seed(5)
    ours = KVCache.create(1, 3, 2, 8, 4, dtype=torch.float32,
                          device=torch.device("cpu"))
    ours.k.copy_(torch.randn(ours.k.shape, generator=g))
    ours.length.copy_(torch.tensor([5, 2, 7], dtype=torch.int32))
    ref = _jcache(ours)
    ptrs = [x.data_ptr() for x in (ours.k, ours.v, ours.length, ours.pad)]
    if op == "with_lengths_tensor":
        got = ours.with_lengths(torch.tensor([3, 4, 1], dtype=torch.int64))
        want = ref.with_lengths(jnp.asarray([3, 4, 1], jnp.int32))
    elif op == "with_lengths_list":
        got, want = ours.with_lengths([6, 0, 2]), ref.with_lengths(
            jnp.asarray([6, 0, 2], jnp.int32))
    elif op == "copy_row_device":
        got = ours.copy_row(2, 0, torch.tensor(3))
        want = ref.copy_row(2, 0, 3)
    else:
        got, want = ours.trim_to(torch.tensor(4)), ref.trim_to(4)
    assert got is ours
    assert ptrs == [x.data_ptr() for x in (ours.k, ours.v, ours.length,
                                           ours.pad)]
    for a, b in zip((ours.k, ours.v, ours.length, ours.pad), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.length.dtype == torch.int32

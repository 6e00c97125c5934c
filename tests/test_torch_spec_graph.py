"""The speculative rounds on their static buffers
(``vl/decode_graph.SpecRounds``), run eagerly on the CPU — the plain
version of the rounds the card replays as CUDA graphs — against the JAX
package's rounds, in float32 at tiny configs.

Five round paths, each on a pair of port and JAX models the other test
files build (the port's seeded weights in both): HunyuanOCRSpeculative's
DFlash round (``test_torch_dflash.pair``), the HunyuanOCR family's DFlash
round and the GLM-OCR family's MTP round
(``test_torch_vl_families.make_pair``), OvisOCR2's n-gram round with its
delta carry and GLM-OCR's exact MTP round
(``torch_exact_common.make_pair``). A round starts from the port's
prefilled state, which JAX gets as its own caches, so the round alone is
compared:

- ``natural``: the whole round, draft half included, against the JAX
  round under ``jax.jit``, as the JAX loops run it;
- ``zero``, ``partial``, ``full``: the port's greedy ids (which the
  other files hold to JAX's) written into the static ``drafts`` buffer,
  the first (or the ``k // 2 + 1``-th) made wrong, and the verify half
  run alone; the jitted JAX round gets the same drafts from its own
  draft source: a module whose draft method returns drafts that ride in
  its variables (:class:`_Forced`; the family MTP's scan counts its
  steps in the hidden carry it starts at zero), or, for n-gram, a
  history whose trailing bigram proposes them.

Gates: the emitted ids, the accept count and the next token identical;
the cache lengths after the trim identical; the target cache's written
rows, the draft's paged context, the MTP hidden state, the delta carry
within 1e-5 · max(1, max|ref|); the n-gram history the one JAX's host
loop builds. Then: a second, shorter request on the same round key gives
the ids it gets on fresh buffers; a DFlash request that crosses a page
bucket follows the JAX rounds round for round; a round past the KV
capacity raises; the paged pool caps its page bucket at the request's
rows, as the JAX host's pool does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dflash as dflash_tests
import test_torch_vl_families as family_tests
from oar_ocr_tpu.vl import families as jfam
from oar_ocr_tpu.vl import hunyuan as jhy
from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache
from oar_ocr_tpu.vl.paged_kv import PagedKVCache as JPagedKVCache
from oar_ocr_tpu.vl.paged_kv import page_bucket as j_page_bucket
from oar_ocr_tpu_torch.errors import InvalidInputError
from torch_exact_common import imgs, make_pair as exact_pair
from torch_jax_tree import one_torch_thread  # noqa: F401
from test_torch_dflash import pair  # noqa: F401  (the DFlash pair)

PATHS = ("hunyuan", "family_dflash", "family_mtp", "ngram", "glm_mtp")
KINDS = ("natural", "zero", "partial", "full")
MAX_NEW = 12
NGRAM_K = 3


def _np(t):
    return t.detach().cpu().numpy()


def _j(t, dtype=None):
    """A JAX copy of a port tensor: a zero-copy view of its memory would
    change under the port's in-place round while JAX's asynchronous
    dispatch may still read it."""
    return jnp.array(np.array(_np(t), dtype=dtype))


def _jkv(cache):
    return JKVCache(*(_j(x) for x in (cache.k, cache.v, cache.length,
                                      cache.pad)))


def _jpaged(ctx):
    return JPagedKVCache(*(_j(x) for x in (ctx.k, ctx.v, ctx.length,
                                           ctx.pad)))


def _rows(k, n):
    """The first ``n`` rows of every layer and head of a (L, B, H, C, D)
    cache, or of a (L, B, P, S, H, D) paged pool, flattened."""
    k = np.asarray(k)
    if k.ndim == 6:
        L, B, P, S, H, D = k.shape
        return k.reshape(L, B, P * S, H, D)[:, :, :n]
    return k[:, :, :, :n]


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(ref).all(), what
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), (what, err)


def _strip(variables):
    """A flax variables dict without the forced drafts riding in it."""
    return {k: v for k, v in variables.items() if k != "forced"}


class _Forced:
    """A JAX module whose ``apply`` for ``method`` returns
    ``make(out, variables["forced"], i, args)`` at its i-th call (at
    trace time): the round's draft source giving the drafts that ride in
    its variables, so they are traced and one program serves every
    forced case."""

    def __init__(self, module, method, make):
        self._module, self._method, self._make = module, method, make
        self.calls = 0

    def apply(self, variables, *args, method=None, **kw):
        out = self._module.apply(_strip(variables), *args, method=method,
                                 **kw)
        if method is self._method:
            out = self._make(out, variables["forced"], self.calls, args)
            self.calls += 1
        return out

    def __getattr__(self, name):
        return getattr(self._module, name)


def _onehot(ids, vocab):
    """Logits whose argmax is ``ids``."""
    return jax.nn.one_hot(ids, vocab) * 100.0


def _with_forced(variables, forced):
    return {**variables, "forced": jnp.asarray(forced, jnp.int32)}


_JITS = {}


def _jit(key, fn):
    """One jitted JAX round a (path, kind, statics) key, kept across
    cases: a forced round's drafts are arguments, not constants."""
    if key not in _JITS:
        _JITS[key] = jax.jit(fn)
    return _JITS[key]


class Round:
    """One path's round: the port model, its round runner and state
    (just prefilled), the greedy ids, and the JAX round on the same
    state: ``fn`` with its statics bound, its ``args`` for the natural
    round, ``forced_args(drafts)`` and the ``shim`` (object, attribute,
    value) set while the forced round traces, and ``unpack`` of its
    results into what :meth:`result` reads from the port."""

    def __init__(self, path, models, max_new=MAX_NEW):
        self.path = path
        self.shim = None
        getattr(self, f"_start_{path}")(*models, max_new)
        self.w0 = self.st.at

    # -- the five paths: state, greedy ids, the JAX round ---------------
    def _start_hunyuan(self, spec, ours, _tree, max_new):
        embeds, pids = dflash_tests._prompt(ours, dflash_tests._image())
        pos = torch.from_numpy(pids)[:, None]
        k = ours.dcfg.block_size - 1
        self.greedy = ours.prefill_decode(embeds, pos, max_new=k + 2,
                                          capacity=256)[0][0].tolist()
        tok, cache, _ = ours.start(embeds, pos, max_new=max_new)
        self.model, self.rounds = ours, ours.spec_rounds
        self.st = st = ours.spec_rounds.states[(1, cache.capacity,
                                                torch.float32)]
        self.bucket = ours.bucket(st)
        vocab = ours.cfg.vocab_size
        self.vocab = vocab
        self.fn = functools.partial(spec._spec_round, n_pages=self.bucket)
        self.args = (spec.params, spec.draft_params, _j(st.tok),
                     _jkv(st.cache), _jpaged(st.ctx), jnp.int32(st.at))
        self.forced_args = lambda forced: (
            _with_forced(spec.params, forced),) + self.args[1:]
        self.shim = (spec, "module", _Forced(
            spec.module, jhy.HunyuanOCRModule.lm_logits,
            lambda out, forced, i, args: _onehot(forced, vocab)))
        self.unpack = lambda out: self._paged(*out)

    def _start_family_dflash(self, ours, ref, max_new):
        e, p, vl, _ = ours._build_inputs([family_tests._img(3, 56, 56)],
                                         "ocr")
        k = ours.cfg.dflash.block_size - 1
        self.greedy = ours._generate_impl(e, p, vl, max_new=k + 2,
                                          capacity=256)[0].tolist()
        tok, cache, _ = ours.dflash_start(e, p, vl, max_new=max_new)
        self.model, self.rounds = ours, ours.spec_rounds
        self.st = st = ours.spec_rounds.states[(1, cache.capacity,
                                                torch.float32)]
        self.bucket = ours.dflash_bucket(st)
        self.vocab = ours.cfg.decoder.vocab_size
        self.fn = functools.partial(ref._dflash_round_impl,
                                    n_pages=self.bucket)
        self.args = (ref.params, _j(st.tok), _jkv(st.cache),
                     _jpaged(st.ctx), _j(st.cpos, np.int32),
                     jnp.int32(st.at))
        self.forced_args = lambda forced: (
            _with_forced(ref.params, forced),) + self.args[1:]
        self.shim = (ref, "module", _Forced(
            ref.module, jfam.FamilyModule.dflash_proposals,
            lambda out, forced, i, args: forced))
        self.unpack = lambda out: self._paged(*out)

    def _start_family_mtp(self, ours, ref, max_new):
        e, p, vl, _ = ours._build_inputs([family_tests._img(1)], "ocr")
        k = ours.cfg.draft_len
        self.greedy = ours._generate_impl(e, p, vl, max_new=k + 2,
                                          capacity=256)[0].tolist()
        st = ours.mtp_start(e, p, vl, max_new=max_new)
        self.model, self.rounds, self.st = ours, ours.spec_rounds, st
        self.bucket = None
        vocab = self.vocab = ours.cfg.decoder.vocab_size
        self.fn = functools.partial(ref._spec_round_impl, k=k)
        self.args = (ref.params, _j(st.h), _j(st.tok), _jkv(st.cache),
                     _j(st.cpos, np.int32), jnp.int32(st.at))
        # the draft step sits in a scan: the forced round starts its
        # hidden carry at zeros and counts the steps in it (the forced
        # round reads that carry nowhere else)
        self.forced_args = lambda forced: (
            _with_forced(ref.params, forced),
            jnp.zeros_like(self.args[1])) + self.args[2:]
        def draft_step(out, forced, i, args):
            step = args[0][0, 0].astype(jnp.int32)
            return (args[0] + 1.0,
                    _onehot(jnp.take(forced, step, axis=1), vocab))

        self.shim = (ref, "module", _Forced(
            ref.module, jfam.FamilyModule.draft_step, draft_step))
        self.unpack = lambda out: self._pack(
            out[0], out[1], out[3], (out[4].length,),
            {"cache.k": _rows(out[4].k, self._n()),
             "cache.v": _rows(out[4].v, self._n()), "h": out[2]})

    def _start_ngram(self, ours, ref, max_new):
        img = imgs()[0]
        k = NGRAM_K
        ids = []
        ours.generate([img], max_new_tokens=k + 2, token_ids=ids)
        self.greedy = ids[0]
        embeds, pids, _ = ours.prepare_prompt(img, "OCR:")
        st = ours.ngram_start(embeds, torch.from_numpy(pids).long(),
                              ours.tokenizer.encode("OCR:"),
                              max_new_tokens=max_new, draft_k=k, ngram=2)
        self.model, self.rounds, self.st = ours, ours.spec_rounds, st
        self.bucket = None
        self.vocab = ours.spec.text_cfg.vocab_size
        self.hist0 = _np(st.hist[0, :-1]).copy()
        self.hlen0 = int(st.hist_len[0])
        self.fn = functools.partial(ref._spec_round_impl, k=k, ngram=2)
        self.args = (ref.params, _j(st.tok), _jkv(st.cache), _j(st.dstate),
                     _j(st.conv), _j(st.hist[:, :-1]), _j(st.hist_len),
                     _j(st.cpos, np.int32))

        def forced_args(forced):
            # a history whose trailing bigram (x, y) occurred once before,
            # followed by the drafts: JAX's own n-gram draft proposes them
            x, y = [v for v in range(self.vocab - 1, -1, -1)
                    if v not in forced[0]][:2]
            seq = [x, y] + list(forced[0]) + [x, y]
            hist = np.full(self.hist0.shape, -1, np.int32)
            hist[:len(seq)] = seq
            return self.args[:5] + (jnp.asarray(hist[None]),
                                    jnp.asarray([len(seq)], jnp.int32),
                                    self.args[7])

        self.forced_args = forced_args
        self.unpack = lambda out: self._pack(
            out[0], out[1], out[2], (out[3].length,),
            {"cache.k": _rows(out[3].k, self._n()),
             "cache.v": _rows(out[3].v, self._n()),
             "dstate": out[4], "conv": out[5]})

    def _start_glm_mtp(self, ours, ref, max_new):
        img = imgs()[0]
        k = ours.draft_k
        ids = []
        ours.generate([img], max_new_tokens=k + 2, token_ids=ids)
        self.greedy = ids[0]
        embeds, pids, _ = ours.prepare_prompt(img, "OCR:")
        st = ours.mtp_start(embeds, torch.from_numpy(pids).long(),
                            max_new_tokens=max_new)
        self.model, self.rounds, self.st = ours, ours.mtp_rounds, st
        self.bucket = None
        vocab = self.vocab = ours.spec.text_cfg.vocab_size
        self.fn = functools.partial(ref._spec_round, k=k)
        self.args = (ref.params, ref.mtp_params, _j(st.h), _j(st.tok),
                     _jkv(st.cache), _jkv(st.mtp_cache), jnp.int32(st.at))
        self.forced_args = lambda forced: (
            self.args[0], _with_forced(ref.mtp_params, forced)) \
            + self.args[2:]
        # the k draft steps are a Python loop: call i gives draft i
        self.shim = (ref, "mtp", _Forced(
            ref.mtp, None, lambda out, forced, i, args: (
                _onehot(forced[:, i:i + 1], vocab), *out[1:])))

        def unpack(out):
            emitted, a, nxt, h, jc, jm = out
            arrays = {"cache.k": _rows(jc.k, self._n()),
                      "cache.v": _rows(jc.v, self._n()), "h": h}
            if self.kind == "natural":      # the draft half ran
                arrays["mtp.k"] = _rows(jm.k, self._n() - 1)
            return self._pack(emitted, a, nxt, (jc.length, jm.length),
                              arrays)

        self.unpack = unpack

    # -- running and reading -------------------------------------------
    def _n(self):
        """The rows a round writes end at wpos + k + 1."""
        return self.w0 + self.st.k + 1

    def _paged(self, emitted, a, nxt, jc, jctx):
        return self._pack(emitted, a, nxt, (jc.length, jctx.length),
                          {"cache.k": _rows(jc.k, self._n()),
                           "cache.v": _rows(jc.v, self._n()),
                           "ctx.k": _rows(jctx.k, self._n()),
                           "ctx.v": _rows(jctx.v, self._n())})

    @staticmethod
    def _pack(emitted, a, nxt, lengths, arrays):
        return {"emitted": np.asarray(emitted)[0].tolist(),
                "accepted": int(np.asarray(a)[0]),
                "tok": int(np.asarray(nxt)[0]),
                "lengths": [np.asarray(x).tolist() for x in lengths],
                "arrays": {k: np.asarray(v) for k, v in arrays.items()}}

    def result(self, emitted, n_acc):
        """The port's results, read from its static buffers."""
        st = self.st
        n = self._n()
        caches = {"hunyuan": ("ctx",), "family_dflash": ("ctx",),
                  "glm_mtp": ("mtp_cache",)}.get(self.path, ())
        arrays = {"cache.k": _rows(_np(st.cache.k), n),
                  "cache.v": _rows(_np(st.cache.v), n)}
        if self.path in ("hunyuan", "family_dflash"):
            arrays.update({"ctx.k": _rows(_np(st.ctx.k), n),
                           "ctx.v": _rows(_np(st.ctx.v), n)})
        if self.path in ("family_mtp", "glm_mtp"):
            arrays["h"] = _np(st.h)
        if self.path == "ngram":
            arrays.update({"dstate": _np(st.dstate), "conv": _np(st.conv)})
        if self.path == "glm_mtp" and self.kind == "natural":
            arrays["mtp.k"] = _rows(_np(st.mtp_cache.k), n - 1)
        return {"emitted": emitted.tolist(), "accepted": n_acc,
                "tok": int(st.tok[0]),
                "lengths": [_np(st.cache.length).tolist()]
                + [_np(getattr(st, c).length).tolist() for c in caches],
                "arrays": arrays}

    def forced_drafts(self, kind):
        """The greedy's next k ids, the first (zero) or the
        (k // 2 + 1)-th (partial) made wrong → (drafts, accept count)."""
        k, g = self.st.k, self.greedy
        drafts = list(g[1:k + 1])
        bad = {"zero": 0, "partial": k // 2, "full": None}[kind]
        if bad is not None:
            drafts[bad] = (drafts[bad] + 1) % self.vocab
        return [drafts], (k if bad is None else bad)

    def run(self, kind, monkeypatch):
        """One round of ``kind`` in both packages → (port, JAX, forced
        accept count or None)."""
        self.kind = kind
        key = (self.path, kind == "natural", self.bucket)
        if kind == "natural":
            ref = self.unpack(_jit(key, self.fn)(*self.args))
            got = self.result(*self.rounds.run(self.st, self.bucket,
                                               graph=False))
            return got, ref, None
        drafts, want = self.forced_drafts(kind)
        with monkeypatch.context() as m:
            if self.shim is not None:
                m.setattr(*self.shim)
            ref = self.unpack(_jit(key, self.fn)(*self.forced_args(drafts)))
        with torch.inference_mode():
            self.st.drafts.copy_(torch.tensor(drafts, dtype=torch.int32))
        got = self.result(*self.rounds.run(self.st, draft=False))
        return got, ref, want


@pytest.fixture(scope="module")
def models(request):
    """The port/JAX pairs, built once a path."""
    built = {}

    def get(path, dflash_pair):
        if path not in built:
            built[path] = {
                "hunyuan": lambda: dflash_pair,
                "family_dflash": lambda: family_tests.make_pair(
                    "hunyuanocr", seed=7),
                "family_mtp": lambda: family_tests.make_pair("glmocr"),
                "ngram": lambda: exact_pair("ovis_exact"),
                "glm_mtp": lambda: exact_pair("glm_speculative_exact"),
            }[path]()
        return built[path]

    return get


@pytest.mark.parametrize("pair", [3], indirect=True)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", PATHS)
def test_round_matches_jax(path, kind, pair, models, monkeypatch):
    rnd = Round(path, models(path, pair))
    got, ref, want = rnd.run(kind, monkeypatch)
    assert got["emitted"] == ref["emitted"]
    assert (got["accepted"], got["tok"]) == (ref["accepted"], ref["tok"])
    assert got["lengths"] == ref["lengths"]
    assert got["lengths"][0] == [rnd.w0 + 1 + got["accepted"]]
    assert set(got["arrays"]) == set(ref["arrays"])
    for name, value in got["arrays"].items():
        _close(value, ref["arrays"][name], f"{path} {kind} {name}")
    a = got["accepted"]
    if want is not None:
        # the verify half alone follows the greedy ids
        assert a == want
        assert got["emitted"][:a + 1] == rnd.greedy[1:a + 2]
    if path == "ngram":
        # the history JAX's host loop builds: the emitted ids appended
        want_hist = rnd.hist0.copy()
        want_hist[rnd.hlen0:rnd.hlen0 + a + 1] = got["emitted"][:a + 1]
        assert _np(rnd.st.hist[0, :-1]).tolist() == want_hist.tolist()
        assert int(rnd.st.hist_len[0]) == rnd.hlen0 + a + 1


def _request(path, models, dflash_pair, max_new):
    """One request's emitted ids through the path's decode entry point
    (its round key's static buffers)."""
    if path == "hunyuan":
        _, ours, _ = dflash_pair
        embeds, pids = dflash_tests._prompt(ours, dflash_tests._image())
        return ours, ours.spec_rounds, ours.decode_speculative(
            embeds, torch.from_numpy(pids)[:, None], max_new=max_new)
    ours, _ = models(path, dflash_pair)
    if path in ("family_dflash", "family_mtp"):
        img = (family_tests._img(3, 56, 56) if path == "family_dflash"
               else family_tests._img(1))
        e, p, vl, _ = ours._build_inputs([img], "ocr")
        decode = (ours.decode_dflash if path == "family_dflash"
                  else ours.decode_mtp)
        return ours, ours.spec_rounds, decode(e, p, vl, max_new=max_new)
    ids = []
    if path == "ngram":
        ours.generate_speculative([imgs()[0]], max_new_tokens=max_new,
                                  draft_k=NGRAM_K, token_ids=ids)
        return ours, ours.spec_rounds, ids[0]
    ours.generate_speculative([imgs()[0]], max_new_tokens=max_new,
                              token_ids=ids)
    return ours, ours.mtp_rounds, ids[0]


@pytest.mark.parametrize("pair", [3], indirect=True)
@pytest.mark.parametrize("path", PATHS)
def test_buffer_reuse(path, pair, models):
    """A longer request, then a shorter one on the same round key: the
    shorter one's ids are those it gets on fresh buffers."""
    ours, rounds, _ = _request(path, models, pair, MAX_NEW)
    keys = set(rounds.states)
    _, _, second = _request(path, models, pair, 6)
    assert set(rounds.states) == keys         # the same key, reused
    saved = dict(rounds.states)
    rounds.states.clear()
    try:
        _, _, alone = _request(path, models, pair, 6)
    finally:
        rounds.states.clear()
        rounds.states.update(saved)
    assert second == alone and len(second) >= 2


@pytest.mark.parametrize("pair", [3], indirect=True)
def test_dflash_request_across_page_buckets(pair, models):
    """A HunyuanOCRSpeculative request whose rounds cross a page bucket:
    each round's emitted ids, accept count and bucket equal the JAX
    rounds' (one jit a bucket, as ``hunyuan.py:739-746``) run on the
    same prefilled state, and the draft's paged context at the end
    equals JAX's."""
    spec, ours, _ = pair
    rnd = Round("hunyuan", (spec, ours, None), max_new=16)
    st, d = rnd.st, ours.dcfg
    k = d.block_size - 1
    tok, cache, ctx = _j(st.tok), _jkv(st.cache), _jpaged(st.ctx)
    wpos, buckets, jits = st.at, [], {}
    while len(buckets) < 12 and \
            st.at + k + 1 <= st.ctx.page_cap * d.page_size:
        npg = ours.bucket(st)
        assert npg == j_page_bucket(wpos + k + 1, d.page_size,
                                    st.ctx.page_cap)
        if npg not in jits:
            jits[npg] = jax.jit(functools.partial(spec._spec_round,
                                                  n_pages=npg))
        emitted, a, tok, cache, ctx = jits[npg](
            spec.params, spec.draft_params, tok, cache, ctx,
            jnp.int32(wpos))
        got, n_acc = ours.spec_rounds.run(st, npg, graph=False)
        assert got.tolist() == np.asarray(emitted)[0].tolist()
        assert n_acc == int(a[0])
        wpos += 1 + n_acc
        buckets.append(npg)
    assert len(set(buckets)) >= 2, buckets
    assert _np(st.ctx.length).tolist() == np.asarray(ctx.length).tolist()
    n = st.at
    _close(_rows(_np(st.ctx.k), n), _rows(ctx.k, n), "ctx.k")
    _close(_rows(_np(st.ctx.v), n), _rows(ctx.v, n), "ctx.v")


@pytest.mark.parametrize("pair", [3], indirect=True)
def test_round_past_capacity_raises(pair, models):
    """A round whose k + 1 rows would pass the KV capacity raises
    InvalidInputError before it runs."""
    rnd = Round("hunyuan", models("hunyuan", pair))
    st = rnd.st
    st.at = st.cache.capacity - st.k
    with pytest.raises(InvalidInputError, match="past the KV capacity"):
        rnd.rounds.run(st, rnd.bucket, graph=False)


@pytest.mark.parametrize("rows,length", [(9, 5), (9, 12), (40, 33),
                                         (40, 40)])
def test_page_bucket_capped_at_the_request_pool(rows, length):
    """The port's paged pool holds its round key's capacity; after
    ``reset(rows)`` its page bucket is the JAX host's, whose pool holds
    the request's rows (``hunyuan.py:723-739``), also where the key's
    larger pool would give a larger bucket."""
    from oar_ocr_tpu_torch.vl.paged_kv import PagedKVCache

    ps = 4
    ctx = PagedKVCache.create(1, 1, 1, 64 // ps, ps, 2, dtype=torch.float32,
                              device=torch.device("cpu")).reset(rows)
    jpool = JPagedKVCache.create(1, 1, 1, max(1, -(-rows // ps)), ps, 2,
                                 dtype=jnp.float32)
    assert ctx.bucket(length) == j_page_bucket(length, ps, jpool.num_pages)

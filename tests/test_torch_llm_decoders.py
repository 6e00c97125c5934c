"""The port's unified LLM decoder and the two MTP heads against the JAX
package's, on the CPU.

Each published preset's flag set runs at tiny width in float32 in both
packages on the port's seeded weights (carried into the flax tree by
``torch_jax_tree``): MinerU's Qwen2 (MRoPE, q/k/v bias), SDAR (q/k RMS
norm + rotary: the K4 site, its plain version here), GLM (partial
interleaved rotary, fused gate_up, sandwich norms) and Ovis (hybrid
gated-delta + full attention, additive q/k norm). The gates: logits of the
prefill and of two decode steps within 1e-5 · max|logit| (a seeded head
over each side's final hidden states); the delta layers' per-step states
of a ``collect_states`` block and their carried states within 1e-5 ·
max(1, max|ref|); both MTP heads likewise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.vl import llm_decoders as jld
from oar_ocr_tpu.vl.attention import create_generation_mask as j_gen_mask
from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache
from oar_ocr_tpu_torch.vl import llm_decoders as ld
from oar_ocr_tpu_torch.vl.attention import create_generation_mask
from oar_ocr_tpu_torch.vl.exact_models import _tiny_text, exact_state_dict
from oar_ocr_tpu_torch.vl.kv_cache import KVCache
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
B, T, CAP = 2, 7, 16

PRESETS = {
    "mineru": lambda m: _tiny_text(m.MINERU_TEXT, mrope_sections=(2, 2, 2)),
    "sdar": lambda m: _tiny_text(m.SDAR_TEXT),
    "glm": lambda m: _tiny_text(m.GLM_TEXT),
    "ovis": lambda m: _tiny_text(m.OVIS_TEXT, layers=4, linear_head_dim=8),
}


def _close(got, ref, scale=None, tol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    s = max(1.0, float(np.abs(ref).max())) if scale is None else scale
    err = float(np.abs(got - ref).max())
    assert err <= tol * s, (err, s)


def _pids(cfg, start, t):
    p = np.broadcast_to(start + np.arange(t, dtype=np.int32), (B, t))
    return np.broadcast_to(p, (3, B, t)).copy() if cfg.rope_kind == "mrope" \
        else p.copy()


def _prefill_mask():
    m = np.tril(np.ones((T, T), bool))
    m = np.concatenate([m, np.zeros((T, CAP - T), bool)], -1)
    return np.broadcast_to(m, (B, 1, T, CAP)).copy()


def _pair(name):
    cfg = PRESETS[name](ld)
    jcfg = PRESETS[name](jld)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ours = ld.UnifiedDecoder(cfg)
    sd = exact_state_dict(ours, torch.Generator().manual_seed(4))
    ours.load_state_dict(sd)
    jdec = jld.UnifiedDecoder(jcfg)
    emb = jnp.zeros((B, T, cfg.hidden), jnp.float32)
    cache = JKVCache.create(cfg.layers, B, cfg.kv_heads, CAP, cfg.head_dim,
                            dtype=jnp.float32)

    def init(r):
        return jdec.init(r, emb, jnp.asarray(_pids(cfg, 0, T)), cache, 0,
                         jnp.asarray(_prefill_mask()))

    return cfg, ours, jdec, jax_tree_from_port(jdec, None, sd, init=init)


def _japply(jdec):
    """The JAX decoder's forward, compiled (an eager flax apply
    dispatches op by op, several times slower at these sizes)."""
    return jax.jit(jdec.apply, static_argnums=(8,))


@pytest.fixture(scope="module")
def pairs():
    """``pairs(name)``: the preset's (config, port decoder, JAX decoder,
    tree, compiled JAX forward), built once for the module's tests (the
    JAX forward's compiles are most of their time)."""
    made = {}

    def get(name):
        if name not in made:
            cfg, ours, jdec, tree = _pair(name)
            made[name] = (cfg, ours, jdec, tree, _japply(jdec))
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_decoder_prefill_and_decode_match_jax(name, pairs):
    """Prefill of T tokens, then two decode steps, both packages."""
    cfg, ours, jdec, tree, fwd = pairs(name)
    rng = np.random.default_rng(1)
    embeds = rng.standard_normal((B, T, cfg.hidden)).astype(np.float32)
    head = rng.standard_normal((cfg.hidden, 64)).astype(np.float64)
    toks = rng.integers(0, cfg.vocab_size, (2, B))

    jcache = JKVCache.create(cfg.layers, B, cfg.kv_heads, CAP, cfg.head_dim,
                             dtype=jnp.float32)
    jh, jcache, jds, jcv = fwd(tree, jnp.asarray(embeds),
                                      jnp.asarray(_pids(cfg, 0, T)), jcache,
                                      0, jnp.asarray(_prefill_mask()))
    jcache = jcache.advance(T)
    cache = KVCache.create(cfg.layers, B, cfg.kv_heads, CAP, cfg.head_dim,
                           dtype=torch.float32, device=CPU)
    with torch.no_grad():
        h, _, ds, cv = ours(torch.from_numpy(embeds),
                            torch.from_numpy(_pids(cfg, 0, T)).long(), cache,
                            0, torch.from_numpy(_prefill_mask()))
    cache.advance(T)
    ref = np.asarray(jh) @ head
    _close(h.numpy() @ head, ref, scale=np.abs(ref).max())
    for i, tok in enumerate(toks):
        je = jdec.apply(tree, jnp.asarray(tok[:, None]),
                        method=jld.UnifiedDecoder.embed)
        jm = j_gen_mask(jcache.length + 1, CAP, jcache.pad)
        jh, jcache, jds, jcv = fwd(
            tree, je, jnp.asarray(_pids(cfg, T + i, 1)), jcache, T + i, jm,
            jds, jcv)
        jcache = jcache.advance(1)
        with torch.no_grad():
            e = ours.embed(torch.from_numpy(tok[:, None]))
            m = create_generation_mask(cache.length + 1, CAP, cache.pad)
            h, _, ds, cv = ours(e, torch.from_numpy(
                _pids(cfg, T + i, 1)).long(), cache, T + i, m, ds, cv)
        cache.advance(1)
        ref = np.asarray(jh) @ head
        _close(h.numpy() @ head, ref, scale=np.abs(ref).max())
    if cfg.delta_layers():
        _close(ds.numpy(), np.asarray(jds))
        _close(cv.numpy(), np.asarray(jcv))


def test_collect_states_match_jax(pairs):
    """Ovis's hybrid stack: a 3-token verify block with ``collect_states``
    gives each delta layer's per-step (B, T, Hv, d, d) and conv states,
    rows in ``delta_layers()`` order, equal to JAX; the last step's
    equal the carried states of the same block run without."""
    cfg, ours, jdec, tree, fwd = pairs("ovis")
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((B, T, cfg.hidden)).astype(np.float32)
    blk = rng.standard_normal((B, 3, cfg.hidden)).astype(np.float32)
    jcache = JKVCache.create(cfg.layers, B, cfg.kv_heads, CAP, cfg.head_dim,
                             dtype=jnp.float32)
    _, jcache, jds, jcv = fwd(tree, jnp.asarray(embeds),
                                     jnp.asarray(_pids(cfg, 0, T)), jcache,
                                     0, jnp.asarray(_prefill_mask()))
    jcache = jcache.advance(T)
    bmask = np.arange(CAP)[None, None, None, :] < (
        T + np.arange(3)[None, None, :, None] + 1)
    bmask = np.broadcast_to(bmask, (B, 1, 3, CAP)).copy()
    _, _, jsd, jsc = fwd(tree, jnp.asarray(blk),
                                jnp.asarray(_pids(cfg, T, 3)), jcache, T,
                                jnp.asarray(bmask), jds, jcv, True)
    cache = KVCache.create(cfg.layers, B, cfg.kv_heads, CAP, cfg.head_dim,
                           dtype=torch.float32, device=CPU)
    with torch.no_grad():
        _, _, ds, cv = ours(torch.from_numpy(embeds),
                            torch.from_numpy(_pids(cfg, 0, T)), cache, 0,
                            torch.from_numpy(_prefill_mask()))
        cache.advance(T)
        args = (torch.from_numpy(blk), torch.from_numpy(_pids(cfg, T, 3)),
                cache, T, torch.from_numpy(bmask), ds, cv)
        _, _, sd_, sc_ = ours(*args, collect_states=True)
        _, _, ds3, cv3 = ours(*args)
    nd = len(cfg.delta_layers())
    assert sd_.shape[:3] == (nd, B, 3) and sc_.shape[:3] == (nd, B, 3)
    _close(sd_.numpy(), np.asarray(jsd))
    _close(sc_.numpy(), np.asarray(jsc))
    idx = list(cfg.delta_layers())
    # (the block without collect_states runs the chunked rule)
    _close(sd_[:, :, -1].numpy(), ds3[idx].numpy())
    _close(sc_[:, :, -1].numpy(), cv3[idx].numpy())


def test_mtp_heads_match_jax():
    """GLM-OCR's MTP layer (prefill with fused embeddings, then one token
    step into its own cache) and HPD's P-MTP head."""
    cfg = PRESETS["glm"](ld)
    jcfg = PRESETS["glm"](jld)
    rng = np.random.default_rng(5)
    ours = ld.GlmMtpHead(cfg)
    sd = exact_state_dict(ours, torch.Generator().manual_seed(2))
    ours.load_state_dict(sd)
    jm = jld.GlmMtpHead(jcfg)
    jcache = JKVCache.create(1, B, cfg.kv_heads, CAP, cfg.head_dim,
                             dtype=jnp.float32)
    mask = _prefill_mask()
    pids = _pids(cfg, 0, T)
    emb = rng.standard_normal((B, T, cfg.hidden)).astype(np.float32)
    prev = rng.standard_normal((B, T, cfg.hidden)).astype(np.float32)
    tree = jax_tree_from_port(jm, None, sd, init=lambda r: jm.init(
        r, jnp.zeros((B, T), jnp.int32), jnp.asarray(prev),
        jnp.asarray(pids), jcache, 0, jnp.asarray(mask)))
    mtp = jax.jit(jm.apply)
    jl, jx, jcache = mtp(tree, None, jnp.asarray(prev), jnp.asarray(pids),
                         jcache, 0, jnp.asarray(mask), emb=jnp.asarray(emb))
    jcache = jcache.advance(T)
    cache = KVCache.create(1, B, cfg.kv_heads, CAP, cfg.head_dim,
                           dtype=torch.float32, device=CPU)
    with torch.no_grad():
        lg, x, _ = ours(None, torch.from_numpy(prev), torch.from_numpy(pids),
                        cache, 0, torch.from_numpy(mask),
                        emb=torch.from_numpy(emb))
    cache.advance(T)
    _close(lg.numpy(), np.asarray(jl), scale=float(np.abs(jl).max()))
    _close(x.numpy(), np.asarray(jx))
    tok = rng.integers(0, cfg.vocab_size, (B, 1))
    h1 = rng.standard_normal((B, 1, cfg.hidden)).astype(np.float32)
    col = np.arange(CAP)[None, None, None, :] < T + 1
    jl, jx, _ = mtp(tree, jnp.asarray(tok), jnp.asarray(h1),
                    jnp.full((B, 1), T, jnp.int32), jcache, T,
                    jnp.asarray(np.broadcast_to(col, (B, 1, 1, CAP))))
    with torch.no_grad():
        lg, x, _ = ours(torch.from_numpy(tok), torch.from_numpy(h1),
                        torch.full((B, 1), T), cache, T,
                        torch.from_numpy(np.broadcast_to(col, (B, 1, 1, CAP))
                                         .copy()))
    _close(lg.numpy(), np.asarray(jl), scale=float(np.abs(jl).max()))
    _close(x.numpy(), np.asarray(jx))

    scfg = PRESETS["sdar"](ld)
    hp = ld.HpdMtpHead(scfg)
    hsd = exact_state_dict(hp, torch.Generator().manual_seed(8))
    hp.load_state_dict(hsd)
    jh = jld.HpdMtpHead(PRESETS["sdar"](jld))
    hid = rng.standard_normal((3, scfg.hidden)).astype(np.float32)
    em = rng.standard_normal((3, scfg.hidden)).astype(np.float32)
    htree = jax_tree_from_port(jh, None, hsd, init=lambda r: jh.init(
        r, jnp.asarray(hid), jnp.asarray(em)))
    with torch.no_grad():
        got = hp(torch.from_numpy(hid), torch.from_numpy(em)).numpy()
    _close(got, np.asarray(jh.apply(htree, jnp.asarray(hid),
                                    jnp.asarray(em))))

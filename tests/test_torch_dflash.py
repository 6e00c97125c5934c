"""The port's DFlash draft and ``HunyuanOCRSpeculative`` against the JAX
package's, on the CPU.

The target is ``HunyuanOCRConfig().tiny()`` with its special ids moved
into the vocabulary (as ``test_torch_hunyuan.py``), the draft
``DFlashConfig().tiny()`` as wide as the target (as the JAX test,
``test_hunyuan_parity.py:165-181``). The port's weights are seeded; the
JAX target gets them through its own converter (``build_hunyuan_map``),
the JAX draft through ``torch_jax_tree`` (the flax names map to the
port's by ``torch_name``, and back by ``ppocr_maps.jax_flat_params``).
Gates: the draft's context rows and hidden states, the tapped prefill and the verify block within
1e-4 · max(1, max|ref|); generated ids identical to the JAX package's
and to the port's own greedy decode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.ppocr_maps import build_hunyuan_map
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.weights import flatten_params
from oar_ocr_tpu.vl import dflash as jdf
from oar_ocr_tpu.vl import hunyuan as jhy
from oar_ocr_tpu.vl import paged_kv as j_paged
from oar_ocr_tpu_torch.errors import ConfigError, InvalidInputError
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.runtime.ppocr_maps import jax_flat_params
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import hunyuan_params_from_jax
from oar_ocr_tpu_torch.vl import dflash, hunyuan as hy, paged_kv
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa: F401

_IDS = dict(bos_id=1, eos_id=2, image_start_id=500, image_end_id=501,
            image_token_id=502)
CFG = dataclasses.replace(hy.HunyuanOCRConfig().tiny(), **_IDS)
J_CFG = dataclasses.replace(jhy.HunyuanOCRConfig().tiny(), **_IDS)
DCFG = dflash.DFlashConfig().tiny(vocab_size=CFG.vocab_size,
                                  hidden=CFG.hidden)
J_DCFG = jdf.DFlashConfig().tiny(vocab_size=CFG.vocab_size,
                                 hidden=CFG.hidden)
CPU = torch.device("cpu")


def _j_runtime():
    return JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))


def _draft_init(module, base_hidden, dcfg):
    """The JAX constructor's draft init (``hunyuan.py:605-625``)."""
    aux0 = jnp.zeros((1, 2, base_hidden * len(dcfg.target_layer_ids)),
                     jnp.float32)
    q0 = jnp.zeros((1, dcfg.block_size, base_hidden), jnp.float32)
    ctx0 = j_paged.PagedKVCache.create(dcfg.layers, 1, dcfg.kv_heads, 1,
                                       dcfg.page_size, dcfg.head_dim,
                                       dtype=jnp.float32)

    def _all(m):
        m.context_rows(aux0, 0)
        return m.draft_hidden(q0, ctx0, 1, 0)

    return lambda r: module.init(r, method=_all)


def _image(seed=1):
    return np.random.default_rng(seed).integers(0, 255, (24, 40, 3),
                                                dtype=np.uint8)


def _target_tree(state_dict):
    """The JAX target's parameter tree holding the port's HF-named
    weights: ``build_hunyuan_map`` over zeros of the module's parameter
    shapes (``jax.eval_shape``, no init), strict both ways."""
    module = jhy.HunyuanOCRModule(J_CFG)
    m, p = J_CFG.v_merge, J_CFG.v_patch
    shapes = jax.eval_shape(lambda r: module.init(
        r, jnp.zeros((1, m * m, p * p * 3)), jnp.zeros((m * m, J_CFG.v_dim)),
        m, m, jnp.zeros((1, 4), jnp.int32), jnp.zeros((4, 1, 4), jnp.int32),
        method=jhy.HunyuanOCRModule.init_all), jax.random.PRNGKey(0))
    cm = build_hunyuan_map(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))
    hf = {k: v.numpy() for k, v in state_dict.items()}
    assert cm.unused_sources(hf) == []
    tree = cm.convert(hf, strict=True)
    back = hunyuan_params_from_jax(flatten_params(tree))
    assert set(back) == set(state_dict)
    return tree


@pytest.fixture(scope="module", params=[3, 9])
def pair(request):
    """(JAX HunyuanOCRSpeculative, port HunyuanOCRSpeculative, the draft's
    flax tree) on the port's seeded target and draft weights."""
    seed = request.param
    ours = hy.HunyuanOCRSpeculative(cfg=CFG, dflash_cfg=DCFG, seed=seed,
                                    runtime=Runtime("float32", device="cpu"))
    tree = jax_tree_from_port(jdf.DFlashDraft(J_DCFG), None,
                              ours.draft.state_dict(),
                              init=_draft_init(jdf.DFlashDraft(J_DCFG),
                                               CFG.hidden, J_DCFG))
    spec = jhy.HunyuanOCRSpeculative(_target_tree(ours.net.state_dict()),
                                     cfg=J_CFG, dflash_cfg=J_DCFG,
                                     dflash_params=tree,
                                     runtime=_j_runtime(), seed=seed)
    return spec, ours, tree


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(ref).all()
    err = float(np.abs(got - ref).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), err


def test_config_matches_jax():
    for ours, ref in [(dflash.DFlashConfig(), jdf.DFlashConfig()),
                      (DCFG, J_DCFG)]:
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_draft_names_map_both_ways(pair):
    """The port's draft state_dict → flax keys (``jax_flat_params``) is
    the JAX draft tree, key for key and value for value."""
    _, ours, tree = pair
    flat = jax_flat_params(ours.draft)
    want = flatten_params(tree)
    assert set(flat) == set(want)
    assert "params/layers.0/self_attn/q_proj/kernel" in flat
    for k, v in want.items():
        assert np.array_equal(flat[k], np.asarray(v)), k


def test_draft_context_rows_and_hidden_match(pair):
    spec, ours, tree = pair
    rng = np.random.default_rng(0)
    d = DCFG
    aux = rng.standard_normal((2, 6, CFG.hidden * 2)).astype(np.float32)
    ks, vs = ours.draft.context_rows(torch.from_numpy(aux), 3)
    jks, jvs = jax.jit(functools.partial(
        spec.draft.apply, method=jdf.DFlashDraft.context_rows))(
        tree, jnp.asarray(aux), 3)
    assert ks.shape == (d.layers, 2, d.kv_heads, 6, d.head_dim)
    _close(ks, jks)
    _close(vs, jvs)
    ctx = paged_kv.PagedKVCache.create(d.layers, 2, d.kv_heads, 4,
                                       d.page_size, d.head_dim,
                                       dtype=torch.float32, device=CPU)
    jctx = j_paged.PagedKVCache.create(d.layers, 2, d.kv_heads, 4,
                                       d.page_size, d.head_dim,
                                       dtype=jnp.float32)
    for li in range(d.layers):
        ctx.append(li, ks[li], vs[li], 0)
        jctx = jctx.append(li, jks[li], jvs[li], 0)
    ctx.advance(6)
    ctx.pad.copy_(torch.tensor([0, 2], dtype=torch.int32))
    jctx = jctx.advance(6)._replace(pad=jnp.asarray([0, 2], jnp.int32))
    q = rng.standard_normal((2, d.block_size, CFG.hidden)).astype(np.float32)
    hidden = jax.jit(lambda tr, x, c, n: spec.draft.apply(
        tr, x, c, n, 6, method=jdf.DFlashDraft.draft_hidden),
        static_argnums=3)
    for n_pages in (1, 2):
        got = ours.draft.draft_hidden(torch.from_numpy(q), ctx, n_pages, 6)
        _close(got, hidden(tree, jnp.asarray(q), jctx, n_pages))


def _prompt(model, image):
    patches, gh, gw = model.prepare_image(image)
    img = model.encode_image(patches, model.position_rows(gh, gw), gh, gw)
    ids, pids, _ = model.build_prompt(gh, gw, "OCR:")
    return model.fuse_embeds(ids, img), pids


def test_tapped_prefill_and_verify_block_match(pair):
    """prefill_aux, then one verify block of [tok, drafts] at the prompt's
    end (K4 at an int slot for block_size tokens), against the JAX
    module's methods."""
    from oar_ocr_tpu.vl.attention import create_causal_mask
    from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache
    from oar_ocr_tpu_torch.vl.kv_cache import KVCache

    spec, ours, _ = pair
    embeds, pids = _prompt(ours, _image())
    t, cap = embeds.shape[1], 256
    cache = KVCache.create(CFG.layers, 1, CFG.kv_heads, cap, CFG.head_dim,
                           dtype=torch.float32, device=CPU)
    full = torch.cat([hy.create_causal_mask(t).expand(1, 1, t, t),
                      torch.zeros((1, 1, t, cap - t), dtype=torch.bool)], -1)
    with torch.inference_mode():
        logits, aux = ours.net.prefill_aux(
            embeds, torch.from_numpy(pids)[:, None], cache, full,
            ours._aux_layers)
    jcache = JKVCache.create(CFG.layers, 1, CFG.kv_heads, cap, CFG.head_dim,
                             dtype=jnp.float32)
    jfull = jnp.concatenate([jnp.broadcast_to(create_causal_mask(t),
                                              (1, 1, t, t)),
                             jnp.zeros((1, 1, t, cap - t), bool)], -1)
    jl, _, jcache, jaux = jax.jit(functools.partial(
        spec.module.apply, method=jhy.HunyuanOCRModule.prefill_aux))(
        spec.params, jnp.asarray(embeds.numpy()),
        jnp.asarray(pids)[:, None], jcache, jfull)
    _close(logits, jl)
    _close(aux, jaux)
    cache.advance(t)
    jcache = jcache.advance(t)
    block = np.asarray([[int(logits.argmax()), 7, 8, 9]], np.int32)
    bp = (t + np.arange(4, dtype=np.int32))[None, None].repeat(4, 0)
    with torch.inference_mode():
        bl, baux = ours.net.decode_block_aux(
            torch.from_numpy(block), torch.from_numpy(bp), cache, t,
            ours._aux_layers)
    jbl, _, jcache, jbaux = jax.jit(functools.partial(
        spec.module.apply, method=jhy.HunyuanOCRModule.decode_block_aux))(
        spec.params, jnp.asarray(block), jnp.asarray(bp), jcache, t)
    _close(bl, jbl)
    _close(baux, jbaux)
    assert cache.length.tolist() == np.asarray(jcache.length).tolist() == \
        [t + 4]
    _close(cache.k[:, :, :, :t + 4], jcache.k[:, :, :, :t + 4])
    _close(cache.v[:, :, :, :t + 4], jcache.v[:, :, :, :t + 4])


@pytest.mark.parametrize("image_seed,max_new", [(1, 12), (4, 9)])
def test_speculative_ids_match_jax_and_greedy(pair, image_seed, max_new):
    spec, ours, _ = pair
    img = _image(image_seed)
    rounds = []
    got = ours.generate_speculative([img], max_new_tokens=max_new,
                                    rounds=rounds)
    assert got == spec.generate_speculative([img], max_new_tokens=max_new)
    assert got == ours.generate([img], max_new_tokens=max_new)
    assert rounds and all(0 <= a <= DCFG.block_size - 1 for a in rounds)


def test_forced_accept_round(pair):
    """The verify half fed the greedy decode's own next tokens accepts all
    block_size − 1 of them, emits the greedy's block_size tokens, and
    leaves the target cache and the draft context at prompt + block; the
    next round still follows the greedy ids."""
    _, ours, _ = pair
    k = DCFG.block_size - 1
    embeds, pids = _prompt(ours, _image())
    t = embeds.shape[1]
    pos = torch.from_numpy(pids)[:, None]
    greedy, _ = ours.prefill_decode(embeds, pos, max_new=2 * k + 4,
                                    capacity=256)
    greedy = greedy[0].tolist()
    tok, cache, ctx = ours.start(embeds, pos, max_new=2 * k + 4)
    assert int(tok[0]) == greedy[0]
    emitted, n_acc, tok = ours.verify_block(
        tok, torch.tensor([greedy[1:1 + k]], dtype=torch.int32), cache, ctx,
        t)
    assert n_acc == k
    assert emitted[0].tolist() == greedy[1:2 + k]
    assert cache.length.tolist() == ctx.length.tolist() == [t + k + 1]
    drafts = ours.draft_block(tok, ctx, t + k + 1)
    emitted, n_acc, _ = ours.verify_block(tok, drafts, cache, ctx, t + k + 1)
    assert emitted[0, :n_acc + 1].tolist() == \
        greedy[2 + k:3 + k + n_acc]


def test_kernel_sites_per_round(pair, monkeypatch):
    """A verify block is one target forward: K3 twice a layer, K4 once a
    layer (at the round's int slot, for block_size tokens)."""
    _, ours, _ = pair
    calls = {"k3": 0, "k4": []}
    real_k3, real_k4 = fnr.fused_add_rmsnorm, fnr.fused_qk_norm_rope_qk

    def k3(*a, **kw):
        calls["k3"] += 1
        return real_k3(*a, **kw)

    def k4(q, *a, **kw):
        calls["k4"].append((q.shape[1], kw.get("slot")))
        return real_k4(q, *a, **kw)

    embeds, pids = _prompt(ours, _image())
    tok, cache, ctx = ours.start(embeds, torch.from_numpy(pids)[:, None],
                                 max_new=8)
    monkeypatch.setattr(hy, "fused_add_rmsnorm", k3)
    monkeypatch.setattr(hy, "fused_qk_norm_rope_qk", k4)
    drafts = ours.draft_block(tok, ctx, embeds.shape[1])
    ours.verify_block(tok, drafts, cache, ctx, embeds.shape[1])
    assert calls["k3"] == 2 * CFG.layers
    assert calls["k4"] == [(DCFG.block_size, None)] * CFG.layers


def test_default_draft_over_default_target_raises_in_both():
    """The default DFlashConfig (hidden 2048) over the default
    HunyuanOCRConfig (hidden 1024): the port raises ConfigError naming
    both widths before any weight is made; the JAX constructor's draft
    init fails with flax's shape error (shown without making the
    target's weights, under jax.eval_shape)."""
    with pytest.raises(ConfigError, match="as wide as its target") as e:
        hy.HunyuanOCRSpeculative(runtime=Runtime("float32", device="cpu"))
    assert e.value.context["draft_hidden"] == 2048
    assert e.value.context["target_hidden"] == 1024
    from flax.errors import ScopeParamShapeError

    d = jdf.DFlashConfig()
    with pytest.raises(ScopeParamShapeError):
        jax.eval_shape(_draft_init(jdf.DFlashDraft(d),
                                   jhy.HunyuanOCRConfig().hidden, d),
                       jax.random.PRNGKey(0))
    # as wide as the target, the same draft config builds in both
    wide = dataclasses.replace(d, hidden=1024, vocab_size=120818)
    jax.eval_shape(_draft_init(jdf.DFlashDraft(wide), 1024, wide),
                   jax.random.PRNGKey(0))
    dflash.check_draft_fits(dflash.DFlashConfig(hidden=1024,
                                                vocab_size=120818),
                            1024, 24)


def test_out_of_range_taps_raise_in_both():
    bad = dataclasses.replace(DCFG, target_layer_ids=(0, 5))
    with pytest.raises(InvalidInputError, match="out of range"):
        hy.HunyuanOCRSpeculative(cfg=CFG, dflash_cfg=bad,
                                 runtime=Runtime("float32", device="cpu"))
    from oar_ocr_tpu.errors import InvalidInputError as JInvalidInputError

    with pytest.raises(JInvalidInputError, match="out of range"):
        jhy.HunyuanOCRSpeculative(
            cfg=J_CFG, dflash_cfg=dataclasses.replace(J_DCFG,
                                                      target_layer_ids=(0, 5)),
            runtime=_j_runtime())

"""The port's VL paths under a bfloat16 Runtime against the JAX package's.

The JAX package keeps every parameter float32 and casts only the vision
input to the compute dtype, so under ``compute_dtype="bfloat16"`` its
vision towers compute in bfloat16 while its decoders, KV caches and
logits stay float32 (``oar_ocr_tpu_torch/vl/model.apply_dtype_policy``
cites the lines). HunyuanOCR's perceive projector is float32 there too:
its first RMSNorm multiplies by a float32 scale. The port follows that
policy; these tests hold it to the JAX side on the tiny configs, with
the same numpy-seeded weights carried across by ``*_params_from_jax``
(JAX: ``RuntimeConfig(compute_dtype="bfloat16", use_mesh=False)``;
port: ``Runtime("bfloat16", device="cpu")``).

Gates:

- dtypes: decoder parameters, LM head, fused embeddings, KV cache and
  logits float32, vision parameters bfloat16 (the perceive float32), and
  every activation the same dtype as the JAX side's;
- vision output: max|got − ref| ≤ 2^-5·max|ref|. bfloat16 keeps 8
  significant bits, so an element near max|ref| has an ulp of up to
  2^-7·max|ref|. The two frameworks round the towers' intermediates
  (products, GELU, LayerNorm, softmax, residual sums) at different
  points, each by up to half an ulp, and over the tiny towers' two
  layers that stays within a few ulps of the largest output; the gate
  is 4 of them. The readings on the CPU were 1.1e-2 (PaddleOCR-VL) and
  7.9e-3 to 1.2e-2 (HunyuanOCR), 1-1.5 ulps;
- prefill logits, both decoders fed the JAX side's own fused (float32)
  embeddings: ≤ 1e-4·max|logit|, float32 against float32, as the
  float32 parity tests;
- greedy ids through ``generate``: identical.
"""

import dataclasses

import numpy as np
import pytest

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
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import (hunyuan_params_from_jax,
                                               vl_params_from_jax)
from oar_ocr_tpu_torch.vl import PaddleOCRVL, PaddleOCRVLConfig
from oar_ocr_tpu_torch.vl import hunyuan as hy
from oar_ocr_tpu_torch.vl import kv_cache
from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

VL_CFG = PaddleOCRVLConfig().tiny()
_IDS = dict(bos_id=1, eos_id=2, image_start_id=500, image_end_id=501,
            image_token_id=502)
HY_CFG = dataclasses.replace(hy.HunyuanOCRConfig().tiny(), **_IDS)
J_HY_CFG = dataclasses.replace(jhy.HunyuanOCRConfig().tiny(), **_IDS)
VISION_REL = 2.0 ** -5
LOGIT_TOL = 1e-4
# the submodules the policy puts in the compute dtype (the rest float32)
VISION = {"vl": ("visual.", "mlp_AR."),
          "hunyuan": ("vit.embeddings.", "vit.layers.")}


def _j_runtime():
    return JRuntime(JRuntimeConfig(compute_dtype="bfloat16", use_mesh=False))


def _images(path):
    rng = np.random.default_rng(5 if path == "vl" else 11)
    second = (120, 56, 3) if path == "vl" else (40, 28, 3)
    return [rng.integers(0, 256, (60, 90, 3), np.uint8),
            rng.integers(0, 256, second, np.uint8)]


class _CacheDtypes:
    """Records the dtype of every KV cache the port creates."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = kv_cache.KVCache.create.__func__

        def create(cls, *a, dtype, **k):
            self.seen.append(dtype)
            return real(cls, *a, dtype=dtype, **k)

        monkeypatch.setattr(kv_cache.KVCache, "create", classmethod(create))


@pytest.fixture(scope="module")
def vl_run():
    """Both sides' vision output, fused embeddings and prefill logits of
    a 2-image left-padded batch, the port's prefill fed the JAX side's
    fused embeddings."""
    jm = JPaddleOCRVL(cfg=VL_CFG, runtime=_j_runtime())
    ours = PaddleOCRVL(vl_params_from_jax(flatten_params(jm.params)),
                       cfg=VL_CFG, runtime=Runtime("bfloat16", device="cpu"))
    batch = ours.prepare_vision(_images("vl"), "ocr")
    img = ours.encode_vision(batch)
    j_img = jm._encode_vision(
        jm.params, jnp.asarray(batch.patches, jnp.bfloat16),
        jnp.asarray(np.arange(batch.patches.shape[1])[None]
                    < batch.valid_len[:, None]),
        jnp.asarray(batch.h_ids), jnp.asarray(batch.w_ids),
        jnp.asarray(batch.pos_embed, jnp.bfloat16))
    prompts = ours.build_prompts(batch, "ocr")
    embeds = ours.fuse_embeds(prompts, img)
    j_embeds = jm._fuse_embeds(
        jm.params, jnp.asarray(prompts.ids), j_img,
        jnp.asarray(prompts.starts), jnp.asarray(prompts.counts))
    capacity = decoder_cache_capacity(prompts.ids.shape[1], 4)
    _, logits = ours.prefill_decode(
        torch.from_numpy(np.array(j_embeds)),
        torch.from_numpy(prompts.positions),
        torch.from_numpy(prompts.valid_lengths), max_new=0,
        capacity=capacity)
    b, t = prompts.ids.shape
    vl = jnp.asarray(prompts.valid_lengths)
    full = jatt.combine_masks(jatt.create_causal_mask(t),
                              jatt.create_left_padding_mask(vl, t))
    full = jnp.concatenate([jnp.broadcast_to(full, (b, 1, t, t)),
                            jnp.zeros((b, 1, t, capacity - t), bool)], -1)
    cache = JKVCache.create(VL_CFG.layers, b, VL_CFG.kv_heads, capacity,
                            VL_CFG.head_dim, dtype=j_embeds.dtype)
    j_logits, _ = jm.module.apply(
        jm.params, j_embeds, jnp.asarray(prompts.positions),
        cache.with_pad(t - vl), full, method=PaddleOCRVLModule.prefill)
    return dict(jm=jm, ours=ours, img=img, j_img=j_img, embeds=embeds,
                j_embeds=j_embeds, logits=logits, j_logits=j_logits)


@pytest.fixture(scope="module")
def hy_run():
    """The same for HunyuanOCR's first image."""
    jm = jhy.HunyuanOCRModel(cfg=J_HY_CFG, seed=3, runtime=_j_runtime())
    ours = hy.HunyuanOCRModel(hunyuan_params_from_jax(flatten_params(
        jm.params)), cfg=HY_CFG, runtime=Runtime("bfloat16", device="cpu"))
    patches, gh, gw = ours.prepare_image(_images("hunyuan")[0])
    pos = ours.position_rows(gh, gw)
    img = ours.encode_image(patches, pos, gh, gw)
    j_img = jm._encode(jm.params, jnp.asarray(patches, jnp.bfloat16),
                       jnp.asarray(pos, jnp.bfloat16), gh=gh, gw=gw)
    ids, pids, n_img = ours.build_prompt(gh, gw, "OCR:")
    embeds = ours.fuse_embeds(ids, img)
    j_embeds = jm.module.apply(jm.params, jnp.asarray(ids)[None],
                               method=jhy.HunyuanOCRModule.embed)
    j_embeds = j_embeds.at[0, 2:2 + n_img].set(j_img)
    capacity, t = 256, len(ids)
    _, logits = ours.prefill_decode(torch.from_numpy(np.array(j_embeds)),
                                    torch.from_numpy(pids)[:, None],
                                    max_new=0, capacity=capacity)
    full = jnp.concatenate([jnp.broadcast_to(jatt.create_causal_mask(t),
                                             (1, 1, t, t)),
                            jnp.zeros((1, 1, t, capacity - t), bool)], -1)
    cache = JKVCache.create(HY_CFG.layers, 1, HY_CFG.kv_heads, capacity,
                            HY_CFG.head_dim, dtype=j_embeds.dtype)
    j_logits, _, _ = jm.module.apply(
        jm.params, j_embeds, jnp.asarray(pids)[:, None, :], cache, full,
        method=jhy.HunyuanOCRModule.prefill)
    return dict(jm=jm, ours=ours, img=img, j_img=j_img, embeds=embeds,
                j_embeds=j_embeds, logits=logits, j_logits=j_logits)


@pytest.fixture(params=["vl", "hunyuan"])
def run(request):
    return request.param, request.getfixturevalue(
        "vl_run" if request.param == "vl" else "hy_run")


def test_dtypes_match_jax(run, monkeypatch):
    path, r = run
    for name, p in r["ours"].net.named_parameters():
        want = (torch.bfloat16 if name.startswith(VISION[path])
                else torch.float32)
        assert p.dtype == want, name
    lm = (r["ours"].net.lm_head.weight if path == "vl"
          else r["ours"].net.model.embed_tokens.weight)
    assert lm.dtype == torch.float32
    # each activation in the JAX side's dtype: the image embeddings
    # bfloat16 (VL) or float32 (HunyuanOCR's perceive), the rest float32
    for got, ref in ((r["img"], r["j_img"]), (r["embeds"], r["j_embeds"]),
                     (r["logits"], r["j_logits"])):
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    assert r["embeds"].dtype == r["logits"].dtype == torch.float32
    caches = _CacheDtypes(monkeypatch)
    ours = r["ours"]
    # a (batch, capacity) key's static cache outlives its request: drop
    # the fixture's, so this request makes the cache it decodes in
    ours.decode_graphs.states.clear()
    if path == "vl":
        ours.generate(_images(path)[:1], "ocr", max_new_tokens=1)
    else:
        ours.generate(_images(path)[:1], max_new_tokens=1)
    assert caches.seen == [torch.float32]


def test_vision_matches_jax(run):
    _, r = run
    got = r["img"].float().numpy()
    ref = np.asarray(r["j_img"], np.float32)
    assert got.shape == ref.shape and np.isfinite(ref).all()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert rel <= VISION_REL, rel


def test_prefill_logits_match(run):
    _, r = run
    got, ref = r["logits"].numpy(), np.asarray(r["j_logits"])
    assert got.shape == ref.shape and np.isfinite(ref).all()
    err = float(np.abs(got - ref).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(ref).max())), err


def test_generate_ids_match(run):
    """The whole request in bfloat16 on both sides, vision included: the
    same greedy ids (and, for HunyuanOCR, the same ids from the JAX scan
    fed the port's embeddings)."""
    path, r = run
    jm, ours = r["jm"], r["ours"]
    if path == "vl":
        imgs = _images(path)
        ref = jm.generate(imgs, "ocr", max_new_tokens=6)
        got = ours.generate(imgs, "ocr", max_new_tokens=6)
        assert [g.token_ids for g in got] == [g.token_ids for g in ref]
        assert all(len(g.token_ids) > 0 for g in got), "vacuous comparison"
        return
    img = _images(path)[1]
    patches, gh, gw = ours.prepare_image(img)
    ids, pids, _ = ours.build_prompt(gh, gw, "OCR:")
    embeds = ours.fuse_embeds(ids, ours.encode_image(
        patches, ours.position_rows(gh, gw), gh, gw))
    got, _ = ours.prefill_decode(embeds, torch.from_numpy(pids)[:, None],
                                 max_new=6, capacity=256)
    ref = jm._gen(jm.params, jnp.asarray(embeds.numpy()),
                  jnp.asarray(pids)[:, None, :], max_new=6, capacity=256)
    assert got.numpy().tolist() == np.asarray(ref).tolist()
    assert int(got[0, 0]) != HY_CFG.eos_id, "vacuous comparison"
    assert ours.generate([img], max_new_tokens=6) == \
        jm.generate([img], max_new_tokens=6)

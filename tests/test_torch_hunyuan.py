"""The port's HunyuanOCR generate path against the JAX HunyuanOCRModel.

One JAX instance on ``HunyuanOCRConfig().tiny()`` with a float32 JAX
Runtime; the port loads its parameters through
``hunyuan_params_from_jax`` and runs on the CPU in float32 (its kernels'
plain versions: K2 ``flash_attention_ref``, K3 ``add_rmsnorm_ref``, K4
``qk_norm_rope_ref``). The tiny config keeps the published special token
ids, which lie outside its 512-token vocabulary (the JAX embedding then
returns NaN rows), so both sides use the same config with those ids moved
into the vocabulary. Gates: host preprocessing and position ids equal,
vision output and prefill logits within 1e-4 of the largest magnitude
(float32, sums in another order), generated ids identical.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.ppocr_maps import build_hunyuan_map
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.weights import flatten_params
from oar_ocr_tpu.vl import hunyuan as jhy
from oar_ocr_tpu.vl import processing as jproc
from oar_ocr_tpu_torch.errors import ConfigError
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import hunyuan_params_from_jax
from oar_ocr_tpu_torch.vl import PaddleOCRVL, PaddleOCRVLConfig
from oar_ocr_tpu_torch.vl import hunyuan as hy
from oar_ocr_tpu_torch.vl import processing as proc

REPO = Path(__file__).resolve().parents[1]
_IDS = dict(bos_id=1, eos_id=2, image_start_id=500, image_end_id=501,
            image_token_id=502)
CFG = dataclasses.replace(hy.HunyuanOCRConfig().tiny(), **_IDS)
J_CFG = dataclasses.replace(jhy.HunyuanOCRConfig().tiny(), **_IDS)
TOL = 1e-4


def _images():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (60, 90, 3), np.uint8),
            rng.integers(0, 256, (40, 28, 3), np.uint8)]


@pytest.fixture(scope="module")
def pair():
    jm = jhy.HunyuanOCRModel(cfg=J_CFG, seed=3, runtime=JRuntime(
        JRuntimeConfig(compute_dtype="float32", use_mesh=False)))
    flat = flatten_params(jm.params)
    ours = hy.HunyuanOCRModel(hunyuan_params_from_jax(flat), cfg=CFG,
                              runtime=Runtime("float32", device="cpu"))
    return jm, ours, flat


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(ref).all()
    err = float(np.abs(got - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


def test_config_matches_jax():
    for ours, ref in [(hy.HunyuanOCRConfig(), jhy.HunyuanOCRConfig()),
                      (hy.HunyuanOCRConfig().tiny(),
                       jhy.HunyuanOCRConfig().tiny())]:
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.v_grid, ours.merged_dim) == (ref.v_grid, ref.merged_dim)


@pytest.mark.parametrize("h,w,max_tokens", [
    (1280, 960, 4096), (60, 90, 4096), (3000, 500, 256), (900, 7000, 1024),
    (40, 28, 12), (4000, 4000, 4096)])
def test_resize_rules_match(h, w, max_tokens):
    cfg = proc.VisionProcessorConfig(16, 2, 1024, 16_777_216)
    j_cfg = jproc.VisionProcessorConfig(16, 2, 1024, 16_777_216)
    got = proc.smart_resize_token_limited(h, w, cfg, max_tokens)
    assert got == jproc.smart_resize_token_limited(h, w, j_cfg, max_tokens)
    assert proc.clamp_to_max_image_size(*got, 32, 2048) == \
        jproc.clamp_to_max_image_size(*got, 32, 2048)
    assert proc.clamp_to_max_image_size(h, w, 32, 1024) == \
        jproc.clamp_to_max_image_size(h, w, 32, 1024)


@pytest.mark.parametrize("seq_len,first,hm,wm", [
    (12, 2, 2, 2), (1249, 2, 40, 30), (219, 2, 14, 14), (9, 0, 1, 3)])
def test_build_position_ids_match(seq_len, first, hm, wm):
    np.testing.assert_array_equal(
        hy.build_position_ids(seq_len, first, hm, wm),
        jhy.build_position_ids(seq_len, first, hm, wm))


@pytest.mark.parametrize("out_h,out_w", [(5, 7), (8, 8), (80, 60), (1, 3)])
def test_interpolate_positions_match(out_h, out_w):
    table = np.random.default_rng(4).standard_normal((64, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(hy.interpolate_positions(table, 8, out_h,
                                                           out_w),
                                  jhy.interpolate_positions(table, 8, out_h,
                                                            out_w))


@pytest.mark.parametrize("index", [0, 1])
def test_host_preprocessing_matches(pair, index):
    jm, ours, _ = pair
    img = _images()[index]
    got, ref = ours.prepare_image(img), jm._prepare_image(img)
    assert got[1:] == ref[1:]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(ours._pos_table, jm._pos_table)


def test_weight_names_and_layouts(pair):
    """hunyuan_params_from_jax gives exactly the network's state_dict keys
    and shapes, and the JAX converter (build_hunyuan_map) maps it back to
    the JAX parameters bit for bit."""
    jm, ours, flat = pair
    sd = hunyuan_params_from_jax(flat)
    net_sd = ours.net.state_dict()
    assert set(sd) == set(net_sd)
    for name, v in sd.items():
        assert tuple(v.shape) == tuple(net_sd[name].shape), name
    cm = build_hunyuan_map(jm.params)
    hf = {k: v.numpy() for k, v in sd.items()}
    assert cm.unused_sources(hf) == []
    back = flatten_params(cm.convert(hf, strict=True))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v))


@pytest.fixture(scope="module")
def prefill_pair(pair):
    """Vision output, fused embeddings and prefill logits of image 0."""
    jm, ours, _ = pair
    patches, gh, gw = ours.prepare_image(_images()[0])
    pos = jhy.interpolate_positions(jm._pos_table[1:], J_CFG.v_grid, gh, gw)
    np.testing.assert_array_equal(ours.position_rows(gh, gw), pos)
    img = ours.encode_image(patches, ours.position_rows(gh, gw), gh, gw)
    j_img = jm._encode(jm.params, jnp.asarray(patches), jnp.asarray(pos),
                       gh=gh, gw=gw)
    ids, pids, n_img = ours.build_prompt(gh, gw, "OCR:")
    assert img.shape == (n_img, CFG.hidden)
    embeds = ours.fuse_embeds(ids, img)
    j_embeds = jm.module.apply(jm.params, jnp.asarray(ids)[None],
                               method=jhy.HunyuanOCRModule.embed)
    j_embeds = j_embeds.at[0, 2:2 + n_img].set(j_img)
    capacity = 256
    _, logits = ours.prefill_decode(embeds, torch.from_numpy(pids)[:, None],
                                    max_new=0, capacity=capacity)
    # the JAX prefill as _prefill_decode runs it (hunyuan.py:465-473)
    from oar_ocr_tpu.vl.attention import create_causal_mask
    from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache

    t = len(ids)
    cache = JKVCache.create(CFG.layers, 1, CFG.kv_heads, capacity,
                            CFG.head_dim, dtype=jnp.float32)
    full = jnp.concatenate([jnp.broadcast_to(create_causal_mask(t),
                                             (1, 1, t, t)),
                            jnp.zeros((1, 1, t, capacity - t), bool)], -1)
    j_logits, _, _ = jm.module.apply(
        jm.params, j_embeds, jnp.asarray(pids)[:, None, :], cache, full,
        method=jhy.HunyuanOCRModule.prefill)
    return (img.numpy(), np.asarray(j_img), embeds.numpy(),
            np.asarray(j_embeds), logits.numpy(), np.asarray(j_logits))


def test_vision_output_matches(prefill_pair):
    _close(prefill_pair[0], prefill_pair[1])


def test_fused_embeds_match(prefill_pair):
    _close(prefill_pair[2], prefill_pair[3])


def test_prefill_logits_match(prefill_pair):
    logits, j_logits = prefill_pair[4:]
    assert logits.shape == (1, CFG.vocab_size)
    _close(logits, j_logits)


@pytest.mark.parametrize("index,max_new", [(0, 10), (1, 6)])
def test_generate_ids_match(pair, index, max_new):
    """The same greedy ids (the device loop against the JAX scan) and the
    same decoded text through ``generate``."""
    jm, ours, _ = pair
    img = _images()[index]
    patches, gh, gw = ours.prepare_image(img)
    ids, pids, _ = ours.build_prompt(gh, gw, "OCR:")
    embeds = ours.fuse_embeds(ids, ours.encode_image(
        patches, ours.position_rows(gh, gw), gh, gw))
    capacity = hy.decoder_cache_capacity(len(ids), max_new)
    got, _ = ours.prefill_decode(embeds, torch.from_numpy(pids)[:, None],
                                 max_new=max_new, capacity=capacity)
    ref = jm._gen(jm.params, jnp.asarray(embeds.numpy()),
                  jnp.asarray(pids)[:, None, :], max_new=max_new,
                  capacity=capacity)
    assert got.numpy().tolist() == np.asarray(ref).tolist()
    assert int(got[0, 0]) != CFG.eos_id, "vacuous comparison"
    assert ours.generate([img], max_new_tokens=max_new) == \
        jm.generate([img], max_new_tokens=max_new)


def test_batched_decoder_matches_jax(pair):
    """Two rows with distinct per-axis XDRoPE positions through prefill
    and greedy decode (K4 takes each row's own tables)."""
    jm, ours, _ = pair
    rng = np.random.default_rng(3)
    ids = rng.integers(3, CFG.vocab_size, (2, 9)).astype(np.int32)
    pids = np.broadcast_to(np.arange(9, dtype=np.int32)[None, None],
                           (4, 2, 9)).copy()
    pids[1] += 1
    pids[2] += 2
    pids[3] = 0
    with torch.inference_mode():
        embeds = ours.net.model.embed_tokens(torch.from_numpy(ids))
    got, logits = ours.prefill_decode(embeds, torch.from_numpy(pids),
                                      max_new=4, capacity=256)
    j_embeds = jm.module.apply(jm.params, jnp.asarray(ids),
                               method=jhy.HunyuanOCRModule.embed)
    ref = jm._gen(jm.params, j_embeds, jnp.asarray(pids), max_new=4,
                  capacity=256)
    assert got.numpy().tolist() == np.asarray(ref).tolist()
    from oar_ocr_tpu.vl.attention import create_causal_mask
    from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache

    cache = JKVCache.create(CFG.layers, 2, CFG.kv_heads, 9, CFG.head_dim,
                            dtype=jnp.float32)
    j_logits, _, _ = jm.module.apply(
        jm.params, j_embeds, jnp.asarray(pids), cache,
        jnp.broadcast_to(create_causal_mask(9), (2, 1, 9, 9)),
        method=jhy.HunyuanOCRModule.prefill)
    _close(logits.numpy(), np.asarray(j_logits))


def test_kernel_sites_per_forward(pair, monkeypatch):
    """K4 once per layer, for q and k of every batch row, and K3 twice
    per layer (layer 0's input norm is plain, the final norm fused) in
    every forward: prefill + max_new decode steps, at batch 1 through
    ``generate`` and at batch 2 through ``prefill_decode``."""
    _, ours, _ = pair
    calls = {"k3": 0, "k4": 0}
    real_k3, real_k4 = fnr.fused_add_rmsnorm, fnr.fused_qk_norm_rope_qk

    def k3(*a, **k):
        calls["k3"] += 1
        return real_k3(*a, **k)

    def k4(*a, **k):
        calls["k4"] += 1
        return real_k4(*a, **k)

    monkeypatch.setattr(hy, "fused_add_rmsnorm", k3)
    monkeypatch.setattr(hy, "fused_qk_norm_rope_qk", k4)
    max_new = 3
    ours.generate(_images()[:1], max_new_tokens=max_new)
    want = {"k3": 2 * CFG.layers * (1 + max_new),
            "k4": CFG.layers * (1 + max_new)}
    assert calls == want
    calls.update(k3=0, k4=0)
    with torch.inference_mode():
        embeds = ours.net.model.embed_tokens(torch.ones((2, 5),
                                                        dtype=torch.int64))
    pids = torch.arange(5, dtype=torch.int32).expand(4, 2, 5)
    ours.prefill_decode(embeds, pids, max_new=max_new, capacity=256)
    assert calls == want


def test_without_qk_norm_matches_jax():
    """``use_qk_norm=False`` takes the plain float32 rotary, as in JAX."""
    cfg = dataclasses.replace(CFG, use_qk_norm=False)
    jm = jhy.HunyuanOCRModel(
        cfg=dataclasses.replace(J_CFG, use_qk_norm=False), seed=5,
        runtime=JRuntime(JRuntimeConfig(compute_dtype="float32",
                                        use_mesh=False)))
    ours = hy.HunyuanOCRModel(
        hunyuan_params_from_jax(flatten_params(jm.params)), cfg=cfg,
        runtime=Runtime("float32", device="cpu"))
    img = _images()[1]
    assert ours.generate([img], max_new_tokens=5) == \
        jm.generate([img], max_new_tokens=5)


def test_seeded_weights_are_deterministic():
    a = hy.HunyuanOCRModel(cfg=CFG, runtime=Runtime("float32", "cpu"),
                           seed=7)
    b = hy.HunyuanOCRModel(cfg=CFG, runtime=Runtime("float32", "cpu"),
                           seed=7)
    for name, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[name]), name
    assert float(a.net.vit.perceive.image_newline.abs().max()) > 0
    img = _images()[0]
    assert a.generate([img], max_new_tokens=4) == \
        b.generate([img], max_new_tokens=4)


@pytest.mark.parametrize("make", [
    lambda: Runtime(),
    lambda: Runtime("float32", device="cuda"),
    lambda: hy.HunyuanOCRModel(cfg=CFG),
    lambda: PaddleOCRVL(cfg=PaddleOCRVLConfig().tiny()),
    lambda: OAROCRBuilder("general").build(),
])
def test_entry_points_need_a_card_or_cpu(make, monkeypatch):
    """Without a visible card, the default device raises ConfigError
    naming device="cpu"; nothing falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match='device="cpu"'):
        make()


def test_hunyuan_imports_no_jax():
    """The port's Hunyuan modules, the speculative machinery (DFlash,
    paged KV, verify) and the shared decoder load neither jax nor the JAX
    package (a fresh interpreter, since this test process imported
    both)."""
    code = ("import sys; import oar_ocr_tpu_torch.vl.hunyuan, "
            "oar_ocr_tpu_torch.vl.dflash, oar_ocr_tpu_torch.vl.paged_kv, "
            "oar_ocr_tpu_torch.vl.speculative, "
            "oar_ocr_tpu_torch.vl.decoder, "
            "oar_ocr_tpu_torch.vl.gated_delta; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc_ = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                           capture_output=True, text=True, timeout=120)
    assert proc_.returncode == 0, proc_.stdout + proc_.stderr

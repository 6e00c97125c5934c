"""The port's PaddleOCR-VL generate path against the JAX PaddleOCRVL.

One JAX instance on ``PaddleOCRVLConfig().tiny()`` with a float32 JAX
Runtime; the port loads its parameters through ``vl_params_from_jax``
and runs on the CPU in float32. Gates: host preprocessing equal, vision +
projector output and prefill logits within 1e-4 of the largest magnitude
(float32, sums taken in another order), generated ids identical.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.ppocr_maps import export_vl_format
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.weights import flatten_params
from oar_ocr_tpu.vl import attention as jatt
from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache
from oar_ocr_tpu.vl.model import PaddleOCRVL as JPaddleOCRVL
from oar_ocr_tpu.vl.model import _mrope_positions as j_mrope_positions
from oar_ocr_tpu.vl.paddleocr_vl import PaddleOCRVLModule
from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import (load_hf_vl_checkpoint,
                                               vl_params_from_jax)
from oar_ocr_tpu_torch.vl import PaddleOCRVL, PaddleOCRVLConfig
from oar_ocr_tpu_torch.vl import attention as tatt
from oar_ocr_tpu_torch.vl.kv_cache import KVCache, decoder_cache_capacity
from oar_ocr_tpu_torch.vl.model import _mrope_positions

REPO = Path(__file__).resolve().parents[1]
CFG = PaddleOCRVLConfig().tiny()
TOL = 1e-4


def _images():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (60, 90, 3), np.uint8),
            rng.integers(0, 256, (120, 56, 3), np.uint8)]


@pytest.fixture(scope="module")
def pair():
    jvlm = JPaddleOCRVL(cfg=CFG, runtime=JRuntime(JRuntimeConfig(
        compute_dtype="float32", use_mesh=False)))
    flat = flatten_params(jvlm.params)
    ours = PaddleOCRVL(vl_params_from_jax(flat), cfg=CFG,
                       runtime=Runtime("float32", device="cpu"))
    return jvlm, ours, flat


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("spotting", [False, True])
def test_host_preprocessing_matches(pair, spotting):
    jvlm, ours, _ = pair
    for img in _images():
        got, ref = (ours._prepare_image(img, spotting),
                    jvlm._prepare_image(img, spotting))
        assert got[1] == ref[1]
        for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
            np.testing.assert_array_equal(a, b)
        gh, gw = got[1]
        np.testing.assert_array_equal(ours._interp_pos_embed(gh, gw),
                                      jvlm._interp_pos_embed(gh, gw))


def test_mrope_positions_match():
    row = [5, 6, 101] + [100] * 6 + [102, 7, 8]
    got = _mrope_positions(row, 3, len(row) + 3, (2, 3), 100)
    ref = j_mrope_positions(row, 3, len(row) + 3, (2, 3), 100)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]


def _jax_vision(jvlm, batch):
    return np.asarray(jvlm._encode_vision(
        jvlm.params, jnp.asarray(batch.patches),
        jnp.asarray(np.arange(batch.patches.shape[1])[None]
                    < batch.valid_len[:, None]),
        jnp.asarray(batch.h_ids), jnp.asarray(batch.w_ids),
        jnp.asarray(batch.pos_embed)))


@pytest.fixture(scope="module")
def prefill_pair(pair):
    """Vision output and prefill logits of a 2-image left-padded batch."""
    jvlm, ours, _ = pair
    batch = ours.prepare_vision(_images(), "ocr")
    img = ours.encode_vision(batch)
    j_img = _jax_vision(jvlm, batch)
    prompts = ours.build_prompts(batch, "ocr")
    capacity = decoder_cache_capacity(prompts.ids.shape[1], 4)
    embeds = ours.fuse_embeds(prompts, img)
    _, logits = ours.prefill_decode(
        embeds, torch.from_numpy(prompts.positions),
        torch.from_numpy(prompts.valid_lengths), max_new=0,
        capacity=capacity)

    # the JAX prefill as _prefill_decode_impl runs it (model.py:179-191)
    j_embeds = jvlm._fuse_embeds(
        jvlm.params, jnp.asarray(prompts.ids), jnp.asarray(j_img),
        jnp.asarray(prompts.starts), jnp.asarray(prompts.counts))
    b, t = prompts.ids.shape
    cache = JKVCache.create(CFG.layers, b, CFG.kv_heads, capacity,
                            CFG.head_dim, dtype=jnp.float32)
    vl = jnp.asarray(prompts.valid_lengths)
    full = jatt.combine_masks(jatt.create_causal_mask(t),
                              jatt.create_left_padding_mask(vl, t))
    full = jnp.concatenate([jnp.broadcast_to(full, (b, 1, t, t)),
                            jnp.zeros((b, 1, t, capacity - t), bool)], -1)
    j_logits, _ = jvlm.module.apply(
        jvlm.params, j_embeds, jnp.asarray(prompts.positions),
        cache.with_pad(t - vl), full, method=PaddleOCRVLModule.prefill)
    return (img.numpy(), j_img, embeds.numpy(), np.asarray(j_embeds),
            logits.numpy(), np.asarray(j_logits))


def test_vision_output_matches(prefill_pair):
    img, j_img = prefill_pair[:2]
    assert img.shape[0] == 2 and np.isfinite(img).all()
    _close(img, j_img)


def test_fused_embeds_match(prefill_pair):
    _close(prefill_pair[2], prefill_pair[3])


def test_prefill_logits_match(prefill_pair):
    logits, j_logits = prefill_pair[4:]
    assert logits.shape == (2, CFG.vocab_size)
    _close(logits, j_logits)


@pytest.mark.parametrize("task,images,max_new", [
    ("ocr", slice(0, 2), 8),          # two sizes: left padding
    ("spotting", slice(0, 1), 6),     # Lanczos 2x pre-upscale
])
def test_generate_ids_match(pair, task, images, max_new):
    jvlm, ours, _ = pair
    imgs = _images()[images]
    ref = jvlm.generate(imgs, task, max_new_tokens=max_new)
    got = ours.generate(imgs, task, max_new_tokens=max_new)
    assert [r.token_ids for r in got] == [r.token_ids for r in ref]
    assert [r.num_prompt_tokens for r in got] == \
        [r.num_prompt_tokens for r in ref]
    assert [r.text for r in got] == [r.text for r in ref]
    assert all(len(r.token_ids) > 0 for r in got), "vacuous comparison"


def test_weight_names_and_layouts(pair):
    """vl_params_from_jax gives the JAX HF exporter's names and layouts
    (export_vl_format), which load strictly; a checkpoint file with those
    names loads into the same state_dict."""
    import safetensors.numpy

    _, ours, flat = pair
    sd = vl_params_from_jax(flat)
    hf = export_vl_format(pair[0].params)
    assert set(sd) == set(hf) == set(ours.net.state_dict())
    for name, v in hf.items():
        np.testing.assert_array_equal(sd[name].numpy(), v)
        assert tuple(ours.net.state_dict()[name].shape) == v.shape
    blob = safetensors.numpy.save({k: np.ascontiguousarray(v, np.float32)
                                   for k, v in hf.items()})
    loaded = load_hf_vl_checkpoint(blob)
    again = PaddleOCRVL(loaded, cfg=CFG, runtime=Runtime("float32", "cpu"))
    for name, v in again.net.state_dict().items():
        assert torch.equal(v, ours.net.state_dict()[name])


def test_runtime_error_propagates(pair, monkeypatch):
    _, ours, _ = pair

    def boom(self, batch):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(PaddleOCRVL, "encode_vision", boom)
    with pytest.raises(RuntimeError):
        ours.generate(_images(), "ocr", max_new_tokens=2)


def test_host_errors_degrade_per_image(pair, monkeypatch):
    """A host error in a batch retries image by image; an image that
    fails alone gives an empty result; a RuntimeError in the retry still
    propagates."""
    _, ours, _ = pair
    imgs = _images()
    want = [ours.generate([im], "ocr", max_new_tokens=3)[0] for im in imgs]
    real = PaddleOCRVL.prepare_vision

    def flaky(self, images, task):
        if len(images) > 1:
            raise ValueError("bad batch")
        if images[0].shape == imgs[1].shape:
            raise ValueError("bad image")
        return real(self, images, task)

    monkeypatch.setattr(PaddleOCRVL, "prepare_vision", flaky)
    got = ours.generate(imgs, "ocr", max_new_tokens=3)
    assert got[0] == want[0]
    assert (got[1].text, got[1].token_ids, got[1].num_prompt_tokens) == \
        ("", [], 0)

    def device_fault(self, images, task):
        if len(images) > 1:
            raise ValueError("bad batch")
        raise RuntimeError("flash_attention kernel launch failed")

    monkeypatch.setattr(PaddleOCRVL, "prepare_vision", device_fault)
    with pytest.raises(RuntimeError):
        ours.generate(imgs, "ocr", max_new_tokens=3)


def test_task_and_cache_limits(pair):
    """Unknown tasks raise; the table task converts OTSL to HTML as the JAX
    package does; the KV cache's rollback, fork and per-row methods equal
    the JAX cache's."""
    jvlm, ours, _ = pair
    with pytest.raises(InvalidInputError):
        ours.generate(_images(), "bogus")
    imgs = _images()
    assert [r.text for r in ours.generate(imgs, "table", max_new_tokens=4)] \
        == [r.text for r in jvlm.generate(imgs, "table", max_new_tokens=4)]
    assert ours.generate([], "ocr") == []
    assert [decoder_cache_capacity(*a) for a in
            [(100, 100), (300, 300), (1254, 128), (16000, 9000)]] == \
        [256, 1024, 2048, 16384]
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((1, 2, 1, 4, 2)).astype(np.float32)
            for _ in range(2))
    ln, pad = np.asarray([3, 1], np.int32), np.asarray([0, 1], np.int32)
    row = np.ones((2, 1, 1, 2), np.float32)
    slots = np.asarray([2, 3], np.int32)
    for op in ("trim_to", "copy_row", "keep_indices", "with_lengths",
               "append"):
        ours_c = KVCache(*(torch.from_numpy(a.copy()) for a in (k, v, ln,
                                                                 pad)))
        ref_c = JKVCache(*(jnp.asarray(a) for a in (k, v, ln, pad)))
        if op == "trim_to":
            got, want = ours_c.trim_to(1), ref_c.trim_to(1)
        elif op == "copy_row":
            got, want = ours_c.copy_row(0, 1, 2), ref_c.copy_row(0, 1, 2)
        elif op == "keep_indices":
            got = ours_c.keep_indices([1, 1, 0])
            want = ref_c.keep_indices(jnp.asarray([1, 1, 0]))
        elif op == "with_lengths":
            got = ours_c.with_lengths([2, 4])
            want = ref_c.with_lengths(jnp.asarray([2, 4]))
        else:
            got = ours_c.append(0, torch.from_numpy(row),
                                torch.from_numpy(row),
                                torch.from_numpy(slots))
            want = ref_c.append(0, jnp.asarray(row), jnp.asarray(row),
                                jnp.asarray(slots))
        for n in ("k", "v", "length", "pad"):
            np.testing.assert_array_equal(getattr(got, n).numpy(),
                                          np.asarray(getattr(want, n)))
    cache = KVCache.create(1, 1, 1, 4, 2, dtype=torch.float32,
                           device=torch.device("cpu"))
    assert cache.k_slot(0, torch.zeros(1, dtype=torch.int64), 1).data_ptr() \
        == cache.k[0].data_ptr()      # per-row slots: K4 writes the layer
    with pytest.raises(InvalidInputError):
        cache.append(0, torch.zeros(1, 1, 3, 2), torch.zeros(1, 1, 3, 2), 2)


def test_kv_cache_k_slot_and_v_alone():
    """``k_slot`` is the view a kernel writes k into; ``append`` with
    k None writes v alone; both check the capacity."""
    cache = KVCache.create(2, 1, 2, 8, 4, dtype=torch.float32,
                           device=torch.device("cpu"))
    slot = cache.k_slot(1, 3, 2)
    assert slot.shape == (1, 2, 2, 4)
    assert slot.data_ptr() == cache.k[1, 0, 0, 3].data_ptr()
    slot.fill_(1.0)
    cache.append(1, None, torch.full((1, 2, 2, 4), 2.0), 3)
    assert bool(cache.k[1, :, :, 3:5].eq(1).all()) and float(
        cache.k.sum()) == 16
    assert bool(cache.v[1, :, :, 3:5].eq(2).all()) and float(
        cache.v.sum()) == 32
    with pytest.raises(InvalidInputError):
        cache.k_slot(0, 7, 2)
    with pytest.raises(InvalidInputError):
        cache.append(0, None, torch.zeros(1, 2, 2, 4), 7)


def test_attention_helpers_match_jax():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 5, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 5, 8)).astype(np.float32)
    vl = np.array([5, 2], np.int32)
    j_mask = jatt.combine_masks(
        jatt.create_generation_mask(jnp.asarray([4, 5]), 5, jnp.asarray(vl)
                                    - 1), jnp.asarray(rng.random((1, 1, 3, 5))
                                                      > 0.3))
    mask = torch.from_numpy(np.array(j_mask))
    _close(tatt.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask),
        jatt.scaled_dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), j_mask))
    np.testing.assert_array_equal(
        tatt.create_generation_mask(torch.tensor([4, 5]), 5,
                                    torch.from_numpy(vl) - 1).numpy(),
        np.asarray(jatt.create_generation_mask(jnp.asarray([4, 5]), 5,
                                               jnp.asarray(vl) - 1)))
    np.testing.assert_array_equal(
        tatt.create_left_padding_mask(torch.from_numpy(vl), 5).numpy(),
        np.asarray(jatt.create_left_padding_mask(jnp.asarray(vl), 5)))
    pos = rng.integers(0, 900, (3, 2, 6)).astype(np.int32)
    for got, ref in zip(tatt.mrope_cos_sin(torch.from_numpy(pos), 128,
                                           (16, 24, 24), 500000.0),
                        jatt.mrope_cos_sin(jnp.asarray(pos), 128,
                                           (16, 24, 24), 500000.0)):
        _close(got, ref)


def test_vl_imports_no_jax():
    """The port's VL paths (PaddleOCR-VL, HunyuanOCR, the families, the
    exact stacks, the HPD scheduler, DocParser and their host helpers)
    and the CLI load neither jax nor the JAX package (a fresh
    interpreter, since this test process already imported both)."""
    code = ("import sys; import oar_ocr_tpu_torch.vl.model, "
            "oar_ocr_tpu_torch.vl, oar_ocr_tpu_torch.vl.hunyuan, "
            "oar_ocr_tpu_torch.vl.families, oar_ocr_tpu_torch.vl.otsl, "
            "oar_ocr_tpu_torch.vl.mineru_layout, "
            "oar_ocr_tpu_torch.vl.sampling, "
            "oar_ocr_tpu_torch.vl.diffusion, "
            "oar_ocr_tpu_torch.vl.vision_towers, "
            "oar_ocr_tpu_torch.vl.llm_decoders, "
            "oar_ocr_tpu_torch.vl.exact_models, "
            "oar_ocr_tpu_torch.vl.hpd_scheduler, "
            "oar_ocr_tpu_torch.vl.text_format, "
            "oar_ocr_tpu_torch.vl.doc_parser, "
            "oar_ocr_tpu_torch.runtime.convert_maps, "
            "oar_ocr_tpu_torch.runtime.ppocr_maps, oar_ocr_tpu_torch.cli; "
            "from oar_ocr_tpu_torch.vl import FAMILY_CLASSES, DocParser; "
            "from oar_ocr_tpu_torch.vl.exact_models import hpd_fork_exact; "
            "from oar_ocr_tpu_torch.runtime.runtime import Runtime; "
            "hpd_fork_exact(tiny=True, runtime=Runtime('float32', "
            "device='cpu')).scheduler(True); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


TOKENIZER = REPO / "assets" / "test_tokenizer.json"


@pytest.mark.parametrize("text", ["User: OCR: Total amount due: $1,234.56",
                                  "Table Recognition:\nAssistant: ", ""])
def test_hf_tokenizer_matches_jax(text):
    """HFTokenizer reads a real tokenizer.json through ``tokenizers`` and
    gives the JAX package's ids and text."""
    from oar_ocr_tpu.vl.model import HFTokenizer as JHFTokenizer
    from oar_ocr_tpu_torch.vl import HFTokenizer

    tok, ref = HFTokenizer(str(TOKENIZER)), JHFTokenizer(str(TOKENIZER))
    ids = tok.encode(text)
    assert ids == ref.encode(text)
    assert all(isinstance(i, int) for i in ids)
    assert tok.decode(ids) == ref.decode(ids)
    assert "".join(tok.decode(ids).split()) == "".join(text.split())


def test_generate_with_hf_tokenizer_matches_jax(pair):
    """The generate loop with real prompt ids from the HF tokenizer."""
    from oar_ocr_tpu.vl.model import HFTokenizer as JHFTokenizer
    from oar_ocr_tpu_torch.vl import HFTokenizer

    import copy

    jvlm, ours, _ = pair
    j_tok, t_ours = copy.copy(jvlm), copy.copy(ours)
    j_tok.tokenizer = JHFTokenizer(str(TOKENIZER))
    t_ours.tokenizer = HFTokenizer(str(TOKENIZER))
    img = _images()[0]
    got = t_ours.generate([img], "ocr", max_new_tokens=4)
    want = j_tok.generate([img], "ocr", max_new_tokens=4)
    assert [(r.text, r.token_ids, r.num_prompt_tokens) for r in got] == \
        [(r.text, r.token_ids, r.num_prompt_tokens) for r in want]

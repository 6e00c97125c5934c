"""The port's seven VLM families against the JAX package's, on the CPU.

Each family runs its ``tiny()`` config in float32 in both packages on the
same weights: the port's, seeded, carried into the JAX ``FamilyModule``
tree by ``torch_jax_tree`` (flax names → the port's by ``torch_name``;
every flax leaf found with its shape, and back). The gates: the fused
prompt embeddings within 1e-4 · max(1, max|ref|), and the entry points'
ids and texts identical — greedy ``generate``, the speculative paths
(MTP for GLM-OCR, DFlash for HunyuanOCR, also identical to the port's
own greedy ids), SDAR block diffusion, HPD's parent and forked children,
and the host helpers. MinerU's two steps and MonkeyOCRv2's tasks are in
``test_torch_mineru_layout.py``; the hybrid delta stack (OvisOCR2) and
the shared decoder's entry points in ``test_torch_spec_delta.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.vl import families as jfam
from oar_ocr_tpu_torch.errors import ConfigError, InvalidInputError
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl import families as fam
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa: F401

SEED = 5


def jax_family(ours):
    """The JAX family of ``ours``'s config on ``ours``'s weights."""
    cfg = ours.cfg
    jcfg = jax_config(cfg)
    module = jfam.FamilyModule(jcfg)
    m2 = cfg.vision.merge ** 2

    def init(r):
        return module.init(
            r, jnp.zeros((1, m2, cfg.vision.patch ** 2 * 3)),
            jnp.ones((1, m2), bool), jnp.zeros((1, 4), jnp.int32),
            jnp.zeros((3, 1, 4), jnp.int32),
            method=jfam.FamilyModule.init_all)

    tree = jax_tree_from_port(module, None, ours.module.state_dict(),
                              init=init)
    cls = jfam.FAMILY_CLASSES[cfg.name]
    return jfam.VLMFamily.__new__(cls), jcfg, tree


def make_pair(name, seed=SEED, cfg=None):
    """(port family, JAX family) on the port's seeded weights."""
    ours = fam.FAMILY_CLASSES[name](
        tiny=True, cfg=cfg, seed=seed,
        runtime=Runtime("float32", device="cpu"))
    ref, jcfg, tree = jax_family(ours)
    jfam.VLMFamily.__init__(ref, jcfg, tree, runtime=JRuntime(
        JRuntimeConfig(compute_dtype="float32", use_mesh=False)))
    if name == "mineru_diffusion":
        # the JAX subclass builds its jits in its own __init__
        import functools

        for attr, method in (("_bidir", "decode_block_bidir"),
                             ("_commit", "decode_block"),
                             ("_prefill_j", "prefill")):
            setattr(ref, attr, jax.jit(functools.partial(
                ref.module.apply,
                method=getattr(jfam.FamilyModule, method))))
    return ours, ref


def jax_config(cfg):
    """The JAX FamilyConfig equal to the port's ``cfg``."""
    d = cfg.decoder
    kw = dataclasses.asdict(cfg)
    kw["decoder"] = jfam.DecoderConfig(**dataclasses.asdict(d))
    kw["vision"] = jfam.VisionConfig(**dataclasses.asdict(cfg.vision))
    if cfg.dflash is not None:
        kw["dflash"] = jfam.DFlashConfig(**dataclasses.asdict(cfg.dflash))
    return jfam.FamilyConfig(**kw)


def _img(seed=0, h=64, w=96):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), err


def test_registry_and_configs_match_jax():
    assert set(fam.FAMILY_CONFIGS) == set(jfam.FAMILY_CONFIGS) == \
        set(fam.FAMILY_CLASSES) == set(jfam.FAMILY_CLASSES)
    for name, cfg in fam.FAMILY_CONFIGS.items():
        for ours, ref in ((cfg, jfam.FAMILY_CONFIGS[name]),
                          (cfg.tiny(), jfam.FAMILY_CONFIGS[name].tiny())):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert fam.OVIS_OCR2_PROMPT == jfam.OVIS_OCR2_PROMPT


_WIDE = {"hunyuanocr": (48, 8, 8), "glmocr": (16, 24, 24),
         "mineru": (16, 24, 24), "mineru_diffusion": (16, 24, 24)}


@pytest.mark.parametrize("name", sorted(_WIDE))
def test_head_dim_128_rope_sections(name):
    """The published head_dim-128 configs' sections cover 32 of 64
    frequency pairs: the JAX module fails to broadcast its rotary, the
    port raises ConfigError at construction. Sections covering 64 pairs
    build in both (two layers, shapes only)."""
    cfg = fam.FAMILY_CONFIGS[name]
    with pytest.raises(ConfigError, match="sections must sum"):
        with torch.device("meta"):
            fam.FamilyModule(cfg)

    def shapes(c):
        c = dataclasses.replace(c, vision=dataclasses.replace(
            c.vision, layers=1), decoder=dataclasses.replace(
            c.decoder, layers=2))
        if c.dflash is not None:
            c = dataclasses.replace(c, dflash=dataclasses.replace(
                c.dflash, target_layer_ids=(0, 1)))
        m2 = c.vision.merge ** 2
        module = jfam.FamilyModule(jax_config(c))
        return jax.eval_shape(lambda r: module.init(
            r, jnp.zeros((1, m2, c.vision.patch ** 2 * 3)),
            jnp.ones((1, m2), bool), jnp.zeros((1, 4), jnp.int32),
            jnp.zeros((3, 1, 4), jnp.int32),
            method=jfam.FamilyModule.init_all), jax.random.PRNGKey(0))

    with pytest.raises(TypeError, match="broadcast"):
        shapes(cfg)
    key = "mrope_sections" if cfg.decoder.rope_kind == "mrope" \
        else "xdrope_sections"
    wide = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, **{key: _WIDE[name]}))
    shapes(wide)
    with torch.device("meta"):
        fam.FamilyModule(wide)


@pytest.fixture(scope="module")
def glm():
    return make_pair("glmocr")


def test_glm_inputs_and_generate_match(glm):
    ours, ref = glm
    img = _img()
    e, p, vl, n = ours._build_inputs([img], "ocr")
    je, jp, jvl, jn = ref._build_inputs([img], "ocr")
    _close(e.numpy(), je)
    assert p.numpy().tolist() == np.asarray(jp).tolist()
    assert (vl.tolist(), n) == (jvl.tolist(), jn)
    for task in ("ocr", "table"):
        got = ours.generate([img], task, max_new_tokens=8)
        assert got == ref.generate([img], task, max_new_tokens=8)
    assert ours.generate([img], "ocr", max_new_tokens=6,
                         prompt="read:") == \
        ref.generate([img], "ocr", max_new_tokens=6, prompt="read:")
    with pytest.raises(InvalidInputError):
        ours.generate([img], "nope")
    assert ours.generate([]) == []


@pytest.mark.parametrize("seed,max_new", [(0, 9), (3, 12)])
def test_glm_mtp_speculative_matches(glm, seed, max_new):
    ours, ref = glm
    img = _img(seed)
    greedy = ours.generate([img], max_new_tokens=max_new)
    rounds = []
    spec = ours.generate_speculative([img], max_new_tokens=max_new,
                                     rounds=rounds)
    assert spec == greedy == ref.generate_speculative(
        [img], max_new_tokens=max_new)
    assert rounds and all(0 <= a <= ours.cfg.draft_len for a in rounds)


def test_glm_mtp_forced_accept(glm):
    """The MTP verify half fed the greedy ids accepts all of them and
    emits the greedy's next draft_len + 1 tokens."""
    ours, _ = glm
    k = ours.cfg.draft_len
    e, p, vl, _ = ours._build_inputs([_img(1)], "ocr")
    greedy = ours._generate_impl(e, p, vl, max_new=k + 3,
                                 capacity=256)[0].tolist()
    tok, hidden, cache, _ = ours._spec_start(e, p, vl, 256)
    emitted, n_acc, h, nxt = ours.mtp_verify(
        tok, torch.tensor([greedy[1:1 + k]], dtype=torch.int32), cache,
        p.amax(dim=(0, 2)) + 1, e.shape[1])
    assert n_acc == k and emitted[0].tolist() == greedy[1:2 + k]
    assert cache.length.tolist() == [e.shape[1] + k + 1]
    assert int(nxt[0]) == greedy[1 + k] and h.shape == (1, ours.cfg.decoder.hidden)


@pytest.fixture(scope="module")
def hunyuan():
    return make_pair("hunyuanocr", seed=7)


@pytest.mark.parametrize("seed,max_new", [(3, 16), (5, 10)])
def test_hunyuan_family_dflash_matches(hunyuan, seed, max_new):
    ours, ref = hunyuan
    img = _img(seed, 56, 56)
    greedy = ours.generate([img], max_new_tokens=max_new)
    assert greedy == ref.generate([img], max_new_tokens=max_new)
    rounds = []
    spec = ours.generate_speculative([img], max_new_tokens=max_new,
                                     rounds=rounds)
    assert spec == greedy == ref.generate_speculative(
        [img], max_new_tokens=max_new)
    assert 1 <= len(rounds) <= max_new


def test_hunyuan_family_dflash_forced_accept(hunyuan):
    ours, _ = hunyuan
    k = ours.cfg.dflash.block_size - 1
    e, p, vl, t = ours._build_inputs([_img(2, 56, 56)], "ocr")
    greedy = ours._generate_impl(e, p, vl, max_new=k + 3,
                                 capacity=256)[0].tolist()
    tok, cache, ctx = ours.dflash_start(e, p, vl, max_new=k + 3)
    emitted, n_acc, nxt = ours.dflash_round(
        tok, cache, ctx, p.amax(dim=(0, 2)) + 1, t,
        drafts=torch.tensor([greedy[1:1 + k]], dtype=torch.int32))
    assert n_acc == k and emitted[0].tolist() == greedy[1:2 + k]
    assert cache.length.tolist() == ctx.length.tolist() == [t + k + 1]


def test_mineru_diffusion_matches():
    ours, ref = make_pair("mineru_diffusion")
    img = _img()
    for kw in ({"max_new_tokens": 8, "num_unmask_steps": 3},
               {"max_new_tokens": 20, "num_unmask_steps": 4,
                "confidence_threshold": 0.0}):
        assert ours.generate([img], **kw) == ref.generate([img], **kw)


def test_hpd_forks_match(monkeypatch):
    """The parent pass, then children forked at two depths of the parent
    (``keep_indices`` + ``with_lengths``, per-row positions): random
    weights emit no ``<FORK>``, so both packages' fork finder is given
    the same two fork points."""
    assert fam._fork_points([1, 2, 3, 4, 2, 3, 9], [2, 3]) == \
        jfam._fork_points([1, 2, 3, 4, 2, 3, 9], [2, 3]) == [(3, 4), (6, 9)]
    assert fam._fork_points([1, 2], [2]) == []
    ours, ref = make_pair("hpd_parsing")
    img = _img()
    assert ours.parse_with_forks(img, max_new_tokens=6) == \
        ref.parse_with_forks(img, max_new_tokens=6)

    def forks(ids, pattern):
        return [(e, ids[e]) for e in (2, 5)]

    monkeypatch.setattr(fam, "_fork_points", forks)
    monkeypatch.setattr(jfam, "_fork_points", forks)
    got = ours.parse_with_forks(img, max_new_tokens=7)
    assert got == ref.parse_with_forks(img, max_new_tokens=7)
    assert got["stats"]["num_children"] == 2


def test_host_helpers_match_jax():
    text = ('Here: [{"bbox": [0.1, 0.1, 0.5, 0.2], "category": "text", '
            '"text": "hello"}, {"bbox": [100, 300, 900, 400], '
            '"category": "table", "content": "t"}]')
    for t, w, h in ((text, 1000, 800), ('[{"bbox": [0,0,1,1], "category": '
                                         '"text", "text": "a"}, {"bb',
                                         100, 100), ("garbage", 10, 10)):
        a = fam.monkey_end2end_to_structure(t, w, h)
        b = jfam.monkey_end2end_to_structure(t, w, h)
        assert [(e.element_type.value, e.box.tolist(), e.text, e.score)
                for e in a.elements] == \
            [(e.element_type.value, e.box.tolist(), e.text, e.score)
             for e in b.elements]
    for t in ('before\n\n<img src="images/bbox_1_2_3_4.jpg" />\n\nafter',
              "a\n\n<img src=\"other.jpg\" />\n\nb"):
        assert fam.filter_visual_image_tags(t) == \
            jfam.filter_visual_image_tags(t)
    for t in ("x" * 8000 + "abc" * 60, "abc" * 60,
              "y" * 7990 + "0123456789" * 12):
        assert fam.clean_truncated_repeats(t) == \
            jfam.clean_truncated_repeats(t)


def test_layout_min_pixels_raises_resize_floor():
    ours = fam.MonkeyOCRv2(tiny=True, runtime=Runtime("float32",
                                                      device="cpu"))
    ref = jfam.VLMFamily.__new__(jfam.MonkeyOCRv2)
    ref.cfg = jfam.FAMILY_CONFIGS["monkeyocrv2"].tiny()
    small = np.full((64, 64, 3), 128, np.uint8)
    floor = fam.FAMILY_CONFIGS["monkeyocrv2"].task_min_pixels["layout"]
    for kw in ({}, {"min_pixels": floor}):
        (p, g), (jp, jg) = ours._prepare_image(small, **kw), \
            ref._prepare_image(small, **kw)
        assert g == jg and np.array_equal(p, jp)
    hy = fam.HunyuanOCR(tiny=True, runtime=Runtime("float32", device="cpu"))
    ref.cfg = jfam.FAMILY_CONFIGS["hunyuanocr"].tiny()
    big = _img(1, 300, 500)
    (p, g), (jp, jg) = hy._prepare_image(big), ref._prepare_image(big)
    assert g == jg and np.array_equal(p, jp)


def test_vision_tower_kernel_sites(glm, monkeypatch):
    """K2 once a vision block, with the count of valid patches."""
    ours, _ = glm
    seen = []
    real = fam.flash_attention

    def k2(q, k, v, *, valid_len=None, causal=False):
        seen.append((q.shape, valid_len.tolist()))
        return real(q, k, v, valid_len=valid_len, causal=causal)

    monkeypatch.setattr(fam, "flash_attention", k2)
    ours._build_inputs([_img(0, 140, 210), _img(1, 40, 50)], "ocr")
    assert len(seen) == ours.cfg.vision.layers
    (shape, vlen), = set((tuple(s), tuple(v)) for s, v in seen)
    assert vlen[0] > vlen[1] and shape[2] == vlen[0]

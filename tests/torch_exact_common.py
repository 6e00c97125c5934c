"""Shared pieces of the exact-VLM tests (``test_torch_exact_models.py``,
``test_torch_exact_entry_points.py``, ``test_torch_hpd_scheduler.py``):
a JAX exact model on a port model's weights.

The port's seeded weights go into the JAX ``ExactVLMModule`` tree by
``torch_jax_tree`` (flax names → the port's HF names by ``torch_name``,
HPD's ``hpd_vision`` root dropped; every flax leaf found with its shape,
and back), so both packages run the same weights.
"""

import dataclasses

import numpy as np

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.vl import exact_models as jem
from oar_ocr_tpu.vl import llm_decoders as jld
from oar_ocr_tpu.vl import vision_towers as jvt
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl import exact_models as em
from torch_jax_tree import jax_tree_from_port

CPU_RT = dict(runtime=Runtime("float32", device="cpu"))
JRT = JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))
MAX_NEW = 6


def imgs():
    """Two seeded pages of different sizes (a left-padded batch)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (40, 56, 3), dtype=np.uint8),
            rng.integers(0, 255, (24, 48, 3), dtype=np.uint8)]


def jax_spec(ours):
    """The JAX (spec, vision config) equal to the port model's."""
    s = ours.spec
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    fields["text_cfg"] = jld.UnifiedLMConfig(
        **dataclasses.asdict(s.text_cfg))
    v = ours.vision_cfg
    return (jem.ExactVLMSpec(**fields),
            getattr(jvt, type(v).__name__)(**dataclasses.asdict(v)))


def jax_tree(ours):
    """The JAX parameter tree of ``ours``'s weights."""
    spec, vcfg = jax_spec(ours)
    shell = object.__new__(jem.ExactVLM)
    shell.spec, shell.vision_cfg = spec, vcfg
    shell.module = jem.ExactVLMModule(spec, vcfg)
    return jax_tree_from_port(shell.module, None, ours.net.state_dict(),
                              init=lambda r: shell._init_params(0))


def make_pair(factory, seed=3, **kw):
    """(port model, JAX model) of ``factory``'s tiny config on the port's
    seeded weights; the JAX model records its greedy ids in ``.toks``."""
    ours = getattr(em, factory)(tiny=True, seed=seed, **CPU_RT, **kw)
    spec, vcfg = jax_spec(ours)
    jcls = {"mineru_diffusion_exact": jem.SdarDiffusionExact,
            "glm_speculative_exact": jem.GlmSpeculativeExact,
            "hpd_fork_exact": jem.HpdForkExact}.get(factory, jem.ExactVLM)
    extra = {}
    if factory == "glm_speculative_exact":
        extra["mtp_params"] = jax_mtp_tree(ours)
    ref = jcls(spec, vcfg, jax_tree(ours), runtime=JRT, **extra)
    ref.toks = []
    gen = ref._gen

    def recording(*a, **k):
        out = gen(*a, **k)
        ref.toks.append(np.asarray(out))
        return out

    ref._gen = recording
    return ours, ref


def jax_mtp_tree(ours):
    import jax.numpy as jnp

    from oar_ocr_tpu.vl.kv_cache import KVCache as JKVCache

    c = ours.spec.text_cfg
    head = jld.GlmMtpHead(jld.UnifiedLMConfig(**dataclasses.asdict(c)))
    cache = JKVCache.create(1, 1, c.kv_heads, 8, c.head_dim,
                            dtype=jnp.float32)
    return jax_tree_from_port(head, None, ours.mtp.state_dict(), init=(
        lambda r: head.init(r, jnp.zeros((1, 1), jnp.int32),
                            jnp.zeros((1, 1, c.hidden), jnp.float32),
                            jnp.zeros((1, 1), jnp.int32), cache, 0,
                            jnp.ones((1, 1, 1, 8), bool))))


def check_generate(ours, ref):
    """A left-padded batch of two pages: ids and texts identical to JAX's
    (``ref`` from :func:`make_pair`); the fused prompt embeddings within
    1e-4 · max(1, max|ref|); each row equal to that page run alone."""
    pages = imgs()
    ids = []
    texts = ours.generate(pages, max_new_tokens=MAX_NEW, token_ids=ids)
    assert texts == ref.generate(pages, max_new_tokens=MAX_NEW)
    assert ids == ref.toks[-1].tolist()
    emb, _, t = ours.prepare_prompt(pages[0], "OCR:")
    jemb, _, jt = ref._prepare_prompt(pages[0], "OCR:")
    jemb = np.asarray(jemb)
    assert t == jt
    err = float(np.abs(emb.numpy() - jemb).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(jemb).max())), err
    for img, row in zip(pages, ids):
        one = []
        ours.generate([img], max_new_tokens=MAX_NEW, token_ids=one)
        assert one == [row]

"""The port's exact VLM stacks against the JAX package's, on the CPU.

Every factory runs its tiny config in float32 in both packages on the
port's seeded weights, carried into the JAX ``ExactVLMModule`` tree by
``torch_jax_tree`` (flax names → the port's HF names by ``torch_name``,
HPD's ``hpd_vision`` root dropped; every flax leaf found with its shape,
and back). The gates: the greedy ids and texts of a left-padded batch of
two pages identical to JAX's; the batch equal to single-page runs; the
weights and ids float32 under a
bfloat16 Runtime; the registry names and the tree roots. OvisOCR2's
hybrid stack is in ``test_torch_exact_hybrid.py``, the other entry
points and GLM-OCR's greedy decode in
``test_torch_exact_entry_points.py``, HPD-Parsing's in
``test_torch_hpd_scheduler.py``.
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu.vl import exact_models as jem
from oar_ocr_tpu_torch.errors import ConfigError, InvalidInputError
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl import exact_models as em
from torch_exact_common import (CPU_RT, MAX_NEW, check_generate, imgs,
                                make_pair)
from torch_jax_tree import one_torch_thread  # noqa: F401

# OvisOCR2's hybrid stack: test_torch_exact_hybrid.py; GLM-OCR's and
# HPD-Parsing's on the pairs of test_torch_exact_entry_points.py and
# test_torch_hpd_scheduler.py
FACTORIES = ("mineru_exact", "monkey_exact")


@pytest.mark.parametrize("factory", FACTORIES)
def test_generate_matches_jax(factory):
    """A left-padded batch of two pages: ids and texts identical to JAX;
    the fused prompt embeddings within 1e-4 · max(1, max|ref|); each row
    equal to that page run alone."""
    check_generate(*make_pair(factory))


def test_registry_names_and_roots():
    """Every registry name builds its architecture (PaddleOCR-VL and
    HunyuanOCR their own models); an unknown one raises, as does the
    published MinerU-Diffusion's width mismatch; the state_dict keys sit
    under the checkpoint roots."""
    assert set(em.EXACT_FACTORIES) == set(jem.EXACT_FACTORIES)
    for name in list(em.EXACT_FACTORIES) + ["mineru-diffusion-v1"]:
        m = em.exact_from_registry(name, tiny=True, **CPU_RT)
        roots = {k.split(".")[0] for k in m.net.state_dict()}
        want = {"mineru-diffusion-v1": {"vision_tower", "language_model"},
                "hpd-parsing-1b": {"vision_model", "mlp1",
                                   "language_model"},
                "glm-ocr": {"model", "lm_head"},
                "ovisocr2-0.8b": {"model", "lm_head"}}.get(name)
        if want is None:
            want = ({"vision_tower", "model", "lm_head"}
                    if name.startswith("monkey")
                    else {"visual", "model", "lm_head"})
        assert roots == want, (name, roots)
    from oar_ocr_tpu_torch.vl import HunyuanOCRModel, PaddleOCRVL

    assert isinstance(em.exact_from_registry("paddleocr-vl-0.9b", tiny=True,
                                             **CPU_RT), PaddleOCRVL)
    assert isinstance(em.exact_from_registry("hunyuanocr-1.5", tiny=True,
                                             **CPU_RT), HunyuanOCRModel)
    with pytest.raises(InvalidInputError, match="unknown exact VLM"):
        em.exact_from_registry("no-such-vlm", tiny=True, **CPU_RT)
    # the published MinerU-Diffusion pairs a 1536-wide tower output with
    # a 1024-wide decoder: refused before any weight is made
    with pytest.raises(ConfigError, match="output width"):
        em.exact_from_registry("mineru-diffusion-v1", **CPU_RT)
    keys = set(em.mineru_exact(tiny=True, **CPU_RT).net.state_dict())
    for k in ("visual.patch_embed.proj.weight",
              "visual.blocks.0.attn.qkv.weight", "visual.merger.mlp.0.weight",
              "model.layers.0.self_attn.q_proj.bias", "lm_head.weight"):
        assert k in keys, k
    keys = set(em.ovis_exact(tiny=True, **CPU_RT).net.state_dict())
    assert "model.language_model.layers.0.linear_attn.A_log" in keys
    assert "model.language_model.layers.0.linear_attn.conv1d.weight" in keys
    assert "model.visual.pos_embed.weight" in keys
    keys = set(em.hpd_exact(tiny=True, **CPU_RT).net.state_dict())
    assert "vision_model.embeddings.class_embedding" in keys
    assert "vision_model.encoder.layers.0.ls1" in keys
    assert "language_model.lm_head.weight" in keys
    pos = em.qwen2vl_positions(10, 1, 4, (4, 4), 2)
    np.testing.assert_array_equal(pos, jem.qwen2vl_positions(10, 1, 4, (4, 4),
                                                             2))


def test_float32_under_bfloat16_runtime():
    """The exact stacks are float32 whatever the compute dtype, as in the
    JAX package: a bfloat16 Runtime gives float32 weights and embeddings
    and the float32 Runtime's ids."""
    img = imgs()[0]
    f32 = em.glm_exact(tiny=True, seed=2, **CPU_RT)
    bf = em.glm_exact(tiny=True, seed=2,
                      runtime=Runtime("bfloat16", device="cpu"))
    assert {p.dtype for p in bf.net.parameters()} == {torch.float32}
    emb, _, _ = bf.prepare_prompt(img, "OCR:")
    assert emb.dtype == torch.float32
    a, b = [], []
    f32.generate([img], max_new_tokens=MAX_NEW, token_ids=a)
    bf.generate([img], max_new_tokens=MAX_NEW, token_ids=b)
    assert a == b

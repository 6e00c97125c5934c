"""The port's other exact-VLM entry points against the JAX package's and
against its own greedy decode, on the CPU: MinerU-Diffusion's block
diffusion and GLM-OCR's MTP speculative decoding, on the port's seeded
weights in both packages (``torch_exact_common``). The gates: ids and
texts identical. GLM-OCR's greedy decode is held to JAX's here too, on
the same pair. The n-gram speculative path is in
``test_torch_exact_hybrid.py``.
"""

import pytest

from torch_exact_common import check_generate, imgs, make_pair
from torch_jax_tree import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def glm_pair():
    """(port GlmSpeculativeExact, JAX GlmSpeculativeExact), one pair for
    the module's tests."""
    return make_pair("glm_speculative_exact")


def test_diffusion_and_mtp_match_jax(glm_pair):
    """MinerU-Diffusion's block-diffusion texts and GLM-OCR's MTP
    speculative texts identical to JAX's; MTP equal to its greedy."""
    ours, ref = make_pair("mineru_diffusion_exact")
    img = imgs()[0]
    ids = []
    got = ours.generate([img], max_new_tokens=16, block_len=8,
                        token_ids=ids)
    assert got == ref.generate([img], max_new_tokens=16, block_len=8)
    assert len(ids[0]) >= 1
    ours, ref = glm_pair
    stats = {}
    got = ours.generate_speculative([img], max_new_tokens=10, stats=stats)
    assert got == ref.generate_speculative([img], max_new_tokens=10)
    assert got == ours.generate([img], max_new_tokens=10)
    assert stats["drafted"] == 4 * stats["rounds"]


def test_glm_generate_matches_jax(glm_pair):
    """GLM-OCR's greedy decode of a left-padded batch of two pages, as
    ``torch_exact_common.check_generate`` holds it."""
    check_generate(*glm_pair)

"""The port's OvisOCR2 exact stack (gated-delta + full-attention
layers) against the JAX package's, and n-gram speculative decoding
against the greedy decode, on the CPU.

OvisOCR2's tiny config runs in float32 in both packages on the port's
seeded weights (``torch_exact_common``): a left-padded batch of two
pages, whose delta layers keep the pad rows out of their recurrent fold,
gives JAX's ids and texts, each row the page's alone. Speculative
decoding (MinerU and OvisOCR2; the delta layers resume from the verify
block's per-step states) gives the greedy texts.
"""

import pytest

from oar_ocr_tpu_torch.vl import exact_models as em
from torch_exact_common import CPU_RT, check_generate, imgs, make_pair
from torch_jax_tree import one_torch_thread  # noqa: F401


def test_ovis_generate_matches_jax():
    """The hybrid stack's left-padded batch: ids, texts and fused
    embeddings as ``torch_exact_common.check_generate`` holds them."""
    check_generate(*make_pair("ovis_exact"))


@pytest.mark.parametrize("factory", ["ovis_exact", "mineru_exact"])
def test_speculative_equals_greedy(factory):
    """n-gram drafts verified in blocks: every emitted token a target
    argmax, so the texts are the greedy ones; OvisOCR2's delta layers
    resume from the verify block's per-step states."""
    ours = getattr(em, factory)(tiny=True, seed=5, **CPU_RT)
    for img in imgs():
        stats = {}
        spec = ours.generate_speculative([img], max_new_tokens=12,
                                         draft_k=3, stats=stats)
        assert spec == ours.generate([img], max_new_tokens=12)
        assert stats["rounds"] >= 1

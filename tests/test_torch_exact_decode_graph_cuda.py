"""The exact stacks' and the families' greedy decode graphs on the card.

The replayed CUDA graph of ``vl/decode_graph.py`` against the eager step
body (``graph=False``) on the same inputs, bit for bit: MinerU's, Monkey
OCRv2's (K4 at the device slot), GLM-OCR's and OvisOCR2's exact stacks
and the GLM-OCR and OvisOCR2 families (their static delta state), at
their tiny configs, float32. The CPU side, held to the JAX package, is
``tests/test_torch_exact_decode_graph.py``; this file imports only the
port, since the card's machine has no flax. Every test needs a card and
is marked ``cuda``.
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl import exact_models as em
from oar_ocr_tpu_torch.vl import families as fam

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

MAX_NEW = 9


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the kernels have no "
                    "CPU form")


def _inputs(name):
    """The model and ``prefill_decode``'s (or ``_generate_impl``'s, whose
    valid lengths are host numpy) inputs for 2 rows of random token ids,
    left-padded to lengths 9 and 6. Token embeddings stand in for the
    image's: the tiny towers' head sizes are not ones the flash kernel is
    built for."""
    rng = np.random.default_rng(5)
    rt = Runtime("float32", "cuda", cfg=ONE_DEVICE)
    exact = name.endswith("_exact")
    m = (getattr(em, name)(tiny=True, seed=1, runtime=rt) if exact
         else fam.FAMILY_CLASSES[name](tiny=True, seed=1, runtime=rt))
    vocab = (m.spec.text_cfg.vocab_size if exact
             else m.cfg.decoder.vocab_size)
    ids = rng.integers(6, vocab, (2, 9))
    ids[1, :3] = 0
    mrope = not exact or m.spec.text_cfg.rope_kind == "mrope"
    pos = np.zeros((3, 2, 9) if mrope else (2, 9), np.int64)
    for row, n in enumerate((9, 6)):
        pos[..., row, 9 - n:] = np.arange(n) + (
            np.arange(3)[:, None] if mrope else 0)
    with torch.inference_mode():
        embed = m.net.embed if exact else m.module.lm.embed_tokens
        embeds = embed(rt.put(ids)).float()
    valid = np.array([9, 6])
    return m, (embeds, rt.put(pos), rt.put(valid) if exact else valid)


def _decode(m, args, graph):
    steps = []
    if isinstance(m, em.ExactVLM):
        ids = m.prefill_decode(*args, max_new=MAX_NEW, capacity=256,
                               step_logits=steps, graph=graph)
    else:
        ids = m._generate_impl(*args, max_new=MAX_NEW, capacity=256,
                               step_logits=steps, graph=graph)
    return ids, steps


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mineru_exact", "monkey_exact",
                                  "glm_exact", "ovis_exact", "glmocr",
                                  "ovisocr2"])
def test_cuda_graph_matches_eager(name):
    """float32: the replayed graph gives the eager step's ids and step
    logits bit for bit, for the request that captures and for one that
    only replays; the K3 and K4 counts through replays equal the eager
    loop's (K4 only in MonkeyOCRv2's SDAR decoder)."""
    _need_card()
    m, args = _inputs(name)
    kernels = (fnr.KERNEL, fnr.KERNEL_QK)
    runs = {True: [], False: []}
    for graph in (True, True, False):
        before = [k.launches for k in kernels]
        ids, steps = _decode(m, args, graph)
        torch.cuda.synchronize()
        counts = [k.launches - n for k, n in zip(kernels, before)]
        runs[graph].append((ids.cpu(), steps, counts))
    eager_ids, eager_steps, eager_counts = runs[False][0]
    assert eager_counts[0] > 0
    assert (eager_counts[1] > 0) == (name == "monkey_exact")
    for ids, steps, counts in runs[True]:
        assert torch.equal(ids, eager_ids) and counts == eager_counts
        assert len(steps) == len(eager_steps) == MAX_NEW
        assert all(torch.equal(g, e) for g, e in zip(steps, eager_steps))
    st = m.decode_graphs.states[(2, 256, torch.float32)]
    assert st.graph is not None and st.capture_ms > 0

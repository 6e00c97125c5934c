"""The default formula recognizer's decode graph and the formula models'
K1 inputs on the card.

The CPU side is held to the JAX package in ``tests/test_torch_formula.py``
and ``tests/test_torch_formulanet.py``; this file imports only the port
(the card's machine has no flax). Every test needs a card and is marked
``cuda``. Models at the tests' size (as ``test_torch_formula.py``) on
seeded weights.

Gates: the decode graph against the eager loop on the card, both from
the same cross K/V: ids and probs bit-equal over all steps, at 6 rows
and at 5 (a second key); a second decode of a key replays its graph
with no new capture. K1 at each formula input (the default's canvas
into float32 and bfloat16, the exact models' into float32) against its
plain version: float32 ≤ 1e-6 absolute, bfloat16 ≤ 1 ulp; each
recognizer's K1 launches named by its caller.
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.models.recognition import formula as tf
from oar_ocr_tpu_torch.models.recognition.formula_decode import decode_eager
from oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact import (
    PPFormulaNetConfig, PPFormulaNetRecognizer)
from oar_ocr_tpu_torch.models.recognition.unimernet import (
    UniMERNetConfig, UniMERNetRecognizer)
from oar_ocr_tpu_torch.ops import normalize
from oar_ocr_tpu_torch.runtime.runtime import Runtime

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

pytestmark = pytest.mark.cuda

MODEL_KW = dict(dim=32, dec_layers=2, heads=4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph and K1 run only "
                    "there")


def _crops(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(20, 90)), int(rng.integers(40, 300))
        img = np.full((h, w, 3), 255, np.uint8)
        y, x = int(rng.integers(2, h - 8)), int(rng.integers(2, w - 20))
        img[y:y + 6, x:x + 18] = int(rng.integers(0, 120))
        out.append(img)
    return out


@pytest.mark.parametrize("rows", [6, 5])
def test_graph_equals_eager(rows):
    _need_card()
    rec = tf.FormulaRecognizer(None, vocab_size=64, max_len=24,
                               input_hw=(64, 96),
                               runtime=Runtime("float32", device="cuda",
                                               cfg=ONE_DEVICE),
                               **MODEL_KW)
    x = rec.inputs(_crops(rows, rows))
    model = rec.model
    mk, mv = model.prefill(model.encode(x.permute(0, 3, 1, 2)))
    ids, probs = (t.clone() for t in rec.graphs.decode(mk, mv))
    e_ids, e_probs = decode_eager(model.decoder, mk, mv)
    assert torch.equal(ids, e_ids) and torch.equal(probs, e_probs)
    state = rec.graphs.states[tuple(mk.shape)]
    graph = state.graph
    again = rec.graphs.decode(mk, mv)
    assert state.graph is graph and len(rec.graphs.states) == 1
    assert torch.equal(again[0], e_ids)
    assert rec.graphs.last == {"steps": 24, "replays": 1, "syncs": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_default_input(dtype):
    _need_card()
    rt = Runtime(dtype, device="cuda", cfg=ONE_DEVICE)
    rec = tf.FormulaRecognizer(None, vocab_size=64, max_len=8,
                               runtime=rt, **MODEL_KW)
    crops = _crops(1, 4)
    before = normalize.LAUNCHES_BY_CALLER["formula"]
    got = rec.inputs(crops)
    assert normalize.LAUNCHES_BY_CALLER["formula"] == before + 1
    u8 = rt.put(tf.formula_canvas(crops, rec.input_hw))
    alpha, beta = normalize.coefficients(tf.FORMULA_MEAN, tf.FORMULA_STD)
    ref = normalize.normalize_ref(u8, alpha, beta,
                                  out_dtype=rt.compute_dtype)
    assert got.shape == (4, 192, 672, 3) and got.dtype == rt.compute_dtype
    if got.dtype == torch.bfloat16:
        ulps = (got.view(torch.int16).int()
                - ref.view(torch.int16).int()).abs().max()
        assert int(ulps) <= 1
    else:
        assert float((got - ref).abs().max()) <= 1e-6
    assert float(got.float().min()) == -1.0      # the 0 pad


@pytest.mark.parametrize("which", ["s", "unimernet"])
def test_k1_exact_inputs(which):
    _need_card()
    rt = Runtime("bfloat16", device="cuda", cfg=ONE_DEVICE)
    if which == "s":
        rec = PPFormulaNetRecognizer(None, cfg=PPFormulaNetConfig().tiny(),
                                     runtime=rt)
        caller, canvas = "formulanet", rec.canvas
    else:
        rec = UniMERNetRecognizer(None, cfg=UniMERNetConfig().tiny(),
                                  runtime=rt)
        caller, canvas = "unimernet", rec.canvas
    crops = _crops(2, 3)
    before = normalize.LAUNCHES_BY_CALLER[caller]
    got = rec.inputs(crops)
    assert normalize.LAUNCHES_BY_CALLER[caller] == before + 1
    assert got.dtype == torch.float32         # float32 in either Runtime
    u8 = rt.put(np.stack([canvas(c) for c in crops]))
    alpha, beta = normalize.coefficients((0.7931,) * 3, (0.1738,) * 3)
    ref = normalize.normalize_ref(u8, alpha, beta)
    assert float((got - ref).abs().max()) <= 1e-6
    assert len(rec.recognize(crops, max_new_tokens=3)) == 3

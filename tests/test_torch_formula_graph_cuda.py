"""The exact formula models' decode forwards as CUDA graphs on the card
(``models/recognition/exact_decode.py``).

The CPU side is held to the JAX package in
``tests/test_torch_formula_graph.py``; this file imports only the port
(the card's machine has no flax). Every test needs a card and is marked
``cuda``. Models: PP-FormulaNet-S, -L and UniMERNet at their tiny
configs with 256 positions, on seeded weights.

Gates: the recognizer's loop through its graphs against the same loop
on the eager forward, from the same cross K/V: the ids and every
forward's argmax bit-equal; one host read a forward; the keys of the
first crop kept (not captured again) and replayed by the second; the
recognize strings equal the eager loop's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.models.recognition.exact_decode import (
    DECODE_BUCKETS, EagerForward, ExactForwardGraphs)
from oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact import (
    PPFormulaNetConfig, PPFormulaNetRecognizer)
from oar_ocr_tpu_torch.models.recognition.unimernet import (
    UniMERNetConfig, UniMERNetRecognizer, token_string)
from oar_ocr_tpu_torch.runtime.runtime import Runtime

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

pytestmark = pytest.mark.cuda

MODELS = {
    "s": (PPFormulaNetRecognizer, PPFormulaNetConfig().tiny()),
    "l": (PPFormulaNetRecognizer, PPFormulaNetConfig().tiny_large()),
    "unimernet": (UniMERNetRecognizer, UniMERNetConfig().tiny()),
}
TOKENS = 40


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs run only there")


def _crops(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(20, 90)), int(rng.integers(40, 300))
        img = np.full((h, w, 3), 255, np.uint8)
        for _ in range(int(rng.integers(3, 9))):
            y, x = int(rng.integers(2, h - 4)), int(rng.integers(2, w - 6))
            img[y:y + int(rng.integers(2, 12)),
                x:x + int(rng.integers(2, 40))] = int(rng.integers(0, 120))
        out.append(img)
    return out


class Logged:
    """A forward that keeps each forward's argmax ids."""

    def __init__(self, forward):
        self.forward, self.out = forward, []

    def begin(self, cross):
        self.forward.begin(cross)

    def __call__(self, query, rows):
        ids = self.forward(query, rows)
        self.out.append(np.asarray(ids).copy())
        return ids


@pytest.mark.parametrize("name", list(MODELS))
def test_graph_equals_eager(name):
    _need_card()
    cls, cfg = MODELS[name]
    rec = cls(None, cfg=dataclasses.replace(cfg, max_positions=256),
              runtime=Runtime("float32", device="cuda", cfg=ONE_DEVICE))
    assert isinstance(rec.forward, ExactForwardGraphs)
    graphs, mbart = rec.graphs, rec.model.mbart
    crops = _crops(7, 2)
    texts = []
    kept = {}
    with torch.no_grad():
        x = rec.inputs(crops)
        for i in range(len(crops)):
            cross = mbart.cross_kv(rec.model.encode(x[i:i + 1]))
            before = graphs.forwards
            g, e = Logged(graphs), Logged(EagerForward(mbart))
            ids_g = rec.decode_ids(g, cross, TOKENS)
            ids_e = rec.decode_ids(e, cross, TOKENS)
            assert ids_g == ids_e
            assert len(g.out) == len(e.out) == graphs.forwards - before
            for a, b in zip(g.out, e.out):
                assert np.array_equal(a, b)
            if i == 0:
                kept = dict(graphs.graphs)
            else:
                # the first crop's graphs are kept, and this crop's
                # forwards replayed some of them
                assert all(graphs.graphs[k] is v for k, v in kept.items())
                new = len(graphs.graphs) - len(kept)
                assert graphs.forwards - before > new
            texts.append(token_string(ids_e[1:], None))
    memory = cross[0][0].shape[2]
    step = getattr(cfg, "parallel_step", 1)
    assert set(graphs.graphs) <= {(b, step, memory) for b in DECODE_BUCKETS}
    assert all(g.capture_ms is not None for g in graphs.graphs.values())
    assert graphs.reads == graphs.forwards and graphs.eager == 0
    assert rec.recognize(crops, max_new_tokens=TOKENS) == texts

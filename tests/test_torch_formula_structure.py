"""The port's ``OARStructure`` with formulas on against the JAX package on
the CPU, in float32, and the builder's formula options.

The pipelines: a stub layout that reports two drawn formulas (one
``formula``, one ``display_formula``) and a text block on each of two
pages (the same boxes for both packages: the layout models have their
own tests), no overall OCR, tables or seals, and the default formula
recognizer at the tests' size of ``test_torch_formula.py`` (the JAX
model's leaves plus seeded noise, converted by ``params_from_jax``).

Gates: the same elements per page in the same order with equal labels,
order indices and ``formula_latex``; ``to_markdown()`` and ``to_html()``
equal; each formula recognized once, all four crops in one batch. The
builder: ``build()`` with every default builds (formulas on, the
default recognizer), and ``with_formula_model_type`` gives the three
JAX options.
"""

import numpy as np
import pytest

from oar_ocr_tpu.domain.layout import LayoutBox as JLayoutBox
from oar_ocr_tpu.pipelines.structure import OARStructure as JStructure
from oar_ocr_tpu.pipelines.structure import \
    OARStructureConfig as JStructureConfig
from oar_ocr_tpu_torch.domain.layout import LayoutBox
from oar_ocr_tpu_torch.models.recognition.formula import FormulaRecognizer
from oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact import \
    PPFormulaNetExactAdapter
from oar_ocr_tpu_torch.pipelines.structure import (OARStructure,
                                                   OARStructureBuilder,
                                                   OARStructureConfig)
from oar_ocr_tpu_torch.runtime.runtime import Runtime

from test_torch_formula import Pair

# label → xyxy on each page
BOXES = (("formula", (40, 120, 420, 190)),
         ("display_formula", (60, 260, 560, 330)),
         ("text", (40, 20, 500, 70)))
FORMULAS = ("x^2+y_1=z", "a/b=c+42")


def pages():
    """Two white 480×640 pages, each formula box with a drawn formula and
    a seeded shade, the text block dark."""
    import cv2

    rng = np.random.default_rng(4)
    out = []
    for p in range(2):
        img = np.full((480, 640, 3), 255, np.uint8)
        for (label, (x0, y0, x1, y1)), text in zip(BOXES, FORMULAS):
            shade = int(rng.integers(0, 90))
            cv2.putText(img, text, (x0 + 10 + 20 * p, y1 - 20),
                        cv2.FONT_HERSHEY_SIMPLEX, 1.2 + 0.2 * p,
                        (shade,) * 3, 2)
        x0, y0, x1, y1 = BOXES[2][1]
        img[y0 + 10:y1 - 10, x0 + 5:x1 - 60] = 30
        out.append(img)
    return out


class StubLayout:
    def __init__(self, box_cls):
        self.box_cls = box_cls

    def detect(self, pages_u8, shapes, page_indices=None):
        return [[self.box_cls(label, 0.9, np.asarray(b, np.float32))
                 for label, b in BOXES] for _ in shapes]


class Counting:
    """Wraps a recognizer and records each call's batch size."""

    def __init__(self, rec):
        self.rec, self.calls = rec, []

    def recognize(self, crops):
        self.calls.append(len(crops))
        return self.rec.recognize(crops)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_structure_with_formulas_matches(pair):
    cpu = Runtime("float32", device="cpu")
    cfg = dict(use_tables=False, use_seals=False, use_overall_ocr=False,
               image_batch_size=2)
    j_rec = Counting(pair.jax_recognizer("float32"))
    t_rec = Counting(pair.port_recognizer("float32"))
    j = JStructure(layout=StubLayout(JLayoutBox), ocr=None, tables=None,
                   formulas=j_rec, seal_ocr=None,
                   cfg=JStructureConfig(**cfg), runtime=None)
    t = OARStructure(layout=StubLayout(LayoutBox), ocr=None,
                     formulas=t_rec, cfg=OARStructureConfig(**cfg),
                     runtime=cpu)
    imgs = pages()
    ref, got = j.predict(imgs), t.predict(imgs)
    assert t_rec.calls == j_rec.calls == [4]
    n = 0
    for g, r in zip(got, ref):
        assert len(g.elements) == len(r.elements)
        for a, b in zip(g.elements, r.elements):
            assert (a.element_type.value, a.label, a.order_index,
                    a.formula_latex) == (b.element_type.value, b.label,
                                         b.order_index, b.formula_latex)
            if a.formula_latex is not None:
                assert a.element_type.is_formula and a.formula_latex
                n += 1
        assert g.to_markdown() == r.to_markdown()
        assert g.to_html() == r.to_html()
    assert n == 4
    # with formulas switched off in the config the stage does not run
    off = OARStructure(layout=StubLayout(LayoutBox), ocr=None,
                       formulas=t_rec, runtime=cpu,
                       cfg=OARStructureConfig(**{**cfg,
                                                 "use_formulas": False}))
    res = off.predict(imgs)
    assert t_rec.calls == [4]
    assert all(e.formula_latex is None for r in res for e in r.elements)


def test_builder_default_builds():
    """``build()`` with every default: formulas on with the default
    recognizer at its JAX size (192×672, 64 steps, vocab 8000)."""
    pipe = OARStructureBuilder().with_runtime(
        Runtime("float32", device="cpu")).build()
    assert pipe.cfg.use_formulas
    rec = pipe.formulas
    assert isinstance(rec, FormulaRecognizer)
    assert rec.input_hw == (192, 672)
    assert rec.model.decoder.max_len == 64
    assert rec.model.decoder.lm_head.out_features == 8000
    assert pipe.tables is not None and pipe.seal_ocr is not None


@pytest.mark.parametrize("model_type,image_hw,d_model", [
    ("pp-formulanet-exact", (384, 384), 384),
    ("pp-formulanet-l-exact", (768, 768), 1024)])
def test_builder_formula_model_types(model_type, image_hw, d_model):
    """``with_formula_model_type``: the exact -S and -L adapters."""
    pipe = (OARStructureBuilder().with_runtime(Runtime("float32",
                                                       device="cpu"))
            .with_tables(False).with_seals(False).with_overall_ocr(False)
            .with_formula_model_type(model_type).build())
    assert isinstance(pipe.formulas, PPFormulaNetExactAdapter)
    cfg = pipe.formulas.rec.cfg
    assert (cfg.image_hw, cfg.d_model) == (image_hw, d_model)
    assert (cfg.vary is not None) == ("-l-" in model_type)

"""The port's ``OARStructure`` against the JAX package's on the CPU.

Both pipelines run in float32 with the same weights: the trained
``assets/bench_det.safetensors`` detector, one perturbed random
recognizer, and a perturbed random PicoDet-S layout model at the tests'
size (LCNet scale 0.5, CSP-PAN 64, two head convs), carried over by
``params_from_jax``. Pages: two 320×480 pages of dark text rows.

Gates: the same elements per page in the same order, with equal labels,
element types, order indices and texts, boxes within 1e-3 px, scores
within 1e-5; ``to_markdown()`` equal; the refinement's regions equal in
text, boxes within 1e-3 px; ``OAROCR.predict(pages_dev=…)`` equal to
``predict`` without it. Formulas have their own tests
(``test_torch_formula_structure.py``).
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
from oar_ocr_tpu.domain.structure import LayoutElement as JLayoutElement
from oar_ocr_tpu.domain.structure import \
    LayoutElementType as JLayoutElementType
from oar_ocr_tpu.domain.text_region import TextRegion as JTextRegion
from oar_ocr_tpu.models.detection.layout import LayoutDetector as JLayout
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer
from oar_ocr_tpu.ops.ctc import default_charset
from oar_ocr_tpu.pipelines.ocr import OAROCRBuilder as JBuilder
from oar_ocr_tpu.pipelines.structure import OARStructure as JStructure
from oar_ocr_tpu.pipelines.structure import \
    OARStructureConfig as JStructureConfig
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import (flatten_params, load_params,
                                         unflatten_params)
from oar_ocr_tpu_torch.domain.structure import (LayoutElement,
                                                LayoutElementType)
from oar_ocr_tpu_torch.domain.text_region import TextRegion
from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.pipelines.structure import (OARStructure,
                                                   OARStructureBuilder,
                                                   OARStructureConfig)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax, read_safetensors

REPO = Path(__file__).resolve().parents[1]
BENCH_DET = REPO / "assets" / "bench_det.safetensors"
PICO_KW = dict(scale=0.5, neck_feat=64, head_convs=2)
# the layout model: pp-doclayout-s's 23 classes on PicoDet-S at the
# tests' size; the score threshold leaves a few boxes per page
LAYOUT = ("pp-doclayout-s", 0.672)
CFG = dict(use_tables=False, use_formulas=False, image_batch_size=2)


def _perturbed(flat, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.random(np.shape(v)) * 0.5 + 0.75).astype(np.float32)
            if k.endswith("/var") else
            (np.asarray(v, np.float32) + rng.normal(0, scale, np.shape(v))
             ).astype(np.float32) for k, v in sorted(flat.items())}


def _pages():
    rng = np.random.default_rng(7)
    pages = []
    for p in range(2):
        img = np.full((320, 480, 3), 255, np.uint8)
        for r in range(4):
            w = (300, 180, 360, 120)[(r + p) % 4]
            y = 30 + r * 70
            img[y:y + 26, 40:40 + w] = rng.integers(0, 80)
        pages.append(img)
    return pages


@pytest.fixture(scope="module")
def jrt():
    return JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))


@pytest.fixture(scope="module")
def weights(jrt):
    vocab = 2 + len(default_charset())
    rec = _perturbed(flatten_params(init_params_fast(
        SVTRRecognizer(vocab_size=vocab), (1, 48, 64, 3))), 61, 0.05)
    det = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       load_params(str(BENCH_DET)))
    j = JLayout(LAYOUT[0], runtime=jrt, net_overrides=PICO_KW)
    layout = _perturbed(flatten_params(jax.tree.map(np.asarray, j.params)),
                        40, 0.15)
    return det, rec, layout


@pytest.fixture(scope="module")
def ocr_pair(jrt, weights):
    det, rec, _ = weights
    j = (JBuilder("general").with_runtime(jrt).with_det_params(det)
         .with_rec_params(unflatten_params(rec))
         .with_batch_sizes(image=2, region=64).build())
    t = (OAROCRBuilder("general").with_runtime(Runtime("float32",
                                                       device="cpu"))
         .with_det_params(params_from_jax(read_safetensors(str(BENCH_DET))))
         .with_rec_params(params_from_jax(rec))
         .with_batch_sizes(image=2, region=64).build())
    return j, t


@pytest.fixture(scope="module")
def structure_pair(jrt, weights, ocr_pair):
    _, _, layout = weights
    variant, thr = LAYOUT
    jl = JLayout(variant, unflatten_params(layout), score_thresh=thr,
                 runtime=jrt, net_overrides=PICO_KW)
    tl = LayoutDetector(variant, params_from_jax(layout), score_thresh=thr,
                        runtime=Runtime("float32", device="cpu"),
                        net_overrides=PICO_KW)
    j = JStructure(layout=jl, ocr=ocr_pair[0], tables=None, formulas=None,
                   seal_ocr=None, cfg=JStructureConfig(**CFG), runtime=jrt)
    t = OARStructure(layout=tl, ocr=ocr_pair[1],
                     cfg=OARStructureConfig(**CFG),
                     runtime=Runtime("float32", device="cpu"))
    return j, t


def assert_same_results(got, ref, min_elements=1):
    assert len(got) == len(ref)
    n = 0
    for g, r in zip(got, ref):
        assert (g.width, g.height) == (r.width, r.height)
        assert len(g.elements) == len(r.elements)
        for a, b in zip(g.elements, r.elements):
            assert (a.label, a.element_type.value, a.order_index, a.text,
                    a.num_lines) == (b.label, b.element_type.value,
                                     b.order_index, b.text, b.num_lines)
            np.testing.assert_allclose(np.asarray(a.box, np.float32),
                                       np.asarray(b.box, np.float32),
                                       atol=1e-3, rtol=0)
            assert abs(a.score - b.score) <= 1e-5
            n += 1
        assert g.to_markdown() == r.to_markdown()
        assert g.to_html() == r.to_html()
    assert n >= min_elements, f"vacuous reference: {n} elements"


def test_structure_matches(structure_pair):
    """Layout, overall OCR on the shared upload, refinement, stitch and
    reading order: the same elements, texts and markdown."""
    j, t = structure_pair
    pages = _pages()
    ref = j.predict(pages)
    got = t.predict(pages)
    assert_same_results(got, ref, min_elements=4)
    assert any(e.text for r in got for e in r.elements)
    assert any(r.to_markdown() for r in got)


def test_structure_layout_only(jrt):
    """The layout-only pipeline of ``test_structure_pipeline.py``
    (``picodet-s_layout_3cls``, no OCR), and an empty input. The model is
    at the tests' size with perturbed weights and a score threshold that
    keeps three boxes a page: the JAX package's own seeded weights give
    scores that agree to 1e-7 (all near 0.5), so 1e-7 of rounding would
    decide which of them the top-k and the NMS keep."""
    jl = JLayout("picodet-s_layout_3cls", runtime=jrt,
                 net_overrides=PICO_KW)
    flat = _perturbed(flatten_params(jax.tree.map(np.asarray, jl.params)),
                      41, 0.2)
    jl = JLayout("picodet-s_layout_3cls", unflatten_params(flat),
                 score_thresh=0.815, runtime=jrt, net_overrides=PICO_KW)
    tl = LayoutDetector("picodet-s_layout_3cls", params_from_jax(flat),
                        score_thresh=0.815, net_overrides=PICO_KW,
                        runtime=Runtime("float32", device="cpu"))
    cfg = dict(use_tables=False, use_formulas=False, use_seals=False,
               use_overall_ocr=False)
    j = JStructure(layout=jl, ocr=None, tables=None, formulas=None,
                   seal_ocr=None, cfg=JStructureConfig(**cfg), runtime=jrt)
    t = OARStructure(layout=tl, ocr=None, cfg=OARStructureConfig(**cfg),
                     runtime=Runtime("float32", device="cpu"))
    img = np.random.default_rng(0).integers(0, 255, (200, 300, 3),
                                            dtype=np.uint8)
    assert_same_results(t.predict([img, img]), j.predict([img, img]),
                        min_elements=4)
    res = t.predict_image(img)
    assert (res.width, res.height) == (300, 200)
    assert res.to_json_value()["width"] == 300 and "<html>" in res.to_html()
    assert t.predict([]) == j.predict([]) == []


def test_refinement_matches(jrt, ocr_pair):
    """Both refinement waves on built elements: one OCR box across two
    text blocks (wave 1: re-recognized per intersection, the second crop
    appended, a covered region's text suppressed) and a block without
    text (wave 2: whole-block OCR)."""
    j_ocr, t_ocr = ocr_pair
    pages = _pages()
    el_boxes = [((30, 20, 200, 70), "text"), ((200, 20, 360, 70), "text"),
                ((30, 230, 300, 300), "paragraph_title"),
                ((30, 150, 400, 190), "image")]
    regions = [((40, 30, 340, 56), "AAA"), ((202, 30, 340, 56), "BBB"),
               ((40, 100, 220, 126), "CCC")]

    def build(el_cls, type_cls, region_cls):
        els = [el_cls(element_type=type_cls.from_label(label),
                      box=np.asarray(b, np.float32), score=0.9, label=label)
               for b, label in el_boxes]
        regs = [region_cls(box=np.array([[x0, y0], [x1, y0], [x1, y1],
                                         [x0, y1]], np.float32), text=txt,
                           confidence=0.5) for (x0, y0, x1, y1), txt in
                regions]
        return [els, []], [regs, []]

    shapes = [(320, 480), (320, 480)]
    j = JStructure(layout=None, ocr=j_ocr, tables=None, formulas=None,
                   cfg=JStructureConfig(**CFG), runtime=jrt)
    t = OARStructure(layout=None, ocr=t_ocr, cfg=OARStructureConfig(**CFG),
                     runtime=Runtime("float32", device="cpu"))
    j_els, j_regs = build(JLayoutElement, JLayoutElementType, JTextRegion)
    t_els, t_regs = build(LayoutElement, LayoutElementType, TextRegion)
    ref = j._refine_ocr_pages(jnp.asarray(np.stack(pages)), shapes, j_regs,
                              j_els)
    got = t._refine_ocr_pages(torch.from_numpy(np.stack(pages)), shapes,
                              t_regs, t_els)
    assert [len(p) for p in got] == [len(p) for p in ref] == [5, 0]
    for a, b in zip(got[0], ref[0]):
        assert a.text == b.text
        np.testing.assert_allclose(a.box, b.box, atol=1e-3, rtol=0)
    assert got[0][1].text is None                  # suppressed (IoU > 0.8)
    assert got[0][0].text not in (None, "AAA")     # re-recognized


def test_ocr_pages_dev_matches(ocr_pair):
    """``OAROCR.predict(pages_dev=…)`` with the structure's upload equals
    ``predict`` without it; an upload of another bucket is dropped."""
    _, t = ocr_pair
    pages = _pages()
    want = t.predict(pages)
    for shape in ((320, 640), (640, 640)):     # the det bucket; another
        up = t.runtime.put_pages(pages, shape)
        got = t.predict(pages, pages_dev=up)
        assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert sum(len(r.regions) for r in want) >= 4


def test_invalid_and_refused(structure_pair):
    """A grey page raises ``InvalidInputError``; formulas are no longer
    refused (``test_torch_formula_structure.py``): ``build()`` with every
    default builds, formulas on, and ``OARStructure`` takes a formula
    recognizer."""
    from oar_ocr_tpu_torch.models.recognition.formula import \
        FormulaRecognizer

    _, t = structure_pair
    with pytest.raises(InvalidInputError):
        t.predict([np.zeros((40, 60), np.uint8)])
    with pytest.raises(InvalidInputError):
        t.predict([np.zeros((40, 60, 3), np.float32)])
    cpu = Runtime("float32", device="cpu")
    pipe = OARStructureBuilder().with_runtime(cpu).build()
    assert pipe.cfg.use_formulas and pipe.cfg.use_tables
    assert isinstance(pipe.formulas, FormulaRecognizer)
    marker = object()
    assert OARStructure(layout=t.layout, ocr=None, runtime=cpu,
                        formulas=marker).formulas is marker


def test_builder_wires_stages():
    """``build()`` with tables and formulas off: the default layout
    variant, overall OCR, seal OCR; the document chain and text-line
    orientation when asked for."""
    cpu = Runtime("float32", device="cpu")
    pipe = (OARStructureBuilder().with_runtime(cpu)
            .with_layout_variant("picodet-s_layout_3cls")
            .with_tables(False).with_formulas(False)
            .with_doc_orientation().with_textline_orientation().build())
    assert pipe.layout.variant.name == "picodet-s_layout_3cls"
    assert pipe.ocr is not None and pipe.ocr.line_orienter is not None
    assert pipe.seal_ocr is not None
    assert pipe.seal_ocr.detector.postprocess.cfg.box_type.value == "poly"
    assert pipe.preprocessor is not None
    assert pipe.preprocessor.rectifier is None
    assert pipe.region_detector is None
    assert OARStructureConfig().layout_variant == "pp-doclayout_plus-l"


def test_structure_imports_no_jax():
    """The structure pipeline loads neither jax nor the JAX package
    (checked in a fresh interpreter)."""
    code = ("import sys; import oar_ocr_tpu_torch.pipelines.structure, "
            "oar_ocr_tpu_torch.models.detection.layout, "
            "oar_ocr_tpu_torch.pipelines.table_analyzer, "
            "oar_ocr_tpu_torch.models.recognition.slanext_exact, "
            "oar_ocr_tpu_torch.models.recognition.formula, "
            "oar_ocr_tpu_torch.models.recognition.formula_decode, "
            "oar_ocr_tpu_torch.models.recognition.unimernet, "
            "oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact, "
            "oar_ocr_tpu_torch.domain.markdown, "
            "oar_ocr_tpu_torch.processors.layout_sorting; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

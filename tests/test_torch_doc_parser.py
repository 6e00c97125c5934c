"""The port's ``DocParser`` against the JAX package's, on the CPU.

Both parsers run a perturbed random PicoDet-S layout model at the tests'
size (``pp-doclayout-s``'s 23 classes, carried over by
``params_from_jax``; the layout input normalize is K1's plain version
here) and one stub recognition backend, a deterministic function of each
crop (its task, size and pixel sum; an OTSL table for tables, LaTeX for
formulas), so the pipeline around the VLM is what is compared. The gates:
the same elements in the same order with equal types, labels, boxes
(within 1e-3 px), texts, table HTML and LaTeX, and both markdown
exporters' strings identical; the full-page fallback of a page with no
element alike; a stub layout of fixed boxes of every kind (the random
model finds only one) through both parsers; ``task_for_element``, ``filter_overlap_boxes`` and
``pad_bbox`` equal on seeded inputs.
"""

import types

import jax
import numpy as np
import pytest

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.domain.structure import \
    LayoutElementType as JLayoutElementType
from oar_ocr_tpu.models.detection.layout import LayoutDetector as JLayout
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.weights import flatten_params, unflatten_params
from oar_ocr_tpu.vl import doc_parser as jdp
from oar_ocr_tpu_torch.domain.structure import LayoutElementType
from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax
from oar_ocr_tpu_torch.vl import doc_parser as dp
from test_torch_structure import LAYOUT, PICO_KW, _pages, _perturbed
from torch_jax_tree import one_torch_thread  # noqa: F401


class StubBackend:
    """A recognition backend whose text is a function of the crop."""

    needs_formula_preprocess = False

    def __init__(self, table_postprocess):
        self.needs_table_postprocess = table_postprocess
        self.calls = []

    def recognize(self, images, task, max_tokens=None):
        self.calls.append((task.value, len(images), max_tokens))
        out = []
        for im in images:
            h, w = im.shape[:2]
            if task.value == "table":
                out.append(f"<fcel>{h}<fcel>{w}<nl><fcel>"
                           f"{int(im.sum()) % 97}<ecel><nl>")
            elif task.value == "formula":
                out.append(f"x^{{{h}}} + y_{{{w}}}")
            else:
                out.append(f"{task.value} {h}x{w}\n\n"
                           f"sum {int(im.sum())} ....... ____ end")
        return out


@pytest.fixture(scope="module")
def parsers():
    jrt = JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))
    variant, thr = LAYOUT
    j = JLayout(variant, runtime=jrt, net_overrides=PICO_KW)
    flat = _perturbed(flatten_params(jax.tree.map(np.asarray, j.params)),
                      40, 0.15)
    jl = JLayout(variant, unflatten_params(flat), score_thresh=thr,
                 runtime=jrt, net_overrides=PICO_KW)
    rt = Runtime("float32", device="cpu")
    tl = LayoutDetector(variant, params_from_jax(flat), score_thresh=thr,
                        runtime=rt, net_overrides=PICO_KW)
    return jrt, jl, rt, tl


def _same_elements(got, ref, min_elements=1):
    assert (got.width, got.height) == (ref.width, ref.height)
    assert len(got.elements) == len(ref.elements) >= min_elements
    for a, b in zip(got.elements, ref.elements):
        assert (a.element_type.value, a.label, a.text, a.formula_latex) == \
            (b.element_type.value, b.label, b.text, b.formula_latex)
        assert (a.table is None) == (b.table is None)
        if a.table is not None:
            assert a.table.html == b.table.html
        np.testing.assert_allclose(np.asarray(a.box, np.float32),
                                   np.asarray(b.box, np.float32), atol=1e-3,
                                   rtol=0)


@pytest.mark.parametrize("table_postprocess,page", [(True, 0), (False, 1)])
def test_parse_and_markdown_match_jax(parsers, table_postprocess, page):
    """``parse``, ``parse_to_markdown`` and ``parse_to_markdown_openocr``
    on a page; the stub is called once per task, in the same order."""
    jrt, jl, rt, tl = parsers
    jb, tb = StubBackend(table_postprocess), StubBackend(table_postprocess)
    cfg = dict(crop_pad_ratio=0.05, max_tokens=32)
    j = jdp.DocParser(jb, layout=jl, config=jdp.DocParserConfig(**cfg),
                      runtime=jrt)
    t = dp.DocParser(tb, layout=tl, config=dp.DocParserConfig(**cfg),
                     runtime=rt)
    img = _pages()[page]
    _same_elements(t.parse(img), j.parse(img), min_elements=2)
    assert t.parse_to_markdown(img) == j.parse_to_markdown(img)
    for pretty in (True, False):
        assert t.parse_to_markdown_openocr(img, pretty) == \
            j.parse_to_markdown_openocr(img, pretty)
    assert tb.calls == jb.calls
    # a page where the layout finds nothing: the whole-page fallback
    blank = np.full((64, 96, 3), 255, np.uint8)
    got, ref = t.parse(blank), j.parse(blank)
    _same_elements(got, ref)
    assert t.parse_to_markdown(blank) == j.parse_to_markdown(blank)


class StubLayout:
    """A layout model that finds the same boxes on every page."""

    BOXES = [("doc_title", (20, 10, 300, 40)),
             ("text", (20, 50, 460, 120)), ("table", (20, 130, 300, 220)),
             ("formula", (320, 130, 460, 170)),
             ("chart", (320, 180, 460, 300)), ("image", (20, 230, 150, 300)),
             ("image", (25, 235, 140, 290)), ("seal", (160, 230, 300, 300)),
             ("header", (0, 0, 480, 8)), ("reference", (0, 300, 100, 318)),
             ("paragraph_title", (160, 300, 470, 318)),
             ("text", (22, 52, 200, 100))]

    def detect(self, pages, shapes):
        return [[types.SimpleNamespace(label=lab, score=0.9 - 0.01 * i,
                                       box=np.asarray(b, np.float32))
                 for i, (lab, b) in enumerate(self.BOXES)] for _ in shapes]


def test_parse_every_task_over_stub_layout():
    """Fixed boxes of every recognized kind (text, title, table, formula,
    chart, seal; images, auxiliary regions, references and an overlapped
    box dropped) through both parsers: equal elements and markdown."""
    jrt = JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))
    rt = Runtime("float32", device="cpu")
    page = _pages()[0]
    for post in (True, False):
        j = jdp.DocParser(StubBackend(post), layout=StubLayout(),
                          runtime=jrt)
        t = dp.DocParser(StubBackend(post), layout=StubLayout(), runtime=rt)
        got, ref = t.parse(page), j.parse(page)
        _same_elements(got, ref, min_elements=6)
        assert {e.element_type.value for e in got.elements} >= {
            "table", "formula", "chart", "seal", "doc_title", "text"}
        assert t.parse_to_markdown(page) == j.parse_to_markdown(page)
        assert t.parse_to_markdown_openocr(page) == \
            j.parse_to_markdown_openocr(page)


def test_host_helpers_match_jax():
    """The element → task table, the overlap filter and the crop pad."""
    for t in LayoutElementType:
        jt = JLayoutElementType(t.value)
        ours, ref = dp.task_for_element(t), jdp.task_for_element(jt)
        assert (ours and ours.value) == (ref and ref.value), t
        assert dp.is_auxiliary_element(t) == jdp.is_auxiliary_element(jt)
    rng = np.random.default_rng(3)
    labels = ["text", "image", "table", "reference", "title"]
    for _ in range(4):
        boxes = []
        for _ in range(12):
            x, y = rng.uniform(0, 200, 2)
            w, h = rng.uniform(5, 120, 2)
            boxes.append(types.SimpleNamespace(
                label=labels[rng.integers(len(labels))],
                box=np.array([x, y, x + w, y + h], np.float32)))
        assert dp.filter_overlap_boxes(boxes, 0.7) == \
            jdp.filter_overlap_boxes(boxes, 0.7)
        xyxy = tuple(float(v) for v in boxes[0].box)
        for ratio in (0.0, 0.1, 0.5):
            assert dp.pad_bbox(xyxy, 250.0, 180.0, ratio) == \
                jdp.pad_bbox(xyxy, 250.0, 180.0, ratio)
    assert dp.DocParserConfig().markdown_ignore_labels == \
        jdp.DocParserConfig().markdown_ignore_labels
    assert {k.value: v for k, v in dp.MINERU_TASK_PROMPTS.items()} == \
        {k.value: v for k, v in jdp.MINERU_TASK_PROMPTS.items()}

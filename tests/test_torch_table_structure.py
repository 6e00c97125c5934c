"""The port's ``OARStructure`` with tables on against the JAX package on
the CPU, in float32, and the builder's table options.

The pipelines: a stub layout that reports the drawn tables and a text
block on both pages, and a stub overall OCR that reports one box per
table text block, one box spanning two cells and one over the text
block (``torch_table_common.ocr_inputs``; the same regions for both
packages: the layout models and the OCR pipeline have their own tests),
with one perturbed random recognizer (as ``test_torch_structure.py``)
for what the table stage recognizes again; and the wired-route
``TableAnalyzer`` of ``test_torch_table_pipeline.py`` (SLANet, the cell
detector; ``torch_table_common.py``).

Gates: the same elements per page in the same order, with equal labels,
order indices and texts, boxes within 1e-3 px; each table's HTML and
cell texts equal and its cell boxes within 1e-3 px; ``to_markdown()``
and ``to_html()`` equal.
"""

from types import SimpleNamespace

import jax
import numpy as np

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.domain.layout import LayoutBox as JLayoutBox
from oar_ocr_tpu.domain.text_region import TextRegion as JTextRegion
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
from oar_ocr_tpu_torch.domain.layout import LayoutBox
from oar_ocr_tpu_torch.domain.text_region import TextRegion
from oar_ocr_tpu_torch.models.recognition.slanet import SLANetModel
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.pipelines.structure import (OARStructure,
                                                   OARStructureBuilder,
                                                   OARStructureConfig)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax, read_safetensors
from torch_table_common import (BENCH_DET, CELL_VARIANT, analyzer_pair,
                                make_flats, ocr_inputs, pages, perturbed,
                                table_boxes)

TEXT_BLOCK = (240, 20, 460, 60)


class StubLayout:
    """A layout detector that reports the drawn tables and a text block
    above them on every page (the same boxes for both packages; the
    layout models have their own tests)."""

    def __init__(self, box_cls):
        self.box_cls = box_cls

    def detect(self, pages_u8, shapes, page_indices=None):
        boxes = [self.box_cls("table", 0.9, np.asarray(b, np.float32))
                 for b in table_boxes()]
        boxes.append(self.box_cls("text", 0.8, np.array(TEXT_BLOCK,
                                                        np.float32)))
        return [list(boxes) for _ in shapes]


class StubOCR:
    """An overall OCR that reports ``ocr_inputs``' boxes and texts and a
    line over the text block on every page (the same regions for both
    packages), with a real ``recognizer`` for the table stage's
    fragments."""

    def __init__(self, region_cls, recognizer):
        self.region_cls, self.recognizer = region_cls, recognizer

    def predict(self, images, pages_dev=None):
        out = []
        for page in range(len(images)):
            boxes, texts = ocr_inputs(page)
            x0, y0, x1, y1 = TEXT_BLOCK
            boxes.append(np.array([[x0 + 4, y0 + 8], [x1 - 40, y0 + 8],
                                   [x1 - 40, y1 - 10], [x0 + 4, y1 - 10]],
                                  np.float32))
            texts.append(f"heading p{page}")
            out.append(SimpleNamespace(regions=[
                self.region_cls(box=b, text=t, confidence=0.9, det_score=0.9)
                for b, t in zip(boxes, texts)]))
        return out


def test_structure_with_tables_matches():
    """``OARStructure.predict`` with tables on (wired route, SLANet) and an
    overall OCR: the table stage, the OCR split at the detected cells and
    its fragments recognized again, the stitcher's cell matching; the
    same elements, table HTML and markdown, cell boxes within 1e-3 px."""
    jrt = JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))
    cpu = Runtime("float32", device="cpu")
    flats = make_flats(("slanet",))
    vocab = 2 + len(default_charset())
    rec = perturbed(flatten_params(init_params_fast(
        SVTRRecognizer(vocab_size=vocab), (1, 48, 64, 3))), 61, 0.05)
    det = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       load_params(str(BENCH_DET)))
    j_rec = (JBuilder("general").with_runtime(jrt).with_det_params(det)
             .with_rec_params(unflatten_params(rec))
             .with_batch_sizes(image=2, region=64).build().recognizer)
    t_rec = (OAROCRBuilder("general").with_runtime(cpu)
             .with_det_params(params_from_jax(read_safetensors(
                 str(BENCH_DET))))
             .with_rec_params(params_from_jax(rec))
             .with_batch_sizes(image=2, region=64).build().recognizer)
    j_tab, t_tab = analyzer_pair(flats, jrt, cpu, route="wired",
                                 structure="slanet")
    cfg = dict(use_formulas=False, use_seals=False, image_batch_size=2)
    j = JStructure(layout=StubLayout(JLayoutBox),
                   ocr=StubOCR(JTextRegion, j_rec), tables=j_tab,
                   formulas=None, seal_ocr=None,
                   cfg=JStructureConfig(**cfg), runtime=jrt)
    t = OARStructure(layout=StubLayout(LayoutBox),
                     ocr=StubOCR(TextRegion, t_rec), tables=t_tab,
                     cfg=OARStructureConfig(**cfg), runtime=cpu)
    imgs = pages()
    ref = j.predict(imgs)
    got = t.predict(imgs)
    n_tables = 0
    for g, r in zip(got, ref):
        assert len(g.elements) == len(r.elements)
        for a, b in zip(g.elements, r.elements):
            assert (a.label, a.order_index, a.text) == (b.label,
                                                        b.order_index, b.text)
            np.testing.assert_allclose(np.asarray(a.box, np.float32),
                                       np.asarray(b.box, np.float32),
                                       atol=1e-3, rtol=0)
            assert (a.table is None) == (b.table is None)
            if a.table is not None:
                n_tables += 1
                assert (a.table.html, a.table.cell_texts) == \
                    (b.table.html, b.table.cell_texts)
                np.testing.assert_allclose(
                    np.asarray(a.table.cell_boxes, np.float32),
                    np.asarray(b.table.cell_boxes, np.float32),
                    atol=1e-3, rtol=0)
        assert g.to_markdown() == r.to_markdown()
        assert g.to_html() == r.to_html()
    assert n_tables == 4
    assert any("<table" in g.to_markdown() for g in got)


def test_builder_builds_with_tables():
    """``OARStructureBuilder().with_formulas(False).build()`` builds with
    its default tables on: the default SLANet, the table classifier and
    the wired cell detector; the builder's table options reach the
    analyzer; with formulas on (the default) it builds too."""
    cpu = Runtime("float32", device="cpu")
    pipe = OARStructureBuilder().with_runtime(cpu).with_formulas(False) \
        .with_overall_ocr(False).with_seals(False).build()
    assert pipe.cfg.use_tables and pipe.tables is not None
    assert isinstance(pipe.tables.structure, SLANetModel)
    assert pipe.tables.cell_detector.variant.name == CELL_VARIANT
    assert pipe.tables.cell_detector.score_thresh == 0.3
    assert pipe.tables.orientation is None
    marker = object()
    b = (OARStructureBuilder().with_runtime(cpu).with_formulas(False)
         .with_table_orientation().with_cells_to_html()
         .with_wired_table_structure(marker)
         .with_wireless_table_cell_detection(marker))
    assert b._table_kw == {"use_cells_to_html": True,
                           "wired_structure": marker,
                           "wireless_cell_detector": marker}
    assert b._cfg.use_table_orientation
    pipe = OARStructureBuilder().with_runtime(cpu).with_overall_ocr(False) \
        .with_seals(False).build()
    assert pipe.formulas is not None and pipe.tables is not None

"""The port's own copies of the JAX package's host modules against the
originals.

The port imports nothing of ``oar_ocr_tpu``; it keeps copies of the host
code it needs. Each copied module is held here against its JAX original
on a few seeded inputs, one parametrised test per module, with exact
equality (the code is the same arithmetic on the same numpy inputs). The
port's native DB extension (``oar_ocr_tpu_torch/native.py``) is held
against the port's pure-Python path, which it replaces when it builds.
"""

import dataclasses

import numpy as np
import pytest

from oar_ocr_tpu import errors as j_errors
from oar_ocr_tpu.core import constants as j_constants
from oar_ocr_tpu.core import types as j_types
from oar_ocr_tpu.domain import layout as j_layout
from oar_ocr_tpu.domain import markdown as j_markdown
from oar_ocr_tpu.domain import structure as j_structure
from oar_ocr_tpu.domain import text_region as j_text_region
from oar_ocr_tpu.ops import resize as j_resize
from oar_ocr_tpu.processors import db_postprocess as j_db
from oar_ocr_tpu.pipelines import stitching as j_stitching
from oar_ocr_tpu.processors import geometry as j_geometry
from oar_ocr_tpu.processors import layout_sorting as j_layout_sorting
from oar_ocr_tpu.processors import layout_utils as j_layout_utils
from oar_ocr_tpu.processors import sorting as j_sorting
from oar_ocr_tpu.processors import table as j_table
from oar_ocr_tpu.processors import table_ocr_split as j_table_ocr_split
from oar_ocr_tpu.processors import word_boxes as j_word_boxes
from oar_ocr_tpu.utils import tracing as j_tracing
from oar_ocr_tpu.config import validation as j_validation
from oar_ocr_tpu.ops import ctc as j_ctc
from oar_ocr_tpu.serving import engine as j_engine
from oar_ocr_tpu.tasks import tasks as j_tasks
from oar_ocr_tpu.utils import image as j_image
from oar_ocr_tpu.models.recognition import formula as j_formula
from oar_ocr_tpu.models.recognition import pp_formulanet_exact as j_pfn
from oar_ocr_tpu.models.recognition import slanet as j_slanet
from oar_ocr_tpu.models.recognition import unimernet as j_unimernet
from oar_ocr_tpu_torch import errors, native
from oar_ocr_tpu_torch.core import constants, types
from oar_ocr_tpu_torch.domain import (layout, markdown, structure,
                                      text_region)
from oar_ocr_tpu_torch.ops import resize
from oar_ocr_tpu_torch.processors import db_postprocess as db
from oar_ocr_tpu_torch.pipelines import stitching
from oar_ocr_tpu_torch.models.recognition import (formula, slanet,
                                                   unimernet)
from oar_ocr_tpu_torch.models.recognition import pp_formulanet_exact as pfn
from oar_ocr_tpu_torch.processors import (geometry, layout_sorting,
                                          layout_utils, sorting, table,
                                          table_ocr_split, word_boxes)
from oar_ocr_tpu_torch.utils import tracing
from oar_ocr_tpu_torch.config import validation
from oar_ocr_tpu_torch.ops import ctc
from oar_ocr_tpu_torch.serving import engine
from oar_ocr_tpu_torch.tasks import tasks
from oar_ocr_tpu_torch.utils import image


def _quads(seed, n=6):
    """Seeded convex quads (jittered rotated rectangles), float32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(20, 300, 2)
        w, h = rng.uniform(4, 80), rng.uniform(3, 30)
        a = rng.uniform(-0.6, 0.6)
        r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        pts = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2 @ r.T
        out.append((pts + [cx, cy]).astype(np.float32)[rng.permutation(4)])
    return out


def _bitmap(seed):
    rng = np.random.default_rng(seed)
    bm = np.zeros((64, 96), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, 56), rng.integers(0, 80)
        bm[y:y + rng.integers(3, 9), x:x + rng.integers(4, 16)] = 1
    return bm


@pytest.mark.parametrize("name", [
    "REC_IMAGE_SHAPE", "REC_MAX_WIDTH", "DET_LIMIT_SIDE_LEN",
    "DET_MAX_SIDE_LEN", "MAX_POOLED_CROPS", "IMAGENET_MEAN", "IMAGENET_STD"])
def test_constants_match(name):
    assert getattr(constants, name) == getattr(j_constants, name)


@pytest.mark.parametrize("enum_name", ["LimitType", "BoxType", "ScoreMode",
                                       "Rotation"])
def test_types_match(enum_name):
    ours, ref = getattr(types, enum_name), getattr(j_types, enum_name)
    assert [(m.name, m.value) for m in ours] == \
        [(m.name, m.value) for m in ref]


@pytest.mark.parametrize("seed", [0, 1])
def test_errors_match(seed):
    rng = np.random.default_rng(seed)
    ctx = {"shape": tuple(int(v) for v in rng.integers(1, 9, 3)),
           "dtype": "uint8"}
    for cls in ("OCRError", "InvalidInputError", "ConfigError",
                "ModelLoadError", "UnsupportedError", "ImageLoadError"):
        ours, ref = getattr(errors, cls)("bad", **ctx), \
            getattr(j_errors, cls)("bad", **ctx)
        assert (str(ours), dict(ours.context)) == (str(ref), dict(ref.context))
        assert isinstance(ours, errors.OCRError)
    causes = [ValueError(f"v{i}") for i in range(int(rng.integers(1, 6)))]
    items = [(i, errors.batch_item_error("detection", i, 8, c))
             for i, c in enumerate(causes)]
    j_items = [(i, j_errors.batch_item_error("detection", i, 8, c))
               for i, c in enumerate(causes)]
    assert [str(e) for _, e in items] == [str(e) for _, e in j_items]
    assert items[0][1].__cause__ is causes[0]
    assert errors.format_batch_error_message("detection", items, 8) == \
        j_errors.format_batch_error_message("detection", j_items, 8)


@pytest.mark.parametrize("seed", [0, 1])
def test_text_region_matches(seed):
    rng = np.random.default_rng(seed)
    fields = []
    for q in _quads(seed, 3):
        fields.append(dict(box=q, text=f"t{rng.integers(100)}",
                           confidence=float(rng.random()),
                           det_score=float(rng.random())))
    fields.append(dict(box=_quads(seed + 7, 1)[0]))     # no recognition
    ours = text_region.OAROCRResult(
        regions=[text_region.TextRegion(**f) for f in fields], width=480,
        height=320)
    ref = j_text_region.OAROCRResult(
        regions=[j_text_region.TextRegion(**f) for f in fields], width=480,
        height=320)
    assert ours.to_dict() == ref.to_dict()
    assert str(ours) == str(ref)
    assert (ours.texts, ours.all_text(), ours.recognized_text_count(),
            ours.average_confidence(), ours.concatenated_text()) == \
        (ref.texts, ref.all_text(), ref.recognized_text_count(),
         ref.average_confidence(), ref.concatenated_text())
    assert [r.xyxy for r in ours.regions] == [r.xyxy for r in ref.regions]


@pytest.mark.parametrize("limit_type", ["MAX", "MIN", "RESIZE_LONG"])
def test_resize_matches(limit_type):
    rng = np.random.default_rng(3)
    cfg = resize.DetResizeConfig(limit_side_len=736,
                                 limit_type=types.LimitType[limit_type])
    j_cfg = j_resize.DetResizeConfig(
        limit_side_len=736, limit_type=j_types.LimitType[limit_type])
    for h, w in [(1280, 960), (33, 4100), *rng.integers(10, 5000, (20, 2))]:
        assert resize.det_target_size(int(h), int(w), cfg) == \
            j_resize.det_target_size(int(h), int(w), j_cfg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_matches(seed):
    rng = np.random.default_rng(seed)
    for q in _quads(seed):
        np.testing.assert_array_equal(geometry.order_quad_points(q),
                                      j_geometry.order_quad_points(q))
        got, want = geometry.min_area_rect(q), j_geometry.min_area_rect(q)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        assert geometry.polygon_area(q) == j_geometry.polygon_area(q)
        assert geometry.polygon_perimeter(q) == \
            j_geometry.polygon_perimeter(q)
        for deg in (0, 90, 180, 270, 450):
            np.testing.assert_array_equal(
                geometry.rotate_points_back(q, deg, 480, 320),
                j_geometry.rotate_points_back(q, deg, 480, 320))
        before = q.copy()
        np.testing.assert_array_equal(geometry.clip_points(q, 200, 100),
                                      j_geometry.clip_points(q, 200, 100))
        np.testing.assert_array_equal(q, before)
    with pytest.raises(ValueError):
        geometry.rotate_points_back(_quads(seed)[0], 45, 10, 10)
    contour = np.cumsum(rng.normal(0, 3, (40, 2)), 0).astype(np.float32)
    np.testing.assert_array_equal(geometry.approx_poly_dp(contour, 2.0),
                                  j_geometry.approx_poly_dp(contour, 2.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorting_matches(seed):
    rng = np.random.default_rng(seed)
    boxes = _quads(seed, 12)
    # a few on one line, out of x order, to exercise the bubble pass
    boxes += [q + [rng.uniform(-200, 200), 0] for q in boxes[:3]]
    assert sorting.sort_quad_boxes_indices(boxes) == \
        j_sorting.sort_quad_boxes_indices(boxes)
    assert sorting.sort_quad_boxes_indices([]) == []
    polys = [np.concatenate([q, q[:2] + 5]) for q in boxes]
    assert sorting.sort_poly_boxes_indices(polys) == \
        j_sorting.sort_poly_boxes_indices(polys)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xycut_matches(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (14, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 120, (14, 2))], 1)
    for d in ("VERTICAL", "HORIZONTAL"):
        for gap in (1, 8):
            assert sorting.sort_by_xycut(
                boxes, sorting.SortDirection[d], gap) == \
                j_sorting.sort_by_xycut(boxes, j_sorting.SortDirection[d],
                                        gap)
    assert [m.value for m in sorting.SortDirection] == \
        [m.value for m in j_sorting.SortDirection]


# the copies that are line for line the originals but for one paragraph
# of their docstring
VERBATIM = ["domain/layout.py", "domain/structure.py", "domain/markdown.py",
            "processors/layout_sorting.py", "processors/table.py",
            "processors/table_ocr_split.py", "pipelines/stitching.py",
            "config/validation.py", "tasks/tasks.py", "utils/image.py",
            "errors.py", "core/types.py", "core/batch.py",
            "processors/geometry.py", "processors/layout_utils.py",
            "processors/layout_postprocess.py", "pipelines/processors.py",
            "utils/structure_match.py", "utils/visualization.py",
            "utils/pdf.py", "utils/pdf_render.py", "utils/font_glyphs.py",
            "runtime/onnx_extract.py", "registry/upstream.py", "vl/otsl.py"]


# the deliberate deviations: (first line, the line after) of the span
# that differs in both files; the PDF stream readers slice a stream by
# its resolved /Length and strip one end-of-line marker at most, where
# the originals strip every trailing CR and LF (test_torch_pdf.py holds
# their behaviour)
DEVIATIONS = {
    "utils/pdf_render.py": ("    def _scan_objects(self):",
                            "    def _expand_object_streams(self):"),
    "utils/pdf.py": ("        raw = data[start:end]",
                     "        filters = info.get(\"Filters\", [])"),
}


def _without(text, span):
    start, stop = span
    a = text.index(start)
    return text[:a] + text[text.index(stop, a):]


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copies(path):
    """The copy's source is the original's plus the one docstring
    paragraph that names the original, apart from a listed deviation."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ours = (root / "oar_ocr_tpu_torch" / path).read_text()
    ref = (root / "oar_ocr_tpu" / path).read_text()
    note = ours.index("\n\nThe port's copy of ``oar_ocr_tpu/")
    end = ours.index('"""', note)
    ours = ours[:note] + "\n" + ours[end:]
    if path in DEVIATIONS:
        assert ours != ref
        ours, ref = (_without(t, DEVIATIONS[path]) for t in (ours, ref))
    assert ours == ref


def test_layout_variants_match():
    assert list(layout.LAYOUT_VARIANTS) == list(j_layout.LAYOUT_VARIANTS)
    assert len(layout.LAYOUT_VARIANTS) == 17
    for name, v in layout.LAYOUT_VARIANTS.items():
        ref = j_layout.LAYOUT_VARIANTS[name]
        assert dataclasses.asdict(v) == dataclasses.asdict(ref)
        assert v.num_classes == ref.num_classes
    assert layout.NO_OCR_LABELS == j_layout.NO_OCR_LABELS
    box = np.array([1.5, 2.0, 30.0, 40.25], np.float32)
    for label in ("text", "seal"):
        a, b = layout.LayoutBox(label, 0.5, box), j_layout.LayoutBox(
            label, 0.5, box)
        assert (a.xyxy, a.should_ocr()) == (b.xyxy, b.should_ocr())


_LABELS = ["doc_title", "paragraph_title", "text", "text", "abstract",
           "figure_title", "image", "formula", "formula_number", "header",
           "footer", "seal", "reference", "content", "chart", "number",
           "aside_text", "algorithm", "table", "footnote"]
_WORDS = ["Intro-", "duction of the", "1.2 Method", "Results", "as shown",
          "\u4e2d\u6587\u6587\u672c", "x^2 + y", "References", "\u2022 item one",
          "end."]


def _layout(mod, seed, n=14):
    """Seeded layout elements on a 600×800 page: two columns of blocks
    with texts, a few overlapping, labels from ``_LABELS``."""
    rng = np.random.default_rng(seed)
    els = []
    for i in range(n):
        col = i % 2
        x0 = 40 + col * 280 + rng.uniform(-10, 10)
        y0 = 40 + (i // 2) * 100 + rng.uniform(-8, 8)
        w, h = rng.uniform(120, 260), rng.uniform(20, 90)
        label = _LABELS[int(rng.integers(len(_LABELS)))]
        text = " ".join(_WORDS[int(k)] for k in
                        rng.integers(0, len(_WORDS), int(rng.integers(0, 4))))
        els.append(mod.LayoutElement(
            element_type=mod.LayoutElementType.from_label(label),
            box=np.array([x0, y0, x0 + w, y0 + h], np.float32),
            score=float(rng.uniform(0.3, 1.0)), label=label,
            text=text or None, num_lines=int(rng.integers(1, 4))))
    els.append(mod.LayoutElement(      # contained in element 0
        element_type=mod.LayoutElementType.TEXT,
        box=els[0].box + np.array([2, 2, -2, -2], np.float32),
        score=0.1, label="text", text="inner"))
    return els


def _regions(mod, seed, n=18):
    rng = np.random.default_rng(seed + 50)
    out = []
    for i in range(n):
        x0, y0 = rng.uniform(30, 500), rng.uniform(30, 720)
        w, h = rng.uniform(40, 200), rng.uniform(12, 26)
        out.append(mod.TextRegion(
            box=np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h],
                          [x0, y0 + h]], np.float32),
            text=_WORDS[i % len(_WORDS)] if i % 5 else "",
            confidence=float(rng.uniform(0.2, 1.0))))
    return out


def _element_fields(els):
    return [(e.element_type.value, e.label, e.text, e.order_index,
             e.num_lines, e.seg_start_x, e.seg_end_x,
             np.asarray(e.box, np.float32).tolist(), e.score)
            for e in els]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_structure_domain_matches(seed):
    """Element types, overlap removal, label fixes, the reading order,
    and the markdown, HTML and JSON exports of a page and of pages."""
    assert [(m.name, m.value) for m in structure.LayoutElementType] == \
        [(m.name, m.value) for m in j_structure.LayoutElementType]
    ours, ref = _layout(structure, seed), _layout(j_structure, seed)
    ours = structure.remove_overlapping_elements(ours)
    ref = j_structure.remove_overlapping_elements(ref)
    structure.fix_element_labels(ours)
    j_structure.fix_element_labels(ref)
    assert _element_fields(ours) == _element_fields(ref)
    lines = [e.num_lines or 1 for e in ours]
    order = layout_sorting.sort_layout_enhanced(ours, 600.0, 800.0, lines)
    assert order == j_layout_sorting.sort_layout_enhanced(ref, 600.0, 800.0,
                                                          lines)
    ours = [ours[i] for i in order]
    ref = [ref[i] for i in order]
    for i, (a, b) in enumerate(zip(ours, ref)):
        a.order_index = b.order_index = i + 1
    pages = [structure.StructureResult(elements=ours, width=600, height=800),
             structure.StructureResult(elements=ours[:4], width=600,
                                       height=800)]
    j_pages = [j_structure.StructureResult(elements=ref, width=600,
                                           height=800),
               j_structure.StructureResult(elements=ref[:4], width=600,
                                           height=800)]
    for a, b in zip(pages, j_pages):
        assert a.to_markdown() == b.to_markdown()
        assert a.to_html() == b.to_html()
        assert a.to_json_value() == b.to_json_value()
    assert structure.concatenate_markdown_pages(pages) == \
        j_structure.concatenate_markdown_pages(j_pages) != ""
    for text in _WORDS + [" ".join(_WORDS), "Abstract: we", "1.2.3 Title"]:
        for fn in ("clean_ocr_text", "dehyphenate", "fix_merged_words",
                   "format_text_block", "semantic_title_level",
                   "has_bullet_markers", "format_as_bullet_list"):
            assert getattr(markdown, fn)(text) == getattr(j_markdown, fn)(
                text), fn


def _grid(seed):
    """A seeded table: a grid of 3-6 rows × 2-5 columns of jittered cells
    on a 600×800 page (xyxy), its structure tokens (a ``<thead>`` row,
    one colspan), and OCR boxes: one per cell, a few spanning two cells,
    one outside."""
    rng = np.random.default_rng(seed)
    rows, cols = int(rng.integers(3, 7)), int(rng.integers(2, 6))
    x0, y0 = rng.uniform(40, 120), rng.uniform(60, 200)
    ws, h = rng.uniform(60, 110, cols), rng.uniform(24, 40)
    xs = x0 + np.concatenate([[0], np.cumsum(ws)])
    cells, tokens = [], ["<thead>"]
    for r in range(rows):
        tokens.append("<tr>")
        c = 0
        while c < cols:
            span = 2 if (r == 1 and c == 0 and cols > 2) else 1
            cells.append([xs[c] + rng.uniform(0, 2), y0 + r * h,
                          xs[c + span] - rng.uniform(0, 2),
                          y0 + (r + 1) * h - rng.uniform(0, 2)])
            tokens += (["<td", ' colspan="2"', ">", "</td>"] if span == 2
                       else ["<td></td>"])
            c += span
        tokens.append("</tr>")
        if r == 0:
            tokens += ["</thead>", "<tbody>"]
    tokens.append("</tbody>")
    cells = np.asarray(cells, np.float32)
    ocr = [[b[0] + 4, b[1] + 5, b[2] - rng.uniform(4, 20), b[3] - 5]
           for b in cells]
    for _ in range(2):
        i = int(rng.integers(0, len(cells) - 1))
        ocr.append([cells[i][0] + 3, cells[i][1] + 4,
                    cells[i + 1][2] - 3, cells[i][3] - 4])
    ocr.append([500.0, 700.0, 560.0, 720.0])
    texts = [_WORDS[i % len(_WORDS)] for i in range(len(ocr))]
    return cells, tokens, np.asarray(ocr, np.float32), texts


def _table_cells(mod, cells, tokens):
    grid = mod.parse_cell_grid_info(tokens)
    return [mod.TableCell(tuple(map(float, b)), row=grid[k].row,
                          col=grid[k].col) for k, b in enumerate(cells)]


def _cells(cells):
    return [(c.bbox, c.row, c.col, c.text) for c in cells]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_processors_match(seed):
    """``processors/table.py``, ``table_ocr_split.py`` and the copied
    ``layout_utils.reconcile_table_cells`` on a seeded grid: the grid
    parse, the HTML, the cells-to-structure rebuild, the OCR box split,
    both matchers, the text joins and the reconciliation."""
    cells, tokens, ocr, texts = _grid(seed)
    ocr_t = [tuple(map(float, b)) for b in ocr]
    assert [dataclasses.asdict(c) for c in table.parse_cell_grid_info(
        tokens)] == [dataclasses.asdict(c) for c in
                     j_table.parse_cell_grid_info(tokens)]
    assert table.wrap_table_html(tokens, texts) == j_table.wrap_table_html(
        tokens, texts)
    got = table.table_cells_to_html_structure(cells, 5.0)
    ref = j_table.table_cells_to_html_structure(cells, 5.0)
    assert got[0] == ref[0] and [(i, dataclasses.asdict(c))
                                 for i, c in got[1]] == \
        [(i, dataclasses.asdict(c)) for i, c in ref[1]]
    assert table.split_ocr_boxes_by_cells(ocr_t, cells) == \
        j_table.split_ocr_boxes_by_cells(ocr_t, cells)
    for positive, paddlex in ((True, False), (False, True)):
        assert table.match_table_and_ocr_by_iou_distance(
            _table_cells(table, cells, tokens), ocr_t, positive, paddlex) \
            == j_table.match_table_and_ocr_by_iou_distance(
                _table_cells(j_table, cells, tokens), ocr_t, positive,
                paddlex)
    ours, ref = (_table_cells(table, cells, tokens),
                 _table_cells(j_table, cells, tokens))
    got = table.match_table_cells_with_structure_rows(
        ours, tokens, ocr_t, texts, has_detected_cells=True)
    want = j_table.match_table_cells_with_structure_rows(
        ref, tokens, ocr_t, texts, has_detected_cells=True)
    assert got == want and got is not None
    assert _cells(ours) == _cells(ref)
    assert table.collect_cell_texts_for_tokens(ours, tokens) == \
        j_table.collect_cell_texts_for_tokens(ref, tokens)
    idx = list(range(len(texts)))
    assert table.join_ocr_texts_paddlex_style(idx, texts) == \
        j_table.join_ocr_texts_paddlex_style(idx, texts)
    assert table.compose_matched_cell_text(idx, texts) == \
        j_table.compose_matched_cell_text(idx, texts)
    got = table_ocr_split.create_expanded_ocr_for_table(
        ocr_t, texts, [0.9] * len(texts), [tuple(c) for c in cells])
    want = j_table_ocr_split.create_expanded_ocr_for_table(
        ocr_t, texts, [0.9] * len(texts), [tuple(c) for c in cells])
    assert got == want and got[1]
    rng = np.random.default_rng(seed)
    detected = np.concatenate([cells + rng.normal(0, 2, cells.shape),
                               cells[:3] + 1.0]).astype(np.float32)
    for det in (detected, detected[:len(cells) - 2], detected[:0]):
        np.testing.assert_array_equal(
            layout_utils.reconcile_table_cells(cells, det),
            j_layout_utils.reconcile_table_cells(cells, det))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slanet_host_matches(seed):
    """The table models' host pieces: the vocabulary, ``decode_structure``
    (EOS stop, SOS skip, cell boxes), and the k·90° de-rotation."""
    assert slanet.TABLE_STRUCTURE_VOCAB == j_slanet.TABLE_STRUCTURE_VOCAB
    assert (slanet.SOS_ID, slanet.EOS_ID, slanet.CELL_TOKENS) == \
        (j_slanet.SOS_ID, j_slanet.EOS_ID, j_slanet.CELL_TOKENS)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, len(slanet.TABLE_STRUCTURE_VOCAB) + 2, 40)
    ids[int(rng.integers(10, 40))] = slanet.EOS_ID
    ids[3] = slanet.SOS_ID
    conf = rng.random(40).astype(np.float32)
    locs = rng.random((40, 8)).astype(np.float32)
    got = slanet.decode_structure(ids, conf, locs)
    want = j_slanet.decode_structure(ids, conf, locs)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    boxes = rng.uniform(0, 90, (5, 8)).astype(np.float32)
    for ang in (0, 90, 180, 270):
        w, h = int(rng.integers(40, 300)), int(rng.integers(40, 300))
        assert slanet.derot_dims(ang, w, h) == j_slanet.derot_dims(ang, w, h)
        np.testing.assert_array_equal(slanet.rotation_matrix(ang, w, h),
                                      j_slanet.rotation_matrix(ang, w, h))
        np.testing.assert_array_equal(
            slanet.rotate_boxes_back(boxes, ang, w, h),
            j_slanet.rotate_boxes_back(boxes, ang, w, h))
    st = slanet.TableStructure(got[0], got[1], 0.5)
    assert st.html_body == j_slanet.TableStructure(want[0], want[1],
                                                   0.5).html_body


def _formula_crop(rng):
    h, w = int(rng.integers(6, 120)), int(rng.integers(6, 400))
    img = np.full((h, w, 3), 255, np.uint8)
    if rng.random() < 0.8:
        for _ in range(int(rng.integers(1, 6))):
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            img[y:y + int(rng.integers(1, 20)), x:x + int(rng.integers(1, 60))] \
                = rng.integers(0, 250, 3)
    return img


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_formula_host_matches(seed):
    """The formula recognizers' host pieces: the special ids, the margin
    crop, UniMERNet's preprocess, LaTeX normalization and token
    filtering, ``FormulaResult``, the pow2 decode buckets, and the Swin
    helpers (relative position index, shift mask)."""
    assert (formula.BOS_ID, formula.EOS_ID, formula.PAD_ID) == \
        (j_formula.BOS_ID, j_formula.EOS_ID, j_formula.PAD_ID)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        img = _formula_crop(rng)
        kw = dict(thresh=int(rng.integers(150, 250)),
                  pad=int(rng.integers(0, 10)))
        np.testing.assert_array_equal(
            formula.crop_formula_margins(img, **kw),
            j_formula.crop_formula_margins(img, **kw))
        np.testing.assert_array_equal(formula.unimernet_preprocess(img),
                                      j_formula.unimernet_preprocess(img))
    text = " \\frac{a}{b}\t<s> x^2 \\ +\n <pad>y</s><unk>  z "
    assert formula.filter_tokens(text) == j_formula.filter_tokens(text)
    assert formula.normalize_latex(text) == j_formula.normalize_latex(text)
    assert dataclasses.asdict(formula.FormulaResult("x", 0.5)) == \
        dataclasses.asdict(j_formula.FormulaResult("x", 0.5))
    for n in (0, 1, 8, 9, 100, 256, 300):
        assert unimernet.decode_bucket(n) == j_pfn._decode_bucket(n)
    w = int(rng.integers(2, 9))
    np.testing.assert_array_equal(unimernet.relative_position_index(w),
                                  j_unimernet.relative_position_index(w))
    hp, wp = w * int(rng.integers(2, 5)), w * int(rng.integers(2, 5))
    np.testing.assert_array_equal(
        unimernet.shift_attn_mask(hp, wp, w, w // 2),
        j_unimernet.shift_attn_mask(hp, wp, w, w // 2))
    assert dataclasses.asdict(pfn.PPFormulaNetConfig().large()) == \
        dataclasses.asdict(j_pfn.PPFormulaNetConfig().large())
    assert dataclasses.asdict(unimernet.UniMERNetConfig()) == \
        dataclasses.asdict(j_unimernet.UniMERNetConfig())


def _table_page(mod, tab, text_mod, seed, e2e):
    """``_layout``'s elements plus a table element over ``_grid``'s cells
    (cells, structure tokens, ``is_e2e``) and the page's regions plus one
    per OCR box of the grid."""
    cells, tokens, ocr, texts = _grid(seed)
    els = _layout(mod, seed)
    x0, y0 = cells[:, :2].min(0) - 2
    x1, y1 = cells[:, 2:].max(0) + 2
    els.append(mod.LayoutElement(
        element_type=mod.LayoutElementType.TABLE,
        box=np.array([x0, y0, x1, y1], np.float32), score=0.9,
        label="table", table=mod.TableResult(
            html="", cell_boxes=cells, is_e2e=e2e, structure_tokens=tokens,
            cells=_table_cells(tab, cells, tokens))))
    regions = _regions(text_mod, seed) + [text_mod.TextRegion(
        box=np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]],
                      [b[0], b[3]]], np.float32), text=t, confidence=0.9)
        for b, t in zip(ocr, texts)]
    return els, regions


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stitching_matches(seed):
    """``ResultStitcher.stitch``: OCR text into elements and into a
    table's cells (the cross-cell split, row-aware matching for a
    detection-backed table, the IoU/distance matcher for an end-to-end
    one), orphans, the reading order and order indices."""
    ours = stitching.ResultStitcher().stitch(
        _layout(structure, seed), _regions(text_region, seed), 600, 800)
    ref = j_stitching.ResultStitcher().stitch(
        _layout(j_structure, seed), _regions(j_text_region, seed), 600, 800)
    assert _element_fields(ours) == _element_fields(ref)
    assert [[r.text for r in e.text_regions] for e in ours] == \
        [[r.text for r in e.text_regions] for e in ref]
    assert any(e.text for e in ours) and any(e.order_index for e in ours)
    els = _layout(structure, seed)
    stitching.assign_order_indices(els)
    j_els = _layout(j_structure, seed)
    j_stitching.assign_order_indices(j_els)
    assert _element_fields(els) == _element_fields(j_els)
    for e2e in (False, True):
        ours = stitching.ResultStitcher().stitch(
            *_table_page(structure, table, text_region, seed, e2e), 600, 800)
        ref = j_stitching.ResultStitcher().stitch(
            *_table_page(j_structure, j_table, j_text_region, seed, e2e),
            600, 800)
        assert _element_fields(ours) == _element_fields(ref)
        got = [e.table for e in ours if e.table is not None]
        want = [e.table for e in ref if e.table is not None]
        assert len(got) == len(want) == 1
        assert got[0].html == want[0].html and "<td" in got[0].html
        assert got[0].cell_texts == want[0].cell_texts
        assert any(got[0].cell_texts)
        assert _cells(got[0].cells) == _cells(want[0].cells)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_db_postprocess_matches(seed):
    kw = dict(box_thresh=0.5, unclip_ratio=1.5 + seed * 0.5, min_size=3.0)
    ours = db.DBPostProcess(db.DBPostProcessConfig(**kw))
    ref = j_db.DBPostProcess(j_db.DBPostProcessConfig(**kw))
    assert dataclasses.asdict(ours.cfg).keys() == \
        dataclasses.asdict(ref.cfg).keys()
    bm = _bitmap(seed)
    minis, j_minis = ours.quad_candidates(bm), ref.quad_candidates(bm)
    assert len(minis) == len(j_minis) > 0
    for a, b in zip(minis, j_minis):
        np.testing.assert_array_equal(a, b)
    for q in _quads(seed) + minis:
        np.testing.assert_array_equal(db.order_mini_box_points(q),
                                      j_db.order_mini_box_points(q))
        assert db.unclip_delta(q, 2.0) == j_db.unclip_delta(q, 2.0)
        np.testing.assert_array_equal(db.expand_rect(q, 1.5),
                                      j_db.expand_rect(q, 1.5))
        got, want = db.get_mini_box(q), j_db.get_mini_box(q)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        got = ours.finalize_quad_geometry(q, 2.0, 1.5, 640, 480)
        want = ref.finalize_quad_geometry(q, 2.0, 1.5, 640, 480)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def _pred(seed, bm):
    """A probability map that is high on the bitmap and noisy off it."""
    rng = np.random.default_rng(seed + 100)
    return (bm * 0.6 + rng.random(bm.shape) * 0.4).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_db_postprocess_poly_matches(seed):
    """The POLY parts: candidates, host box score, raster unclip,
    finalize, and the whole-host ``__call__`` for each box type and
    score mode (the slow-score path)."""
    bm = _bitmap(seed)
    pred = _pred(seed, bm)
    for box_type in ("QUAD", "POLY"):
        for mode in ("FAST", "SLOW"):
            kw = dict(box_thresh=0.5, unclip_ratio=1.5,
                      box_type=types.BoxType[box_type],
                      score_mode=types.ScoreMode[mode])
            j_kw = dict(kw, box_type=j_types.BoxType[box_type],
                        score_mode=j_types.ScoreMode[mode])
            ours = db.DBPostProcess(db.DBPostProcessConfig(**kw))
            ref = j_db.DBPostProcess(j_db.DBPostProcessConfig(**j_kw))
            (boxes, scores), (jb, js) = (ours(pred, bm, 192, 128),
                                         ref(pred, bm, 192, 128))
            assert scores == js and len(boxes) == len(jb) > 0
            for a, b in zip(boxes, jb):
                np.testing.assert_array_equal(a, b)
    post = db.DBPostProcess(db.DBPostProcessConfig(box_thresh=0.4))
    j_post = j_db.DBPostProcess(j_db.DBPostProcessConfig(box_thresh=0.4))
    polys, j_polys = post.poly_candidates(bm), j_post.poly_candidates(bm)
    assert len(polys) == len(j_polys) > 0
    for a, b in zip(polys, j_polys):
        np.testing.assert_array_equal(a, b)
        assert db.box_score(pred, a) == j_db.box_score(pred, a)
        for delta in (0.4, 2.5):
            got = db.unclip_polygon_raster(a, delta)
            want = j_db.unclip_polygon_raster(a, delta)
            np.testing.assert_array_equal(got, want)
        for score in (0.3, 0.9):
            got = post.finalize_poly(a, score, 2.0, 1.5, 192, 96)
            want = j_post.finalize_poly(a, score, 2.0, 1.5, 192, 96)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_word_boxes_match(seed):
    rng = np.random.default_rng(seed)
    m = np.array([[1.1, 0.2, 30.0], [-0.1, 0.9, 40.0], [1e-4, 0.0, 1.0]],
                 np.float32)
    text = "ab cd  e"
    cols = sorted(rng.choice(40, len(text), replace=False).tolist())
    got = word_boxes.word_boxes(m, 180, 32, 270, 34, cols, text)
    want = j_word_boxes.word_boxes(m, 180, 32, 270, 34, cols, text)
    assert [w for w, _ in got] == [w for w, _ in want] == ["ab", "cd", "e"]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert word_boxes.word_boxes(m, 180, 32, 270, 34, [], "") == []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_matches_python_path(seed):
    """The port's native extension builds here and gives the Python
    path's candidates (as a set: the two enumerate contours in another
    order) and its finalized quads."""
    assert native.available()
    assert native.library_path().parent == native.BUILD_DIR
    bm = _bitmap(seed)
    post = db.DBPostProcess(db.DBPostProcessConfig())

    def key(q):
        return tuple(np.round(q.mean(0), 1))

    py = sorted(post.quad_candidates(bm), key=key)
    nat = sorted((db.order_mini_box_points(q) for q, _ in native.db_candidates(
        np.packbits(bm, axis=-1), *bm.shape, 3.0, 1000)), key=key)
    assert len(nat) == len(py) > 0
    for a, b in zip(nat, py):
        np.testing.assert_allclose(a, b, atol=1e-4)
    fin = post.finalize_quads_batch(py, 2.0, 1.5, 192, 96)
    for got, m in zip(fin, py):
        want = post.finalize_quad_geometry(m, 2.0, 1.5, 192, 96)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stages", [("a",), ("a", "b", "a")])
def test_tracing_matches(stages):
    ours, ref = tracing.StageMetrics(), j_tracing.StageMetrics()
    for i, s in enumerate(stages):
        ours.record(s, 0.5 * (i + 1))
        ref.record(s, 0.5 * (i + 1))
    assert ours.summary() == ref.summary()
    ours.reset()
    assert ours.summary() == {}
    before = tracing.METRICS.summary().get("copy.test", (0,))[0]
    with tracing.stage_timer("copy.test", n=1):
        pass
    assert tracing.METRICS.summary()["copy.test"][0] == before + 1
    assert tracing.METRICS is not j_tracing.METRICS


def _outcome(fn, *args, **kw):
    """(value, None) or (None, (error class name, message, context))."""
    try:
        return fn(*args, **kw), None
    except Exception as e:  # noqa: BLE001
        return None, (type(e).__name__, str(e),
                      dict(getattr(e, "context", {}) or {}))


@pytest.mark.parametrize("text", [
    "", "abc 123", "\u0645\u0631\u062d\u0628\u0627", "a\u0628c 1.5% \u062c-d",
    "\u0633\u0639\u0631 25.00 + 3*x/y: \u062a\u0645"])
def test_pred_reverse_matches(text):
    assert ctc.pred_reverse(text) == j_ctc.pred_reverse(text)
    raw = (np.array([[3, 3, 0, 5, 6, 1]]), np.linspace(0.5, 1, 6)[None],
           np.array([[1, 0, 0, 1, 1, 1]], bool))
    charset = list(text) or ["x"]
    for rev in (False, True):
        for space in (False, True):
            ours = ctc.CTCLabelDecoder(charset, use_space_char=space,
                                       reverse=rev)
            ref = j_ctc.CTCLabelDecoder(charset, use_space_char=space,
                                        reverse=rev)
            assert ours.vocab_size == ref.vocab_size
            assert ours(raw) == ref(raw)
            assert ours.decode_with_positions(raw) == \
                ref.decode_with_positions(raw)


@pytest.mark.parametrize("body", [
    "a\nb\nc\n", "a\r\n \nb\n\n\nc", "\u4e2d\n\u6587\n\t\n", ""])
def test_load_charset_matches(tmp_path, body):
    path = tmp_path / "dict.txt"
    path.write_bytes(body.encode("utf-8"))
    assert ctc.load_charset(str(path)) == j_ctc.load_charset(str(path))
    if "\r" in body:
        # a space line survives; "\r\n" reads as one newline (text mode)
        assert ctc.load_charset(str(path)) == ["a", " ", "b", "c"]


def _configs(mod):
    """Configs in and out of their RULES, the port's or the JAX module's
    classes."""
    return [
        mod.TextDetectionConfig(), mod.TextDetectionConfig(thresh=1.5),
        mod.TextDetectionConfig(max_candidates=0),
        mod.TextRecognitionConfig(score_thresh=-0.1),
        mod.TextRecognitionConfig(charset_path="/nonexistent/dict"),
        mod.LayoutDetectionConfig(), mod.LayoutDetectionConfig(variant="x"),
        mod.LayoutDetectionConfig(variant="pp-doclayout-m", nms_iou=2.0),
        mod.TableStructureConfig(max_steps=0),
        mod.TableStructureConfig(max_steps=2001),
        mod.FormulaRecognitionConfig(model_type="unimernet"),
        mod.FormulaRecognitionConfig(model_type="nougat"),
        mod.FormulaRecognitionConfig(max_len=0),
        mod.SealTextDetectionConfig(), mod.ClassificationConfig(1.5),
        mod.RectificationConfig()]


def test_validation_and_task_rules_match():
    for ours, ref in zip(_configs(tasks), _configs(j_tasks)):
        assert {k: dataclasses.asdict(r) for k, r in
                getattr(type(ours), "RULES", {}).items()} == \
            {k: dataclasses.asdict(r) for k, r in
             getattr(type(ref), "RULES", {}).items()}
        assert _outcome(validation.validate_config, ours) == \
            _outcome(j_validation.validate_config, ref)
    rule = {"x": validation.Rule(min=1, optional=False)}
    j_rule = {"x": j_validation.Rule(min=1, optional=False)}

    class Cfg:
        x = None
    assert _outcome(validation.validate_config, Cfg(), rule) == \
        _outcome(j_validation.validate_config, Cfg(), j_rule)
    assert validation.Rule() == validation.Rule(min=None)
    for over in (tasks.TextDetectionConfig(thresh=None, box_thresh=0.1),
                 None):
        j_over = (None if over is None else
                  j_tasks.TextDetectionConfig(thresh=None, box_thresh=0.1))
        a = validation.merged(tasks.TextDetectionConfig(), over)
        b = j_validation.merged(j_tasks.TextDetectionConfig(), j_over)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [t.value for t in tasks.TaskType] == \
        [t.value for t in j_tasks.TaskType]
    assert {k.value: (d.config_cls.__name__, d.description)
            for k, d in tasks.TASK_REGISTRY.items()} == \
        {k.value: (d.config_cls.__name__, d.description)
         for k, d in j_tasks.TASK_REGISTRY.items()}


@pytest.mark.parametrize("images", [
    "x", [np.zeros((4, 4), np.uint8)], [np.zeros((4, 4, 3), np.float32)],
    [np.zeros((0, 4, 3), np.uint8)], [np.zeros((4, 4, 4), np.uint8)],
    (np.zeros((4, 4, 3), np.uint8),), [np.zeros((4, 4, 3), np.uint8), 3]])
def test_validate_images_input_matches(images):
    assert _outcome(tasks.validate_images_input, images, "t") == \
        _outcome(j_tasks.validate_images_input, images, "t")


@pytest.mark.parametrize("seed", [0, 1])
def test_image_utils_match(tmp_path, seed):
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (int(rng.integers(20, 60)),
                                int(rng.integers(20, 60)), 3), np.uint8)
    paths = []
    for i in range(3):
        p = tmp_path / f"i{i}.png"
        cv2.imwrite(str(p), np.roll(img, i, axis=1))
        paths.append(str(p))
    (tmp_path / "bad.png").write_bytes(b"x")
    paths.insert(1, str(tmp_path / "bad.png"))
    for policy in ("FAIL_FAST", "SKIP_ERRORS"):
        a = _outcome(image.load_images, paths, image.BatchLoadPolicy[policy])
        b = _outcome(j_image.load_images, paths,
                     j_image.BatchLoadPolicy[policy])
        assert a[1] == b[1]
        if a[0] is not None:
            assert a[0][1] == b[0][1]
            assert all(np.array_equal(x, y) for x, y in zip(a[0][0], b[0][0]))
    for th, tw in ((32, 48), (64, 40)):
        (o, so), (r, sr) = (image.resize_and_pad(img, th, tw, 7),
                            j_image.resize_and_pad(img, th, tw, 7))
        assert so == sr and np.array_equal(o, r)
    quads = _quads(seed, 3)
    assert np.array_equal(image.mask_regions(img, quads, 9),
                          j_image.mask_regions(img, quads, 9))
    for box in ((-3.2, 4.5, 18.7, 30.1), (10, 10, 10, 10),
                (50.5, 2, 400, 3)):
        assert np.array_equal(image.crop_bounding_box(img, *box),
                              j_image.crop_bounding_box(img, *box))
    assert np.array_equal(
        image.draw_ocr_results(img, quads, ["ab", "", "c"]),
        j_image.draw_ocr_results(img, quads, ["ab", "", "c"]))


@pytest.mark.parametrize("kw", [
    {}, {"max_batch_size": 0}, {"max_wait_ms": -1.0},
    {"max_batch_size": 3, "max_wait_ms": 0.0, "max_queue": 0}])
def test_serving_config_matches(kw):
    a = _outcome(engine.ServingConfig, **kw)
    b = _outcome(j_engine.ServingConfig, **kw)
    assert (a[1] is None) == (b[1] is None)
    if a[1] is not None:
        assert a[1] == b[1]
    else:
        assert dataclasses.asdict(a[0]) == dataclasses.asdict(b[0])
    stats, j_stats = engine.ServingStats(), j_engine.ServingStats()
    for st in (stats, j_stats):
        st.requests, st.batches, st.batched_requests = 9, 4, 9
        st.latencies_ms.extend([3.0, 1.0, 7.5, 2.25])
    assert stats.snapshot() == j_stats.snapshot()


# --------- the host copies of the upstream-weight and utilities slice ---------

@pytest.mark.parametrize("seed", [0, 1])
def test_completed_copies_match(seed):
    """``errors`` (``InferenceErrorBuilder``, ``InferenceError``,
    ``DownloadError``), ``core/types`` (the enums and ``ImageScaleInfo``),
    ``processors/geometry`` (``AABB``, ``boxes_iou_matrix``,
    ``get_perspective_transform``, ``quad_crop_size``) and
    ``config/runtime`` (``BucketTable``, ``pow2_buckets``)."""
    from oar_ocr_tpu.config import runtime as j_cfg_runtime
    from oar_ocr_tpu_torch.config import runtime as cfg_runtime

    rng = np.random.default_rng(seed)
    cause = KeyError(f"k{seed}")
    shape = [int(v) for v in rng.integers(1, 64, 4)]
    a, b = ((m.InferenceError.for_model("det", "forward")
             .with_batch_index(seed).with_input_shape(shape)
             .with_context("ctx").build(cause)) for m in (errors, j_errors))
    assert (str(a), a.context, a.__cause__) == (str(b), b.context,
                                                b.__cause__)
    d, jd = errors.DownloadError("x", artifact="a"), \
        j_errors.DownloadError("x", artifact="a")
    assert (str(d), d.context) == (str(jd), jd.context)
    assert isinstance(d, errors.OCRError)
    for name in ("ResizeType", "TensorLayout", "ColorOrder", "CropMode"):
        assert [(m.name, m.value) for m in getattr(types, name)] == \
            [(m.name, m.value) for m in getattr(j_types, name)]
    hw = [int(v) for v in rng.integers(10, 900, 4)]
    si, jsi = types.ImageScaleInfo(*hw), j_types.ImageScaleInfo(*hw)
    assert (si.ratio_h, si.ratio_w) == (jsi.ratio_h, jsi.ratio_w)

    boxes = rng.uniform(0, 200, (7, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    boxes[2, 2] = boxes[2, 0]                        # a degenerate box
    with np.errstate(invalid="ignore"):
        assert np.array_equal(geometry.boxes_iou_matrix(boxes, boxes[:4]),
                              j_geometry.boxes_iou_matrix(boxes, boxes[:4]))
    for q, r in zip(_quads(seed), _quads(seed + 7)):
        o, jo = geometry.AABB.of(q), j_geometry.AABB.of(q)
        p, jp = geometry.AABB.of(r), j_geometry.AABB.of(r)
        assert dataclasses.asdict(o) == dataclasses.asdict(jo)
        assert o.as_array().tolist() == jo.as_array().tolist()
        assert (o.iou(p), o.ioa(p), o.intersection(p), o.area) == \
            (jo.iou(jp), jo.ioa(jp), jo.intersection(jp), jo.area)
        assert geometry.quad_crop_size(q) == j_geometry.quad_crop_size(q)
        assert np.array_equal(geometry.get_perspective_transform(q, r),
                              j_geometry.get_perspective_transform(q, r))
    sizes = tuple(int(v) for v in rng.integers(1, 500, 6))
    t, jt = cfg_runtime.BucketTable(sizes), j_cfg_runtime.BucketTable(sizes)
    assert t.sizes == jt.sizes
    for v in range(0, 520, 7):
        assert (t.bucket(v), t.bucket_index(v)) == (jt.bucket(v),
                                                    jt.bucket_index(v))
    lo, hi = int(rng.integers(1, 9)), int(rng.integers(64, 3000))
    assert cfg_runtime.pow2_buckets(lo, hi) == \
        cfg_runtime.BucketTable(j_cfg_runtime.pow2_buckets(lo, hi).sizes)


def _layout_boxes(mod, seed, n=14):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x0, y0 = rng.uniform(0, 500, 2)
        w, h = rng.uniform(20, 240), rng.uniform(10, 160)
        out.append(mod.LayoutBox(
            ["text", "table", "image", "title"][int(rng.integers(4))],
            float(np.round(rng.uniform(0.1, 1.0), 3)),
            np.array([x0, y0, x0 + w, y0 + h], np.float32),
            order_index=float(i) if i % 3 else None))
    out.append(mod.LayoutBox(out[0].label, out[0].score * 0.5,
                             out[0].box + np.array([3, 2, -4, 1], np.float32)))
    return out


def _same_boxes(a, b):
    assert [(x.label, x.score, x.order_index, x.box.tolist()) for x in a] \
        == [(y.label, y.score, y.order_index, y.box.tolist()) for y in b]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_postprocess_matches(seed):
    from oar_ocr_tpu.processors import layout_postprocess as j_lp
    from oar_ocr_tpu_torch.processors import layout_postprocess as lp

    ours, ref = _layout_boxes(layout, seed), _layout_boxes(j_layout, seed)
    lp.unclip_boxes(ours, 1.1, 0.9, page_w=600.0, page_h=None)
    j_lp.unclip_boxes(ref, 1.1, 0.9, page_w=600.0, page_h=None)
    _same_boxes(ours, ref)
    for kw in ({}, {"merge": False, "iou_thresh": 0.2},
               {"max_detections": 5}):
        _same_boxes(lp.apply_nms_with_merge(ours, **kw),
                    j_lp.apply_nms_with_merge(ref, **kw))
    _same_boxes(lp.remove_overlapping_boxes(ours, ioa_thresh=0.6),
                j_lp.remove_overlapping_boxes(ref, ioa_thresh=0.6))
    quads = _quads(seed, 9)
    assert lp.best_containing_layout_index(quads, ours, min_ioa=0.3) == \
        j_lp.best_containing_layout_index(quads, ref, min_ioa=0.3)
    pairs = np.random.default_rng(seed).integers(0, 4, (len(ours), 2))
    for mode in ("v2", "v3"):
        _same_boxes(lp.sort_by_order_pairs(list(ours), pairs, mode),
                    j_lp.sort_by_order_pairs(list(ref), pairs, mode))
    for mod in (lp, j_lp):
        with pytest.raises(ValueError):
            mod.sort_by_order_pairs(list(ours), pairs, "v4")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_utils_rest_matches(seed):
    rng = np.random.default_rng(seed)
    ocr = rng.uniform(0, 400, (12, 4)).astype(np.float32)
    ocr[:, 2:] = ocr[:, :2] + rng.uniform(5, 80, (12, 2))
    regions = rng.uniform(0, 400, (4, 4)).astype(np.float32)
    regions[:, 2:] = regions[:, :2] + rng.uniform(40, 200, (4, 2))
    for a, b in zip(ocr[:6], regions.tolist() * 2):
        assert layout_utils.calculate_ioa_smaller(tuple(a), tuple(b)) == \
            j_layout_utils.calculate_ioa_smaller(tuple(a), tuple(b))
    for th in (0.0, 3.0, 12.0):
        assert layout_utils.get_overlap_boxes_idx(ocr, regions, th) == \
            j_layout_utils.get_overlap_boxes_idx(ocr, regions, th)
        for within in (True, False):
            assert dataclasses.asdict(layout_utils.associate_ocr_with_layout(
                ocr, regions, within, th)) == dataclasses.asdict(
                j_layout_utils.associate_ocr_with_layout(ocr, regions,
                                                         within, th))
    labels = [["image", "text", "table"][int(v)]
              for v in rng.integers(0, 3, 12)]
    els = [layout_utils.LayoutBox(tuple(b), lab, f"c{i}")
           for i, (b, lab) in enumerate(zip(ocr.tolist(), labels))]
    j_els = [j_layout_utils.LayoutBox(tuple(b), lab, f"c{i}")
             for i, (b, lab) in enumerate(zip(ocr.tolist(), labels))]
    for w in (300.0, 480.0):
        assert [e.content for e in layout_utils.sort_layout_boxes(els, w)] \
            == [e.content for e in j_layout_utils.sort_layout_boxes(j_els, w)]
    for th in (0.3, 0.65):
        assert layout_utils.get_overlap_removal_indices(ocr, labels, th) == \
            j_layout_utils.get_overlap_removal_indices(ocr, labels, th)
        kept, dropped = layout_utils.remove_overlap_blocks(els, th)
        j_kept, j_dropped = j_layout_utils.remove_overlap_blocks(j_els, th)
        assert dropped == j_dropped
        assert [e.content for e in kept] == [e.content for e in j_kept]
    scores = rng.uniform(0, 1, 12).astype(np.float32)
    for target in (0, 4, 12, 20):
        assert np.array_equal(
            layout_utils.reprocess_table_cells_with_ocr(
                ocr[:8], scores[:8], ocr[4:], target),
            j_layout_utils.reprocess_table_cells_with_ocr(
                ocr[:8], scores[:8], ocr[4:], target))
    assert np.array_equal(
        layout_utils.reprocess_table_cells_with_ocr([], [], ocr, 5),
        j_layout_utils.reprocess_table_cells_with_ocr([], [], ocr, 5))


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_matches(seed):
    from oar_ocr_tpu.utils import topk as j_topk
    from oar_ocr_tpu_torch.utils import topk

    rng = np.random.default_rng(seed)
    probs = rng.random((5, 7)).astype(np.float32)
    probs[1, 3] = probs[1, 5]                       # a tie: stable order
    labels = [f"c{i}" for i in range(7)]
    for args in ((probs, 3, labels), (probs, 10, None), (probs[0], 2, None)):
        assert [dataclasses.asdict(r) for r in topk.topk(*args)] == \
            [dataclasses.asdict(r) for r in j_topk.topk(*args)]


def _jax_structure_match_cases():
    import test_structure_match as jt

    return [n for n in dir(jt) if n.startswith("test_")]


@pytest.mark.parametrize("case", _jax_structure_match_cases())
def test_structure_match_cases(case):
    """Each case of ``tests/test_structure_match.py`` run on the port's
    copy (its helpers rebound to the port's structure domain)."""
    import types as pytypes

    import test_structure_match as jt
    from oar_ocr_tpu_torch.utils import structure_match as sm

    g = dict(vars(jt))
    g.update(LayoutElement=structure.LayoutElement,
             LayoutElementType=structure.LayoutElementType,
             StructureResult=structure.StructureResult,
             TableResult=structure.TableResult,
             MatchThresholds=sm.MatchThresholds, match_region=sm.match_region,
             T=structure.LayoutElementType)
    g["TH"] = sm.MatchThresholds(**dataclasses.asdict(jt.TH))

    def rebound(name):
        f = vars(jt)[name]
        return pytypes.FunctionType(f.__code__, g, name, f.__defaults__)

    g.update(_el=rebound("_el"), _res=rebound("_res"))
    rebound(case)()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_structure_match_matches(seed):
    from oar_ocr_tpu.utils import structure_match as j_sm
    from oar_ocr_tpu_torch.utils import structure_match as sm

    res = structure.StructureResult(elements=_layout(structure, seed),
                                    width=600, height=800)
    j_res = j_structure.StructureResult(elements=_layout(j_structure, seed),
                                        width=600, height=800)
    rng = np.random.default_rng(seed + 9)
    for e in list(structure.LayoutElementType)[::3]:
        box = res.elements[int(rng.integers(len(res.elements)))].box + \
            rng.uniform(-20, 20, 4).astype(np.float32)
        for fallback in (False, True):
            th = sm.MatchThresholds(0.4, 0.6, fallback)
            j_th = j_sm.MatchThresholds(0.4, 0.6, fallback)
            a = sm.match_region(res, box, e, th)
            b = j_sm.match_region(j_res, box,
                                  j_structure.LayoutElementType(e.value), j_th)
            assert (a and dataclasses.asdict(a)) == \
                (b and dataclasses.asdict(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_matches(seed):
    """``core/batch``: ``DynamicBatcher`` on every grouping and padding
    strategy, ``AspectRatioBucketing``'s groups and resize-and-pad."""
    from oar_ocr_tpu.core import batch as j_batch
    from oar_ocr_tpu_torch.core import batch

    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 255, (int(rng.integers(8, 140)),
                                  int(rng.integers(8, 300)), 3), np.uint8)
            for _ in range(9)]
    imgs[2] = (imgs[2] > 127).astype(np.uint8) * 255     # binary-ish
    for strat in batch.ShapeCompatibilityStrategy:
        for pad in batch.PaddingStrategy:
            kw = dict(max_batch_size=3)
            if strat.name == "CUSTOM":
                kw["custom_key"] = lambda hw: hw[0] // 50
            a = batch.DynamicBatcher(batch.DynamicBatcherConfig(
                strategy=strat, padding=pad, **kw)).batch(imgs)
            b = j_batch.DynamicBatcher(j_batch.DynamicBatcherConfig(
                strategy=j_batch.ShapeCompatibilityStrategy[strat.name],
                padding=j_batch.PaddingStrategy[pad.name], **kw)).batch(imgs)
            assert [(x.indices, x.target_hw, x.offsets) for x in a] == \
                [(y.indices, y.target_hw, y.offsets) for y in b]
            assert all(np.array_equal(x.images, y.images)
                       for x, y in zip(a, b))
    arb, j_arb = batch.AspectRatioBucketing(), j_batch.AspectRatioBucketing()
    shapes = [im.shape[:2] for im in imgs]
    assert arb.group(shapes) == j_arb.group(shapes)
    for im in imgs[:4]:
        assert np.array_equal(arb.resize_and_pad(im),
                              j_arb.resize_and_pad(im))


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_processors_match(seed):
    from oar_ocr_tpu.pipelines import processors as j_proc
    from oar_ocr_tpu_torch.pipelines import processors as proc

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (340, 360, 3), np.uint8)
    quads = _quads(seed, 5)
    quads.append(np.array([[20, 10], [30, 10], [30, 90], [20, 90]],
                          np.float32))                   # tall: rotated
    a = proc.TextCroppingProcessor().process(img, quads)
    b = j_proc.TextCroppingProcessor().process(img, quads)
    assert [x.shape for x in a] == [y.shape for y in b]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for ang in (0, 90, 270, -90):
        assert np.array_equal(proc.ImageRotationProcessor(ang).process(img),
                              j_proc.ImageRotationProcessor(ang).process(img))
    with pytest.raises(ValueError):
        proc.ImageRotationProcessor(45)
    chain = proc.ChainProcessor(proc.ImageRotationProcessor(90).process,
                                lambda x: x[::2])
    j_chain = j_proc.ChainProcessor(
        j_proc.ImageRotationProcessor(90).process, lambda x: x[::2])
    assert np.array_equal(chain.process(img), j_chain.process(img))


@pytest.mark.parametrize("seed", [0, 1])
def test_visualization_matches(seed, tmp_path):
    """Pixel-equal images from both packages' drawing functions."""
    from oar_ocr_tpu.utils import visualization as j_vis
    from oar_ocr_tpu_torch.utils import visualization as vis

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (360, 420, 3), np.uint8)
    quads = _quads(seed, 5)
    scores = [float(s) for s in rng.uniform(0, 1, 5)]
    texts = ["alpha", "", "中文", "x" * 80, "end"]
    dets = [vis.Detection(q, s, t or None) for q, s, t in
            zip(quads, scores, texts)] + [vis.Detection(
                np.array([5, 6, 50, 40], np.float32))]
    j_dets = [j_vis.Detection(d.box, d.score, d.label) for d in dets]
    for kw in ({}, {"draw_corners": False, "thickness": 1},
               {"draw_polygon": False, "font_scale": 0.8}):
        assert np.array_equal(
            vis.draw_detections(img, dets, vis.DetectionVisConfig(**kw)),
            j_vis.draw_detections(img, j_dets,
                                  j_vis.DetectionVisConfig(**kw)))
    for sc in (None, scores):
        assert np.array_equal(vis.draw_ocr_canvas(img, quads, texts, sc),
                              j_vis.draw_ocr_canvas(img, quads, texts, sc))
    res = structure.StructureResult(elements=_layout(structure, seed),
                                    width=600, height=800)
    j_res = j_structure.StructureResult(elements=_layout(j_structure, seed),
                                        width=600, height=800)
    page = np.full((800, 600, 3), 250, np.uint8)
    assert np.array_equal(vis.draw_structure(page, res),
                          j_vis.draw_structure(page, j_res))
    boxes = _layout_boxes(layout, seed)
    for order in (True, False):
        assert np.array_equal(
            vis.draw_layout(page, boxes, show_order=order),
            j_vis.draw_layout(page, _layout_boxes(j_layout, seed),
                              show_order=order))
    vis.save_image(str(tmp_path / "a.png"), img)
    j_vis.save_image(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    for mod in (vis, j_vis):
        with pytest.raises(IOError):
            mod.save_image(str(tmp_path / "no" / "x.png"), img)


_OTSL = ["<fcel>a<fcel>b<nl><fcel>c<lcel><nl>",
         "<ched>h1<ched>h2<nl><fcel>1<ecel><nl><ucel><fcel>x & y<nl>",
         "<table><tr><td>a</td><td>b</td></tr></table>",
         "plain\ttext\nrows", "<fcel>a<xcel><nl><fcel><nl>", ""]


@pytest.mark.parametrize("text", _OTSL)
def test_otsl_matches(text):
    """OTSL → HTML, the table task's postprocess and the inverse, on both
    packages."""
    from oar_ocr_tpu.vl import otsl as j_otsl
    from oar_ocr_tpu.vl.paddleocr_vl import postprocess_task_output as j_pp
    from oar_ocr_tpu_torch.vl import otsl
    from oar_ocr_tpu_torch.vl.paddleocr_vl import postprocess_task_output

    assert otsl.convert_otsl_to_html(text) == \
        j_otsl.convert_otsl_to_html(text)
    assert otsl.otsl_to_html(text) == j_otsl.otsl_to_html(text)
    assert otsl.looks_like_table_tokens(text) == \
        j_otsl.looks_like_table_tokens(text)
    for task in ("table", "formula", "ocr"):
        assert postprocess_task_output(text, task) == j_pp(text, task)
    html = j_otsl.convert_otsl_to_html(text)
    assert otsl.convert_html_to_otsl(html) == \
        j_otsl.convert_html_to_otsl(html)


_TEXTS = ["$ x $ and $$ y $$ price $100", "\\[x^2\\]\n\\upmu <|sn|>a",
          "a ,  b .  c____ ....... d", "ab" * 40 + "\nline\n" * 12,
          "<table><tr>\n <td>1</td></tr></table>", "  \\big{(}x\\big{)} "]


def _elements(mod, seed):
    """Seeded layout elements of every type, some with tables, LaTeX,
    raw labels and empty text, in the given package's classes."""
    rng = np.random.default_rng(seed)
    out = []
    for i, t in enumerate(mod.LayoutElementType):
        if rng.random() < 0.3:
            continue
        box = np.array(sorted(rng.uniform(0, 300, 2)) * 2, np.float32)
        text = _TEXTS[int(rng.integers(len(_TEXTS)))] if i % 5 else ""
        e = mod.LayoutElement(element_type=t, box=box,
                              score=float(rng.random()), text=text)
        e.label = t.value
        if t.value == "table":
            e.table = mod.TableResult(html=_TEXTS[4])
        if "formula" in t.value:
            e.formula_latex = _TEXTS[1]
        out.append(e)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_format_matches(seed):
    """``vl/text_format.py``: the normalizers on seeded strings, and
    both markdown exporters on seeded elements of every type."""
    from oar_ocr_tpu.vl import text_format as j_tf
    from oar_ocr_tpu_torch.vl import text_format as tf

    for text in _TEXTS:
        for fn in ("clean_special_tokens", "process_text",
                   "fix_latex_brackets", "format_formula", "format_table",
                   "format_text", "collapse_consecutive_spaces",
                   "tighten_inline_dollar_math",
                   "remove_space_before_punctuation"):
            assert getattr(tf, fn)(text) == getattr(j_tf, fn)(text), fn
        assert tf.truncate_repetitive_content(text, 10, 10, 10) == \
            j_tf.truncate_repetitive_content(text, 10, 10, 10)
    ours, ref = _elements(structure, seed), _elements(j_structure, seed)
    assert tf.to_markdown(ours) == j_tf.to_markdown(ref)
    assert tf.to_markdown(ours, ()) == j_tf.to_markdown(ref, ())
    for pretty in (True, False):
        assert tf.to_markdown_openocr(ours, pretty=pretty) == \
            j_tf.to_markdown_openocr(ref, pretty=pretty)
    assert tf.DEFAULT_MARKDOWN_IGNORE_LABELS == \
        j_tf.DEFAULT_MARKDOWN_IGNORE_LABELS


@pytest.mark.parametrize("seed", [0, 1])
def test_convert_maps_matches(seed):
    """``runtime/convert_maps.py``: the generic renamer's rules, the
    deploy export and the round trip on a seeded parameter tree."""
    from oar_ocr_tpu.runtime import convert_maps as j_cm
    from oar_ocr_tpu_torch.runtime import convert_maps as cm

    rng = np.random.default_rng(seed)
    tree = {"params": {
        "PPLCNetV3_0": {
            "ConvBNAct_0": {"Conv_0": {"kernel": rng.standard_normal(
                (3, 3, 2, 4)).astype(np.float32)}},
            "BatchNorm_0": {"scale": np.ones(4, np.float32),
                            "bias": rng.standard_normal(4).astype(
                                np.float32)}},
        "Dense_0": {"kernel": rng.standard_normal((4, 5)).astype(
            np.float32), "bias": np.zeros(5, np.float32)},
        "Embed_0": {"embedding": rng.standard_normal((6, 4)).astype(
            np.float32)}}}
    ours, ref = cm.build_model_map(tree, name="m"), \
        j_cm.build_model_map(tree, name="m")
    assert [r[:2] for r in ours.rules] == [r[:2] for r in ref.rules]
    a, b = cm.export_deploy_format(tree), j_cm.export_deploy_format(tree)
    assert set(a) == set(b)
    assert all(np.array_equal(a[k], np.asarray(b[k])) for k in a)
    back = ours.convert(a)
    flat = cm.flatten_params(tree)
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    assert cm.roundtrip_check(tree, name="m") is True
    assert j_cm.roundtrip_check(tree, name="m") is True

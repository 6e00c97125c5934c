"""Shared pieces of the table tests (``test_torch_table_pipeline.py``,
``test_torch_table_wireless.py``, ``test_torch_table_structure.py``):
the drawn pages, the small models' perturbed weights, the JAX/port pairs
of the structure models and of the ``TableAnalyzer``, and the analyzer
tests' run and gates. See ``test_torch_table_pipeline.py`` for the
sizes and why the weights are biased."""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.models.classification.pp_lcnet import \
    ImageClassifier as JClassifier
from oar_ocr_tpu.models.classification.pp_lcnet_exact import PPLCNetV1Cls
from oar_ocr_tpu.models.detection.layout import LayoutDetector as JLayout
from oar_ocr_tpu.models.recognition.slanet import SLANet as JSLANet
from oar_ocr_tpu.models.recognition.slanet import \
    SLANetModel as JSLANetModel
from oar_ocr_tpu.models.recognition.slanet_exact import \
    SLANetExact as JSLANetExact
from oar_ocr_tpu.models.recognition.slanet_exact import \
    SLANetExactModel as JSLANetExactModel
from oar_ocr_tpu.models.recognition.slanext_exact import \
    SLANeXtExact as JSLANeXt
from oar_ocr_tpu.models.recognition.slanext_exact import \
    SLANeXtExactModel as JSLANeXtModel
from oar_ocr_tpu.pipelines.table_analyzer import \
    TableAnalyzer as JTableAnalyzer
from oar_ocr_tpu.pipelines.table_analyzer import \
    TableRegionInput as JTableRegionInput
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import flatten_params, unflatten_params
from oar_ocr_tpu_torch.models.classification.pp_lcnet import ImageClassifier
from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
from oar_ocr_tpu_torch.models.recognition.slanet import SLANetModel
from oar_ocr_tpu_torch.models.recognition.slanet_exact import \
    SLANetExactModel
from oar_ocr_tpu_torch.models.recognition.slanext_exact import \
    SLANeXtExactModel
from oar_ocr_tpu_torch.pipelines.table_analyzer import (TableAnalyzer,
                                                        TableRegionInput)
from oar_ocr_tpu_torch.runtime.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
BENCH_DET = REPO / "assets" / "bench_det.safetensors"
CELL_VARIANT = "rt-detr-l_wired_table_cell_det"
RT_KW = dict(arch="T", hidden_dim=64, num_queries=32, num_decoder_layers=2,
             nhead=8, dim_feedforward=128)
NEXT_KW = dict(dim=64, depth=2, heads=2, window=4, global_idx=(1,),
               pos_grid=8, out_chans=32, net2_out=48, hidden_size=32)
TR_ID, TD_ID = 6, 8  # '<tr>', '<td></td>' in TABLE_STRUCTURE_VOCAB
# the two tables of each page: (x0, y0, rows, cols, ruled)
TABLES = ((30, 30, 4, 3, True), (250, 150, 3, 4, False))
CELL_W, CELL_H = 50, 28


def perturbed(flat, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.random(np.shape(v)) * 0.5 + 0.75).astype(np.float32)
            if k.endswith("/var") else
            (np.asarray(v, np.float32) + rng.normal(0, scale, np.shape(v))
             ).astype(np.float32) for k, v in sorted(flat.items())}


def biased(flat, key, index, value):
    out = dict(flat)
    out[key] = out[key].copy()
    out[key][index] += value
    return out


def table_boxes():
    return [(float(x0), float(y0), float(x0 + cols * CELL_W),
             float(y0 + rows * CELL_H)) for x0, y0, rows, cols, _ in TABLES]


def pages():
    """Two 320×480 pages, each with a ruled and an unruled table."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(2):
        img = np.full((320, 480, 3), 255, np.uint8)
        for x0, y0, rows, cols, ruled in TABLES:
            for r in range(rows):
                for c in range(cols):
                    cx, cy = x0 + c * CELL_W, y0 + r * CELL_H
                    w = int(rng.integers(14, CELL_W - 10))
                    cv2.rectangle(img, (cx + 5, cy + 8), (cx + 5 + w, cy + 19),
                                  (int(rng.integers(0, 60)),) * 3, -1)
            if ruled:
                for r in range(rows + 1):
                    cv2.line(img, (x0, y0 + r * CELL_H),
                             (x0 + cols * CELL_W, y0 + r * CELL_H), (0, 0, 0))
                for c in range(cols + 1):
                    cv2.line(img, (x0 + c * CELL_W, y0),
                             (x0 + c * CELL_W, y0 + rows * CELL_H), (0, 0, 0))
        out.append(img)
    return out


def ocr_inputs(page):
    """One OCR box per text block of the page's tables, and one spanning
    two cells."""
    boxes, texts = [], []
    for x0, y0, rows, cols, _ in TABLES:
        for r in range(rows):
            for c in range(cols):
                cx, cy = x0 + c * CELL_W, y0 + r * CELL_H
                boxes.append(np.array([[cx + 4, cy + 7], [cx + 40, cy + 7],
                                       [cx + 40, cy + 20], [cx + 4, cy + 20]],
                                      np.float32))
                texts.append(f"r{r}c{c}p{page}")
    x0, y0 = TABLES[0][:2]
    boxes.append(np.array([[x0 + 6, y0 + 36], [x0 + 90, y0 + 36],
                           [x0 + 90, y0 + 48], [x0 + 6, y0 + 48]],
                          np.float32))
    texts.append("spanning two")
    return boxes, texts


def make_flats(structures=("slanet", "slanet_plus", "slanext")):
    """Perturbed flat parameters of the table models: the classifier
    biased to each route, the cell detector, and the structure models
    named by ``structures`` with their cell tokens biased."""
    def make(module, shape, seed, scale=0.1):
        return perturbed(flatten_params(init_params_fast(module, shape)),
                         seed, scale)
    cls = make(PPLCNetV1Cls(class_num=2, scale=0.25), (1, 224, 224, 3), 51)
    det = make(JLayout(CELL_VARIANT, runtime=JRuntime(JRuntimeConfig(
        compute_dtype="float32", use_mesh=False)),
        net_overrides=RT_KW).model, (1, 640, 640, 3), 52, 0.05)
    models = {
        "slanet": lambda: biased(biased(
            make(JSLANet(backbone_scale=0.25, max_steps=10), (1, 96, 96, 3),
                 53), "params/SLAHead_0/cell/out_struct/bias", TD_ID, 1.0),
            "params/SLAHead_0/cell/out_struct/bias", TR_ID, 1.5),
        "slanet_plus": lambda: biased(
            make(JSLANetExact(scale=0.25, max_text_length=8),
                 (1, 96, 96, 3), 54),
            "params/head/structure_generator.1/bias", TD_ID, 2.0),
        "slanext": lambda: biased(
            make(JSLANeXt(max_text_length=8, **NEXT_KW), (1, 128, 128, 3),
                 55), "params/head/structure_generator.1/bias", TD_ID, 1.0),
    }
    return {"wired_cls": biased(cls, "params/fc/bias", 0, 8.0),
            "wireless_cls": biased(cls, "params/fc/bias", 1, 8.0),
            "det": det, **{k: models[k]() for k in structures}}


def structure_pair(kind, flat, jrt, cpu):
    """(JAX wrapper with its small network swapped in, port wrapper)."""
    params = unflatten_params(flat)
    if kind == "slanet":
        j = JSLANetModel(params, max_steps=10, runtime=jrt)
        j.model = JSLANet(backbone_scale=0.25, max_steps=10)
        return j, SLANetModel(params_from_jax(flat), runtime=cpu,
                              backbone_scale=0.25, max_steps=10)
    if kind == "slanet_plus":
        j = JSLANetExactModel(params, max_text_length=8, runtime=jrt)
        j.model = JSLANetExact(scale=0.25, max_text_length=8)
        j._fwd = jax.jit(j.model.apply)
        t = SLANetExactModel(params_from_jax(flat), runtime=cpu, scale=0.25,
                             max_text_length=8)
    else:
        j = JSLANeXtModel(params, input_size=128, max_text_length=8,
                          runtime=jrt, **NEXT_KW)
        t = SLANeXtExactModel(params_from_jax(flat), input_size=128,
                              runtime=cpu, max_text_length=8, **NEXT_KW)
    j.INPUT = t.INPUT = 128
    return j, t


def detector_pair(flats, jrt, cpu):
    """(JAX, port) wired cell detectors on ``flats["det"]``."""
    return (JLayout(CELL_VARIANT, unflatten_params(flats["det"]),
                    score_thresh=0.3, runtime=jrt, net_overrides=RT_KW),
            LayoutDetector(CELL_VARIANT, params_from_jax(flats["det"]),
                           score_thresh=0.3, runtime=cpu,
                           net_overrides=RT_KW))


def analyzer_pair(flats, jrt, cpu, *, route, structure, detectors=None,
                  **kw):
    """(JAX, port) ``TableAnalyzer``s; ``detectors`` (a
    :func:`detector_pair`) shares one pair of cell detectors, and so the
    JAX one's compiled step, between tests."""
    cls_flat = flats[f"{route}_cls"]
    j_st, t_st = structure_pair(structure, flats[structure], jrt, cpu)
    j_cls = JClassifier(unflatten_params(cls_flat), num_classes=2,
                        scale=0.25, runtime=jrt, name="table_cls")
    t_cls = ImageClassifier(params_from_jax(cls_flat), num_classes=2,
                            scale=0.25, runtime=cpu, name="table_cls")
    j_det, t_det = detectors or detector_pair(flats, jrt, cpu)
    j = JTableAnalyzer(classifier=j_cls, structure=j_st, cell_detector=j_det,
                       runtime=jrt, **kw)
    t = TableAnalyzer(classifier=t_cls, structure=t_st, cell_detector=t_det,
                      runtime=cpu, **kw)
    return j, t


def assert_same_tables(got, ref, wired):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.html, g.structure_tokens, g.cell_texts, g.is_wired,
                g.is_e2e) == (r.html, r.structure_tokens, r.cell_texts,
                              r.is_wired, r.is_e2e)
        assert g.is_wired is wired and g.is_e2e is not wired
        np.testing.assert_allclose(np.asarray(g.cell_boxes, np.float32),
                                   np.asarray(r.cell_boxes, np.float32),
                                   atol=1e-3, rtol=0)
        assert abs(g.structure_score - r.structure_score) <= 1e-5
        assert [(c.row, c.col, c.text) for c in g.cells] == \
            [(c.row, c.col, c.text) for c in r.cells]
    assert any("<td" in g.html for g in got)
    assert any(t for g in got for t in g.cell_texts)


def analyze(j, t, with_ocr=True):
    imgs = pages()
    j_in, t_in = [], []
    for p in range(len(imgs)):
        boxes, texts = ocr_inputs(p) if with_ocr else ((), ())
        for box in table_boxes():
            j_in.append(JTableRegionInput(p, box, boxes, texts))
            t_in.append(TableRegionInput(p, box, boxes, texts))
    ref = j.analyze_tables(jnp.asarray(np.stack(imgs)), j_in)
    got = t.analyze_tables(torch.from_numpy(np.stack(imgs)), t_in)
    return got, ref

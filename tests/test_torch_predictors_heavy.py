"""The text and seal detection predictors against the JAX predictors
on the trained bench detector (the same boxes within 1e-3 px, scores
within 1e-5, both packages' DB postprocess on one path:
``torch_jax_tree.one_db_path``; the seal predictor's polygon path
compiles slowly in JAX, so they live here, not in
``test_torch_predictors.py``); the port's task
predictors whose models are large, each against the port's own model
wrapper that it calls, on the CPU in float32; and the predictor table.

A JAX init of RT-DETR-L or UniMERNet on the CPU would take minutes, and
earlier test files already hold these wrappers to the JAX package
(``test_torch_layout.py``, ``test_torch_tables.py``,
``test_torch_formula.py``, ``test_torch_formulanet.py``,
``test_torch_classify_rectify.py``). So each predictor here runs on its
seeded default weights next to the wrapper built the same way, on the
same images uploaded as the predictor uploads them (one batch padded to
the det side buckets), at the smallest variant or input the wrapper
takes: the outputs must be identical. UniMERNet runs its tiny config
(``UniMERNetConfig().tiny()`` with 256 positions, patched in as the
predictor's default); the default formula recognizer runs the task
config's 256 steps; the table-structure predictor forwards
``max_steps``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.predictors import predictors as jpred
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.weights import load_params as jload_params
from oar_ocr_tpu.tasks import tasks as jtasks
from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
from oar_ocr_tpu_torch.models.recognition import unimernet
from oar_ocr_tpu_torch.models.recognition.formula import FormulaRecognizer
from oar_ocr_tpu_torch.models.recognition.slanet import SLANetModel
from oar_ocr_tpu_torch.models.rectification.uvdoc import UVDocRectifier
from oar_ocr_tpu_torch.predictors import predictors as pred
from oar_ocr_tpu_torch.runtime.runtime import DET_SIDE_BUCKETS, Runtime
from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint
from oar_ocr_tpu_torch.tasks import tasks
from oar_ocr_tpu_torch.tasks.tasks import TaskType
from torch_jax_tree import one_db_path, one_torch_thread  # noqa: F401

CPU = Runtime("float32", device="cpu")
BENCH_DET = str(Path(__file__).resolve().parents[1] / "assets" /
                "bench_det.safetensors")


def jrt():
    return JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))


def _pages():
    """Two pages of dark blocks, of different sizes (one upload pads both
    to the det side buckets)."""
    rng = np.random.default_rng(5)
    out = []
    for h, w in ((320, 480), (280, 400)):
        img = np.full((h, w, 3), 255, np.uint8)
        for r in range(3):
            y = 30 + r * 80
            img[y:y + int(rng.integers(20, 34)),
                30:30 + int(rng.integers(120, w - 60))] = rng.integers(0, 70)
        out.append(img)
    return out


@pytest.mark.parametrize("kind", ["text", "seal"])
def test_detection_predictors_match_jax(kind, one_db_path):
    ours_cls, ref_cls, cfg_cls = {
        "text": (pred.TextDetectionPredictor, jpred.TextDetectionPredictor,
                 (tasks.TextDetectionConfig, jtasks.TextDetectionConfig)),
        "seal": (pred.SealTextDetectionPredictor,
                 jpred.SealTextDetectionPredictor,
                 (tasks.SealTextDetectionConfig,
                  jtasks.SealTextDetectionConfig))}[kind]
    # the JAX seal path compiles per polygon batch: one page keeps it short
    pages = _pages() if kind == "text" else _pages()[1:]
    ours = ours_cls(cfg_cls[0](), load_jax_checkpoint(BENCH_DET),
                    runtime=CPU).predict(pages)
    ref = ref_cls(cfg_cls[1](), jload_params(BENCH_DET),
                  runtime=jrt()).predict(pages)
    assert sum(len(b) for b, _ in ref) >= 3, "vacuous reference"
    for (ob, os_), (rb, rs) in zip(ours, ref):
        assert len(ob) == len(rb)
        for a, b in zip(ob, rb):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-3
        assert np.allclose(os_, rs, atol=1e-5)


def _images(sizes=((150, 210), (120, 260)), seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        img = np.full((h, w, 3), 245, np.uint8)
        for r in range(3):
            y = 10 + r * (h // 3)
            img[y:y + 12, 8:8 + int(rng.integers(w // 3, w - 16))] = \
                rng.integers(0, 90)
        out.append(img)
    return out


def _upload(images):
    shapes = [im.shape[:2] for im in images]
    hw = (DET_SIDE_BUCKETS.bucket(max(s[0] for s in shapes)),
          DET_SIDE_BUCKETS.bucket(max(s[1] for s in shapes)))
    return CPU.put_pages(images, hw), shapes


def _same_boxes(got, want):
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a.label, a.score) == (b.label, b.score)
            assert np.array_equal(a.box, b.box)


@pytest.mark.parametrize("kind", ["layout", "table_cell"])
def test_layout_predictors_match_wrapper(kind):
    images = _images()
    if kind == "layout":
        cfg = tasks.LayoutDetectionConfig(variant="pp-doclayout-s")
        p = pred.LayoutDetectionPredictor(cfg, runtime=CPU)
        det = LayoutDetector("pp-doclayout-s", score_thresh=0.5,
                             nms_iou=0.6, runtime=CPU)
    else:
        images = images[:1]
        p = pred.TableCellDetectionPredictor(runtime=CPU)
        assert p.config.variant == "rt-detr-l_wired_table_cell_det"
        det = LayoutDetector("rt-detr-l_wired_table_cell_det",
                             score_thresh=0.3, runtime=CPU)
    _same_boxes(p.predict(images), det.detect(*_upload(images)))


def test_table_structure_predictor_matches_wrapper():
    images = _images()
    p = pred.TableStructureRecognitionPredictor(
        tasks.TableStructureConfig(max_steps=24), runtime=CPU)
    assert p._model.model.head.steps == 24
    model = SLANetModel(max_steps=24, runtime=CPU)
    pages, shapes = _upload(images)
    want = model.recognize(pages, [(i, (0, 0, s[1], s[0]))
                                   for i, s in enumerate(shapes)])
    got = p.predict(images)
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert all(np.array_equal(g.cell_boxes, w.cell_boxes)
               for g, w in zip(got, want))
    assert all(1 <= len(g.tokens) <= 24 for g in got)


def test_formula_predictor_matches_wrapper():
    """The task config's default ``max_len`` is 256 (the structure
    builder's recognizer runs 64): the predictor's decode runs 256
    steps and gives the wrapper's ids."""
    images = _images(((40, 160), (36, 120)), seed=4)
    p = pred.FormulaRecognitionPredictor(runtime=CPU)
    assert p.config.max_len == 256
    got = p.predict(images)
    assert p._model.graphs.last["steps"] == 256
    want = FormulaRecognizer(max_len=256, runtime=CPU).recognize(images)
    assert [g.latex for g in got] == [w.latex for w in want]
    assert all(g.latex for g in got)


def test_unimernet_predictor_matches_wrapper(monkeypatch):
    # the predictor decodes up to 96 tokens: positions for 256
    tiny = dataclasses.replace(unimernet.UniMERNetConfig().tiny(),
                               max_positions=256)
    monkeypatch.setattr(unimernet, "UniMERNetConfig", lambda: tiny)
    images = _images(((30, 90), (44, 70)), seed=6)
    p = pred.FormulaRecognitionPredictor(
        tasks.FormulaRecognitionConfig(model_type="unimernet"), runtime=CPU)
    assert isinstance(p._model, unimernet.UniMERNetRecognizer)
    want = unimernet.UniMERNetRecognizer(cfg=tiny, runtime=CPU).recognize(
        images)
    assert p.predict(images) == want


def test_rectification_predictor_matches_wrapper():
    images = _images(((96, 80), (70, 110)), seed=8)
    got = pred.DocumentRectificationPredictor(runtime=CPU).predict(images)
    rect = UVDocRectifier(runtime=CPU)
    for g, im in zip(got, images):
        assert g.shape == im.shape and g.dtype == np.uint8
        assert np.array_equal(g, rect.rectify(im))


def test_all_predictors_cover_every_task():
    assert set(pred.ALL_PREDICTORS) == set(TaskType)
    assert len(pred.ALL_PREDICTORS) == 11
    for task, cls in pred.ALL_PREDICTORS.items():
        assert cls.task is task
        assert tasks.TASK_REGISTRY[task].task_type is task

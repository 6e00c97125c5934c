"""The port's task predictors whose models are small, against the JAX
predictors with the same weights, on the CPU in float32; and the
predictors' config and input validation.

(The text and seal detection predictors are held to JAX in
``test_torch_predictors_heavy.py``.) Weights: the recognizer fitted to
drawn lines (``assets/fitted_rec.safetensors``) on
lines of phase 6's drawn page (``assets/text_page_23.png``); the three
PP-LCNet classifiers seeded and calibrated (``utils/calibrate``) on the
test images, carried into the JAX trees by
``torch_jax_tree.jax_tree_from_port``. Gates: identical texts and
confidences within 1e-5 (recognition, with and without
``score_thresh``); the same classes and scores within 1e-5 (the
classifiers, whose last layer is scaled by 0.05 so that their
probabilities do not saturate).
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.models.classification.pp_lcnet_exact import \
    PPLCNetV1Cls as JPPLCNetV1Cls
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer as JSVTR
from oar_ocr_tpu.predictors import predictors as jpred
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.tasks import tasks as jtasks
from oar_ocr_tpu_torch.errors import ConfigError, InvalidInputError
from oar_ocr_tpu_torch.models.classification.pp_lcnet_exact import \
    PPLCNetV1Cls
from oar_ocr_tpu_torch.predictors import predictors as pred
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import read_safetensors
from oar_ocr_tpu_torch.tasks import tasks
from oar_ocr_tpu_torch.utils.calibrate import calibrated_state_dict
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa: F401

ASSETS = Path(__file__).resolve().parents[1] / "assets"
CPU = Runtime("float32", device="cpu")


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


@pytest.fixture(scope="module")
def lines():
    page = np.ascontiguousarray(cv2.imread(
        str(ASSETS / "text_page_23.png"))[:, :, ::-1])
    boxes = json.loads((ASSETS / "text_page_23.json").read_text())["boxes"]
    return [page[y0:y1, x0:x1].copy() for x0, y0, x1, y1 in boxes[:6]]


@pytest.mark.parametrize("score_thresh", [0.0, 0.97])
def test_text_recognition_predictor_matches_jax(lines, score_thresh):
    sd = {k: torch.from_numpy(v) for k, v in read_safetensors(
        str(ASSETS / "fitted_rec.safetensors")).items()}
    tree = jax_tree_from_port(JSVTR(vocab_size=96), (1, 48, 64, 3), sd)
    ours = pred.TextRecognitionPredictor(
        tasks.TextRecognitionConfig(score_thresh=score_thresh), sd,
        runtime=CPU).predict(lines)
    ref = jpred.TextRecognitionPredictor(
        jtasks.TextRecognitionConfig(score_thresh=score_thresh), tree,
        runtime=jrt()).predict(lines)
    assert [t for t, _ in ours] == [t for t, _ in ref]
    assert np.allclose([c for _, c in ours], [c for _, c in ref], atol=1e-5)
    texts = [t for t, _ in ours]
    assert sum(1 for t in texts if t) >= (3 if score_thresh else 5)
    if score_thresh:
        assert any(not t for t in texts), "score_thresh cut nothing"


CLASSIFIERS = {
    "doc_ori": (pred.DocumentOrientationPredictor,
                jpred.DocumentOrientationPredictor, 4, 1.0, (224, 224)),
    "line_ori": (pred.TextLineOrientationPredictor,
                 jpred.TextLineOrientationPredictor, 2, 0.25, (80, 160)),
    "table_cls": (pred.TableClassificationPredictor,
                  jpred.TableClassificationPredictor, 2, 1.0, (224, 224)),
}


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_classifier_predictors_match_jax(name):
    ours_cls, ref_cls, n, scale, (h, w) = CLASSIFIERS[name]
    images = [p[20:260, 10:380] for p in _pages()]
    x = torch.from_numpy(np.stack([cv2.resize(im, (w, h)) for im in images]
                                  )).float() / 127.5 - 1.0
    sd = calibrated_state_dict(PPLCNetV1Cls(n, scale),
                               torch.Generator().manual_seed(3), x)
    for k in ("fc.weight", "fc.bias"):      # unsaturated probabilities
        sd[k] = sd[k] * 0.05
    tree = jax_tree_from_port(JPPLCNetV1Cls(class_num=n, scale=scale),
                              (1, h, w, 3), sd)
    ours = ours_cls(tasks.ClassificationConfig(), sd,
                    runtime=CPU).predict(images)
    ref = ref_cls(jtasks.ClassificationConfig(), tree,
                  runtime=jrt()).predict(images)
    assert [c for c, _ in ours] == [c for c, _ in ref]
    assert np.allclose([s for _, s in ours], [s for _, s in ref], atol=1e-5)
    assert max(s for _, s in ours) < 0.999, "saturated: vacuous"


@pytest.mark.parametrize("bad", [
    "not a list", [np.zeros((8, 8), np.uint8)],
    [np.zeros((8, 8, 3), np.float32)], [np.zeros((0, 8, 3), np.uint8)]])
def test_predictors_validate_inputs(bad):
    p = pred.TextDetectionPredictor(runtime=CPU)
    with pytest.raises(InvalidInputError):
        p.predict(bad)


@pytest.mark.parametrize("make", [
    lambda: pred.TextDetectionPredictor(
        tasks.TextDetectionConfig(thresh=1.5), runtime=CPU),
    lambda: pred.TextRecognitionPredictor(
        tasks.TextRecognitionConfig(charset_path="/nonexistent/dict.txt"),
        runtime=CPU),
    lambda: pred.LayoutDetectionPredictor(
        tasks.LayoutDetectionConfig(variant="no-such-variant"), runtime=CPU),
    lambda: pred.FormulaRecognitionPredictor(
        tasks.FormulaRecognitionConfig(model_type="latex-ocr"), runtime=CPU),
    lambda: pred.TableStructureRecognitionPredictor(
        tasks.TableStructureConfig(max_steps=0), runtime=CPU),
    lambda: pred.TextDetectionPredictor()])
def test_predictors_refuse_bad_configs(make):
    """A config outside its ``RULES`` raises ``ConfigError`` when the
    predictor is built, before any model is; without a CUDA card the
    default Runtime raises ``ConfigError`` too (the card is the
    default, no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("the default Runtime is the visible card")
    with pytest.raises(ConfigError):
        make()

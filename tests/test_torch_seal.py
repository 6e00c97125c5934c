"""The port's POLY (seal) detection and slow box scoring against the JAX
package on the CPU: ``OAROCRBuilder("seal")``, ``BoxType.POLY`` under the
general preset, ``ScoreMode.SLOW`` for quads and polygons, and
``ops/det_device.poly_scores`` against the JAX op and the host
``box_score``.

Both pipelines run in float32 with the trained
``assets/bench_det.safetensors`` detector and one perturbed random
recognizer carried over by ``params_from_jax``. Gates: the same boxes per
page in the same order, each within 1e-3 px, identical texts, scores
within 1e-5; device polygon scores within 1e-5 of the JAX op's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.core.types import BoxType as JBoxType
from oar_ocr_tpu.core.types import ScoreMode as JScoreMode
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer
from oar_ocr_tpu.ops import det_device as jdet
from oar_ocr_tpu.ops.ctc import default_charset
from oar_ocr_tpu.pipelines.ocr import OAROCRBuilder as JBuilder
from oar_ocr_tpu.processors.db_postprocess import \
    DBPostProcess as JDBPostProcess
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import (flatten_params, load_params,
                                         unflatten_params)
from oar_ocr_tpu_torch.core.types import BoxType, ScoreMode
from oar_ocr_tpu_torch.ops import det_device
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.processors.db_postprocess import box_score
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax, read_safetensors

from pathlib import Path

BENCH_DET = Path(__file__).resolve().parents[1] / "assets" / \
    "bench_det.safetensors"


def _pages():
    """Two pages of dark text rows and one ring of text around a disc, a
    seal's shape; the second page has a slanted row."""
    import cv2

    rng = np.random.default_rng(17)
    pages = []
    for p in range(2):
        img = np.full((320, 480, 3), 255, np.uint8)
        for r in range(3):
            y = 30 + r * 60
            img[y:y + 24, 40:40 + (300, 200, 340)[(r + p) % 3]] = \
                rng.integers(0, 80)
        cv2.ellipse(img, (360, 250), (80, 50), 0, 200, 340,
                    (20, 20, 20), 16)
        if p == 1:
            pts = np.array([[40, 250], [260, 200], [264, 224], [44, 274]],
                           np.int32)
            cv2.fillPoly(img, [pts], (30, 30, 30))
        pages.append(img)
    return pages


@pytest.fixture(scope="module")
def weights():
    vocab = 2 + len(default_charset())
    flat = flatten_params(init_params_fast(SVTRRecognizer(vocab_size=vocab),
                                           (1, 48, 64, 3)))
    rng = np.random.default_rng(61)
    flat = {k: (np.asarray(v, np.float32) + rng.normal(0, 0.05, np.shape(v))
                ).astype(np.float32) if not k.endswith("/var") else
            (rng.random(np.shape(v)) * 0.5 + 0.75).astype(np.float32)
            for k, v in sorted(flat.items())}
    det_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            load_params(str(BENCH_DET)))
    return det_tree, flat


@pytest.fixture(scope="module")
def jax_pipe(weights):
    """One JAX pipeline for every case: each case sets its detector's
    post-processing and resize configs from ``JBuilder(text_type)``, so
    its compiled programs are reused (the jit is per detector)."""
    det_tree, rec_flat = weights
    return (JBuilder("general")
            .with_runtime(JRuntime(JRuntimeConfig(compute_dtype="float32",
                                                  use_mesh=False)))
            .with_det_params(det_tree)
            .with_rec_params(unflatten_params(rec_flat))
            .with_batch_sizes(image=2, region=64).build())


def _run(weights, jax_pipe, text_type, **det_cfg):
    _, rec_flat = weights
    jcfg = {k: (JBoxType(v.value) if isinstance(v, BoxType) else
                JScoreMode(v.value) if isinstance(v, ScoreMode) else v)
            for k, v in det_cfg.items()}
    jb = JBuilder(text_type).with_det_config(**jcfg)
    jax_pipe.detector.postprocess = JDBPostProcess(jb._det_post)
    jax_pipe.detector.resize_cfg = jb._det_resize
    pipe = (OAROCRBuilder(text_type)
            .with_runtime(Runtime("float32", device="cpu"))
            .with_det_params(params_from_jax(read_safetensors(str(BENCH_DET))))
            .with_rec_params(params_from_jax(rec_flat))
            .with_det_config(**det_cfg)
            .with_batch_sizes(image=2, region=64).build())
    pages = _pages()
    return pipe.predict(pages), jax_pipe.predict(pages)


def _same(ours, ref, min_regions):
    n = 0
    for o, r in zip(ours, ref):
        assert len(o.regions) == len(r.regions)
        for a, b in zip(o.regions, r.regions):
            assert a.box.shape == b.box.shape
            np.testing.assert_allclose(a.box, b.box, atol=1e-3, rtol=0)
            assert a.text == b.text
            assert abs(a.det_score - b.det_score) <= 1e-5
            n += 1
    assert n >= min_regions, f"vacuous reference: {n} regions"
    assert any(x.text for res in ours for x in res.regions)


# the seal preset (thresh 0.2, box_thresh 0.6, unclip 0.5, MIN side,
# POLY) with its side limit cut from 736 to 320, so these 320×480 pages are
# detected at their own size on the CPU; POLY under the general preset;
# slow scoring of each box type
@pytest.mark.parametrize("case", [
    ("seal", {"limit_side_len": 320}),
    ("general", {"box_type": BoxType.POLY}),
    ("general", {"score_mode": ScoreMode.SLOW}),
    ("seal", {"limit_side_len": 320, "score_mode": ScoreMode.SLOW}),
], ids=["seal", "general_poly", "general_slow", "seal_slow"])
def test_pipeline_matches_jax(weights, jax_pipe, case):
    text_type, det_cfg = case
    ours, ref = _run(weights, jax_pipe, text_type, **det_cfg)
    _same(ours, ref, min_regions=6)
    poly = text_type == "seal" or det_cfg.get("box_type") == BoxType.POLY
    shapes = {x.box.shape[0] for res in ours for x in res.regions}
    assert (max(shapes) > 4) == poly, shapes


def _polys(rng, k, p_max, h, w):
    """Seeded star-shaped polygons (3 to p_max vertices), padded to p_max
    by repeating vertex 0."""
    polys = np.zeros((k, p_max, 2), np.float32)
    for i in range(k):
        n = int(rng.integers(3, p_max + 1))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(4, 20, n)
        c = rng.uniform([20, 20], [w - 20, h - 20])
        pts = c + np.stack([np.cos(ang), np.sin(ang)], 1) * rad[:, None]
        polys[i, :n] = pts
        polys[i, n:] = pts[0]
    return polys


@pytest.mark.parametrize("k", [1, 4, 7])
def test_poly_scores_match_jax(k):
    rng = np.random.default_rng(k)
    prob = rng.random((2, 64, 96)).astype(np.float32)
    polys = _polys(rng, k, 12, 64, 96)
    idx = rng.integers(0, 2, k).astype(np.int32)
    kb = -(-k // 4) * 4                 # the JAX op takes chunks of 4
    jp = np.concatenate([polys, np.zeros((kb - k, 12, 2), np.float32)])
    ji = np.concatenate([idx, np.zeros(kb - k, np.int32)])
    ref = np.asarray(jdet.poly_scores(jnp.asarray(prob), jnp.asarray(jp),
                                      jnp.asarray(ji)))[:k]
    got = det_device.poly_scores(torch.from_numpy(prob),
                                 torch.from_numpy(polys),
                                 torch.from_numpy(idx)).numpy()
    assert np.all(got > 0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_poly_scores_match_host_box_score():
    """On a map that is constant over each polygon and a margin around
    it, the device ray casting (pixel centres) and the host ``box_score``
    (``fillPoly`` of the rounded polygon) both give that constant."""
    rng = np.random.default_rng(5)
    prob = np.zeros((1, 96, 128), np.float32)
    polys, want = [], []
    for i, (cy, cx) in enumerate([(24, 24), (24, 72), (72, 40), (70, 100)]):
        poly = _polys(rng, 1, 9, 48, 48)[0] - 24 + [cx, cy]
        poly = np.clip(poly, [cx - 18, cy - 18], [cx + 18, cy + 18])
        prob[0, cy - 22:cy + 23, cx - 22:cx + 23] = 0.1 + 0.2 * i
        polys.append(poly.astype(np.float32))
        want.append(0.1 + 0.2 * i)
    polys = np.stack(polys)
    got = det_device.poly_scores(torch.from_numpy(prob),
                                 torch.from_numpy(polys),
                                 torch.zeros(len(polys), dtype=torch.int64))
    host = [box_score(prob[0], poly) for poly in polys]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(host, want, atol=1e-6)

"""The server recognizer and the server ``OAROCR`` against the JAX
package on the CPU, float32.

- ``SVTRRecognizer(backbone="hgnet")`` (PP-HGNetV2-B4 in rec mode, 36.1 M
  parameters at vocab 96) at (2, 48, 160): the JAX float32
  probabilities within 1e-5 of the port's float64 run, or within four
  times the port float32's own distance from it (``test_torch_hgnet.py``
  says why), and the same argmax;
- ``OAROCR(DBDetector(backbone="hgnet"), CTCRecognizer(backbone="hgnet"),
  cfg)`` on 2 pages of 320×480, both models calibrated on those pages
  (``utils/calibrate``), the detector thresholded at 0.8 (the calibrated
  random map spreads over [0, 1] with median 0.5, so the default 0.3
  would make each page one region): the JAX pipeline's gate
  (``utils/parity.compare_results``): the same region count, quad IoU
  ≥ 0.95, identical texts, confidence Δ ≤ 2e-2. Both packages run their
  DB postprocess on their C++ extensions (``torch_jax_tree.
  one_db_path_module``): on the Python path the JAX reference finds
  fewer than 10 regions a page, and the test fails as vacuous.
"""

import copy

import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.models.detection.detector import DBDetector as JDBDetector
from oar_ocr_tpu.models.detection.db import DBNet as JDBNet
from oar_ocr_tpu.models.recognition.recognizer import \
    CTCRecognizer as JCTCRecognizer
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer as JSVTR
from oar_ocr_tpu.pipelines.ocr import OAROCR as JOAROCR
from oar_ocr_tpu.pipelines.ocr import OAROCRConfig as JOAROCRConfig
from oar_ocr_tpu.processors.db_postprocess import \
    DBPostProcessConfig as JPostConfig
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu_torch.models.detection.db import DBNet
from oar_ocr_tpu_torch.models.detection.detector import (DET_ALPHA, DET_BETA,
                                                        DBDetector)
from oar_ocr_tpu_torch.models.recognition.recognizer import CTCRecognizer
from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
from oar_ocr_tpu_torch.pipelines.ocr import OAROCR, OAROCRConfig
from oar_ocr_tpu_torch.processors.db_postprocess import DBPostProcessConfig
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.utils.calibrate import calibrated_state_dict
from oar_ocr_tpu_torch.utils.parity import compare_results
from torch_jax_tree import (jax_tree_from_port,  # noqa: F401
                            one_db_path_module, one_torch_thread, rel_err)

DET_THRESH, BOX_THRESH = 0.8, 0.5
_DIMS = [(300, 26), (180, 24), (360, 30), (120, 22)]


def _pages():
    rng = np.random.default_rng(7)
    pages = []
    for p in range(2):
        img = np.full((320, 480, 3), 255, np.uint8)
        for r in range(4):
            w, h = _DIMS[(r + p) % len(_DIMS)]
            y = 30 + r * 70
            img[y:y + h, 40:40 + w] = rng.integers(0, 80)
        pages.append(img)
    return pages


def test_server_svtr_matches():
    x = np.random.default_rng(8).uniform(-1, 1, (2, 48, 160, 3)).astype(
        np.float32)
    model = SVTRRecognizer(96, backbone="hgnet")
    sd = calibrated_state_dict(model, torch.Generator().manual_seed(9),
                               torch.from_numpy(x))
    assert sum(v.numel() for k, v in sd.items() if not k.endswith(
        ("running_mean", "running_var"))) == 36_086_112
    jmod = JSVTR(vocab_size=96, backbone="hgnet")
    ref = np.asarray(jmod.apply(jax_tree_from_port(jmod, (1, 48, 64, 3), sd),
                                x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = model(xt).numpy()
        got64 = copy.deepcopy(model).double()(xt.double()).numpy()
    assert got.shape == ref.shape == (2, 20, 96)
    assert rel_err(ref, got64) <= max(1e-5, 4 * rel_err(got, got64))
    assert (ref.argmax(-1) == got.argmax(-1)).all()


@pytest.fixture(scope="module")
def server_results(one_db_path_module):
    pages = _pages()
    x = torch.from_numpy(np.stack(pages)).float() * torch.tensor(
        DET_ALPHA) + torch.tensor(DET_BETA)
    det_sd = calibrated_state_dict(DBNet(backbone="hgnet"),
                                   torch.Generator().manual_seed(1), x)
    tiles = torch.from_numpy(np.stack(
        [pg[y:y + 48, 40:200] for pg in pages for y in (30, 100)])).float()
    rec_sd = calibrated_state_dict(SVTRRecognizer(96, backbone="hgnet"),
                                   torch.Generator().manual_seed(2),
                                   tiles * (2 / 255) - 1)
    rt = Runtime("float32", device="cpu")
    pipe = OAROCR(
        DBDetector(det_sd, backbone="hgnet", runtime=rt,
                   post_cfg=DBPostProcessConfig(thresh=DET_THRESH,
                                                box_thresh=BOX_THRESH)),
        CTCRecognizer(rec_sd, backbone="hgnet", runtime=rt),
        OAROCRConfig(image_batch_size=2, region_batch_size=16))
    jrt = JRuntime(JRuntimeConfig(compute_dtype="float32", use_mesh=False))
    jpipe = JOAROCR(
        JDBDetector(jax_tree_from_port(JDBNet(backbone="hgnet"),
                                       (1, 64, 64, 3), det_sd),
                    backbone="hgnet", runtime=jrt,
                    post_cfg=JPostConfig(thresh=DET_THRESH,
                                         box_thresh=BOX_THRESH)),
        JCTCRecognizer(jax_tree_from_port(
            JSVTR(vocab_size=96, backbone="hgnet"), (1, 48, 64, 3), rec_sd),
            backbone="hgnet", runtime=jrt),
        JOAROCRConfig(image_batch_size=2, region_batch_size=16), jrt)
    return pipe, pipe.predict(pages), jpipe.predict(pages)


def test_server_ocr_matches_jax(server_results):
    pipe, ours, ref = server_results
    assert pipe.runtime is pipe.detector.runtime       # the stages' Runtime
    assert all(len(r.regions) >= 10 for r in ref), "vacuous reference"
    report = compare_results(ours, ref)
    assert report["ok"], report
    assert sum(1 for r in ours for x in r.regions if x.text) >= 10

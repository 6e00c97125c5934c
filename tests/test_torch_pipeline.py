"""The port's OAROCR against the JAX OAROCR, end to end on the CPU.

Both pipelines run in float32 on the same two synthetic pages, the
detector on the trained ``assets/bench_det.safetensors`` and the
recognizer on JAX-initialised weights converted with ``params_from_jax``.
Gate (``tools/bench_accuracy.py:38``): the same region count, quad IoU ≥
0.95 per matched region, identical texts, confidence Δ ≤ 2e-2.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer
from oar_ocr_tpu.ops.ctc import default_charset
from oar_ocr_tpu.pipelines.ocr import OAROCRBuilder as JBuilder
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import init_params
from oar_ocr_tpu.runtime.weights import flatten_params, load_params
from oar_ocr_tpu_torch.domain.text_region import OAROCRResult, TextRegion
from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax, read_safetensors
from oar_ocr_tpu_torch.utils.parity import compare_results

REPO = Path(__file__).resolve().parents[1]
BENCH_DET = REPO / "assets" / "bench_det.safetensors"
_DIMS = [(300, 26), (180, 24), (360, 30), (120, 22)]


def _pages():
    rng = np.random.default_rng(7)
    pages = []
    for p in range(2):
        img = np.full((320, 480, 3), 255, np.uint8)
        for r in range(4):
            w, h = _DIMS[(r + p) % len(_DIMS)]
            y = 30 + r * 70
            img[y : y + h, 40 : 40 + w] = rng.integers(0, 80)
        pages.append(img)
    return pages


@pytest.fixture(scope="module")
def both_results():
    pages = _pages()
    vocab = 2 + len(default_charset())
    rec_tree = init_params(SVTRRecognizer(vocab_size=vocab), (1, 48, 64, 3))
    det_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            load_params(str(BENCH_DET)))
    jpipe = (JBuilder("general")
             .with_runtime(JRuntime(JRuntimeConfig(compute_dtype="float32",
                                                   use_mesh=False)))
             .with_det_params(det_tree).with_rec_params(rec_tree)
             .with_batch_sizes(image=2, region=16).build())
    ref = jpipe.predict(pages)
    pipe = (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", device="cpu"))
            .with_det_params(params_from_jax(read_safetensors(str(BENCH_DET))))
            .with_rec_params(params_from_jax(flatten_params(rec_tree)))
            .with_batch_sizes(image=2, region=16).build())
    return pipe.predict(pages), ref


def test_pipeline_matches_jax(both_results):
    ours, ref = both_results
    assert all(len(r.regions) >= 3 for r in ref), "vacuous reference"
    report = compare_results(ours, ref)
    assert report["ok"], report
    assert any(r.text for res in ours for r in res.regions), \
        "every text empty: the text comparison would be vacuous"


def test_pipeline_result_frame(both_results):
    """The port returns its own result types, with the JAX results'
    frame and detection scores."""
    ours, ref = both_results
    for o, r in zip(ours, ref):
        assert isinstance(o, OAROCRResult)
        assert all(isinstance(x, TextRegion) for x in o.regions)
        assert (o.width, o.height) == (r.width, r.height) == (480, 320)
        for reg, rreg in zip(o.regions, r.regions):
            assert abs(reg.det_score - rreg.det_score) < 1e-3


def test_predict_empty_and_bad_input():
    pipe = (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", device="cpu")).build())
    assert pipe.predict([]) == []
    with pytest.raises(InvalidInputError):
        pipe.predict([np.zeros((10, 10), np.uint8)])


def _port_pipeline():
    return (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", device="cpu"))
            .with_det_params(params_from_jax(read_safetensors(str(BENCH_DET))))
            .with_batch_sizes(image=2, region=16).build())


def _fail_batched_finalize(monkeypatch):
    """The batched ``finalize`` raises a host error once; per-image
    detection calls it again and succeeds."""
    from oar_ocr_tpu_torch.models.detection.detector import DBDetector

    real, calls = DBDetector.finalize, []

    def finalize(self, pending):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("degenerate contour")
        return real(self, pending)

    monkeypatch.setattr(DBDetector, "finalize", finalize)


@pytest.mark.parametrize("where", ["fetch", "relaunch"])
def test_device_faults_propagate(where, monkeypatch):
    """A device fault must not turn into empty pages: an asynchronous
    fault that surfaces when the bitmap copy is joined, or a failed K1
    launch in the per-image retry, raises out of ``predict``."""
    from oar_ocr_tpu_torch.models.detection import detector as det_mod
    from oar_ocr_tpu_torch.runtime.runtime import HostFetch

    pipe = _port_pipeline()
    if where == "fetch":
        def result(self):
            raise RuntimeError("CUDA error: an illegal memory access "
                               "was encountered")

        monkeypatch.setattr(HostFetch, "result", result)
    else:
        _fail_batched_finalize(monkeypatch)
        real, calls = det_mod.separable_resize_normalize, []

        def resize(*args, **kwargs):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("normalize kernel launch failed")
            return real(*args, **kwargs)

        monkeypatch.setattr(det_mod, "separable_resize_normalize", resize)
    with pytest.raises(RuntimeError):
        pipe.predict(_pages())


def test_host_postprocess_error_degrades_per_image(monkeypatch):
    """A host error in batched post-processing falls back to per-image
    detection (ocr.rs:576-588) and gives the same results."""
    pipe = _port_pipeline()
    want = pipe.predict(_pages())
    _fail_batched_finalize(monkeypatch)
    got = pipe.predict(_pages())
    assert sum(len(r.regions) for r in want) >= 6
    report = compare_results(got, want)
    assert report["ok"], report


def test_pipeline_imports_no_jax():
    """The port loads neither jax nor the JAX package (checked in a fresh
    interpreter, since this test process already imported both), the
    modules the builder imports lazily for its optional stages, the
    random-weight calibration of the tests and chip_smoke.py, the
    structure pipeline, the CLI, the serving engine, the task predictors
    and their host copies included."""
    code = ("import sys; import oar_ocr_tpu_torch.pipelines.ocr, "
            "oar_ocr_tpu_torch.ops.normalize, "
            "oar_ocr_tpu_torch.pipelines.preprocess, "
            "oar_ocr_tpu_torch.models.classification.pp_lcnet, "
            "oar_ocr_tpu_torch.models.rectification.uvdoc, "
            "oar_ocr_tpu_torch.models.backbones, "
            "oar_ocr_tpu_torch.ops.grid_sample, "
            "oar_ocr_tpu_torch.processors.word_boxes, "
            "oar_ocr_tpu_torch.utils.calibrate, "
            "oar_ocr_tpu_torch.pipelines.structure, "
            "oar_ocr_tpu_torch.cli, oar_ocr_tpu_torch.serving.engine, "
            "oar_ocr_tpu_torch.predictors.predictors, "
            "oar_ocr_tpu_torch.tasks.tasks, "
            "oar_ocr_tpu_torch.config.validation, "
            "oar_ocr_tpu_torch.config.runtime, "
            "oar_ocr_tpu_torch.utils.image, "
            "oar_ocr_tpu_torch.models.hgnet; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

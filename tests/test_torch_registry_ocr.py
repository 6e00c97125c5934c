"""The slice as a whole: upstream ONNX files → the port's
``tools/port_fetch_and_verify.py`` → the registry cache → ``OAROCR`` built
from registry names, the port against the JAX package on the CPU.

Under one temporary ``$OAR_TPU_HOME``:

- ``pp-ocrv5_mobile_det`` from an ONNX file of official-name tensors: the
  bench detector (``assets/bench_det.safetensors``, ``DBNet()``, the
  width the converter builds for that name; trained, so the pages give
  boxes);
- ``pp-ocrv5_mobile_rec`` from an ONNX file of the port's seeded SVTR at
  its converter width, vocab 18385 (``KNOWN_DICT_LENS`` of
  ``ppocrv5_dict.txt``, which is not on disk), so both builders take the
  tool's placeholder dictionary.

``port_fetch_and_verify`` converts each on the CPU and prints its
verdict; then ``OAROCRBuilder().with_det_source(name).with_rec_source(
name)`` of each package reads the same two artifacts and predicts two
seeded 160×320 pages: the same boxes within 1e-4 px and the same texts.
The JAX pipeline runs its non-speculative consume
(``OAR_TPU_NO_SPEC_REC``), the one the port has.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.pipelines.ocr import OAROCRBuilder as JBuilder
from oar_ocr_tpu.registry import models as jm
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu_torch.models.detection.db import DBNet
from oar_ocr_tpu_torch.models.layers import init_state_dict
from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.registry import models as pm
from oar_ocr_tpu_torch.runtime.ppocr_maps import export_ppocr_format
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import (load_jax_checkpoint,
                                               load_params)
from test_fetch_and_verify import _onnx_bytes
from torch_jax_tree import one_torch_thread  # noqa: F401

ASSETS = Path(__file__).resolve().parents[1] / "assets"

DET, REC = "pp-ocrv5_mobile_det", "pp-ocrv5_mobile_rec"


def _pages():
    rng = np.random.default_rng(13)
    pages = []
    for _ in range(2):
        img = np.full((160, 320, 3), 255, np.uint8)
        for r in range(3):
            y = 16 + r * 48
            x0 = int(rng.integers(8, 40))
            img[y:y + 22, x0:x0 + int(rng.integers(120, 260))] = \
                int(rng.integers(0, 60))
        pages.append(img)
    return pages


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """The cache after ``port_fetch_and_verify`` of both names, and their
    verdicts."""
    from tools import port_fetch_and_verify as fv

    root = tmp_path_factory.mktemp("oar_home")
    det = DBNet()
    det_sd = load_jax_checkpoint(str(ASSETS / "bench_det.safetensors"))
    rec = SVTRRecognizer(18385)
    rec_sd = init_state_dict(rec, torch.Generator().manual_seed(8))
    verdicts = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(pm, "OAR_TPU_HOME", str(root))
    mp.setattr(jm, "OAR_TPU_HOME", str(root))
    mp.setenv("OAR_TPU_NO_SPEC_REC", "1")
    try:
        for name, model, sd in ((DET, det, det_sd), (REC, rec, rec_sd)):
            onnx = root / f"upstream_{name}.onnx"
            onnx.write_bytes(_onnx_bytes({
                k: np.ascontiguousarray(v)
                for k, v in export_ppocr_format(model, sd).items()}))
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = fv.main(["--model", name, "--upstream-file", str(onnx),
                              "--device", "cpu"])
            assert rc == 0
            verdicts[name] = json.loads(out.getvalue().splitlines()[-1])
        yield root, verdicts, {DET: det_sd, REC: rec_sd}
    finally:
        mp.undo()


def test_fetch_and_verify_verdicts(home):
    root, verdicts, sds = home
    for name in (DET, REC):
        v = verdicts[name]
        assert v["verdict"] == "OK" and v["sha256"] == \
            "skipped (local stand-in)"
        assert v["converted"] == str(root / "models" / f"{name}.safetensors")
        assert set(v["ms"]) == {"fetch", "extract", "convert", "predict"}
        got = load_params(v["converted"])
        assert all(torch.equal(got[k], sds[name][k]) for k in sds[name])
    assert verdicts[DET]["predict"]["regions"] == 4
    assert verdicts[REC]["charset"] == "placeholder (18383 entries)"


def test_registry_built_ocr_matches_jax(home):
    from tools.port_fetch_and_verify import placeholder_charset

    charset = placeholder_charset(18383)
    pages = _pages()
    ours = (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", device="cpu"))
            .with_det_source(DET).with_rec_source(REC)
            .with_charset(charset).build().predict(pages))
    ref = (JBuilder("general")
           .with_runtime(JRuntime(JRuntimeConfig(compute_dtype="float32",
                                                 use_mesh=False)))
           .with_det_source(DET).with_rec_source(REC)
           .with_charset(charset).build().predict(pages))
    assert [len(r.regions) for r in ref] == [3, 3], "vacuous reference"
    for o, r in zip(ours, ref):
        assert len(o.regions) == len(r.regions)
        for a, b in zip(o.regions, r.regions):
            assert np.abs(np.asarray(a.box, np.float64)
                          - np.asarray(b.box, np.float64)).max() <= 1e-4
            assert a.text == b.text
    assert any(reg.text for o in ours for reg in o.regions), "vacuous texts"

"""The OCR front end's weight-source and path options on the CPU.

- ``OAROCRBuilder.with_det_source`` / ``with_rec_source`` from a path
  and from a ``ModelSource`` of bytes give exactly the weights of
  ``with_*_params`` on the same file; a registry name whose artifact
  is not in the cache raises ``DownloadError``, as in the JAX builder,
  and a string that is neither a path nor a name ``ModelLoadError``; a
  file that is no safetensors checkpoint raises ``ModelLoadError``.
- ``OAROCR.predict_paths`` and ``OARStructure.predict_paths`` decode
  through ``utils/image.load_images`` (``FAIL_FAST``): results equal
  ``predict`` on the decoded pages, each with its source path; a path
  that does not decode raises ``ImageLoadError``. ``load_images`` with
  ``SKIP_ERRORS`` drops it and keeps the rest, in order.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer as JSVTR
from oar_ocr_tpu.runtime.weights import save_params
from oar_ocr_tpu_torch.errors import (DownloadError, ImageLoadError,
                                      ModelLoadError)
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import (ModelSource, load_params,
                                               load_jax_checkpoint,
                                               read_safetensors)
from oar_ocr_tpu_torch.utils.image import BatchLoadPolicy, load_images
from oar_ocr_tpu_torch.utils.parity import compare_results
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa: F401

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BENCH_DET = str(ASSETS / "bench_det.safetensors")


def _cpu_builder():
    return OAROCRBuilder("general").with_runtime(
        Runtime("float32", device="cpu"))


def _same_state(model, state):
    got = model.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k


@pytest.mark.parametrize("how", ["path", "path_source", "bytes_source"])
def test_det_source_matches_params(how):
    want = load_jax_checkpoint(BENCH_DET)
    src = {"path": BENCH_DET,
           "path_source": ModelSource.from_path(BENCH_DET),
           "bytes_source": ModelSource.from_bytes(
               Path(BENCH_DET).read_bytes())}[how]
    pipe = _cpu_builder().with_det_source(src).build()
    _same_state(pipe.detector.model, want)


def test_rec_source_from_a_jax_checkpoint(tmp_path):
    """A JAX-package recognizer checkpoint (``weights.save_params``)
    through ``with_rec_source``: the port's recognizer holds its
    weights."""
    fitted = {k: torch.from_numpy(v) for k, v in read_safetensors(
        str(ASSETS / "fitted_rec.safetensors")).items()}
    path = tmp_path / "rec.safetensors"
    save_params(jax_tree_from_port(JSVTR(vocab_size=96), (1, 48, 64, 3),
                                   fitted), str(path))
    pipe = _cpu_builder().with_rec_source(str(path)).build()
    _same_state(pipe.recognizer.model, fitted)
    assert load_params(ModelSource.from_bytes(path.read_bytes())).keys() \
        == fitted.keys()


def test_registry_name_and_bad_files(tmp_path, monkeypatch):
    from oar_ocr_tpu_torch.registry import models

    monkeypatch.setattr(models, "OAR_TPU_HOME", str(tmp_path / "home"))
    with pytest.raises(DownloadError, match="not cached"):
        _cpu_builder().with_det_source("pp-ocrv5_mobile_det")
    with pytest.raises(ModelLoadError, match="unknown model"):
        _cpu_builder().with_det_source("no-such-model")
    bad = tmp_path / "bad.safetensors"
    for payload in (b"", b"\x10\x00\x00\x00\x00\x00\x00\x00{not json}",
                    Path(BENCH_DET).read_bytes()[:4096]):
        bad.write_bytes(payload)
        with pytest.raises(ModelLoadError):
            _cpu_builder().with_rec_source(str(bad))
        with pytest.raises(ModelLoadError):
            load_params(ModelSource.from_bytes(payload))
    with pytest.raises(ModelLoadError):
        load_params(ModelSource())
    with pytest.raises(ModelLoadError):
        load_params(ModelSource.from_path(str(tmp_path / "missing")))


def _write_pages(tmp_path):
    rng = np.random.default_rng(11)
    paths = []
    for i in range(2):
        img = np.full((320, 480, 3), 255, np.uint8)
        for r in range(3):
            y = 40 + r * 90
            img[y:y + 28, 40:40 + int(rng.integers(150, 380))] = 30
        path = tmp_path / f"page{i}.png"
        cv2.imwrite(str(path), img[:, :, ::-1])
        paths.append(str(path))
    return paths


def test_predict_paths(tmp_path):
    paths = _write_pages(tmp_path)
    pipe = _cpu_builder().with_det_source(BENCH_DET).build()
    got = pipe.predict_paths(paths)
    want = pipe.predict([cv2.imread(p)[:, :, ::-1].copy() for p in paths])
    assert [r.source_path for r in got] == paths
    assert sum(len(r.regions) for r in want) >= 4
    assert compare_results(got, want)["ok"]
    with pytest.raises(ImageLoadError):
        pipe.predict_paths([paths[0], str(tmp_path / "missing.png")])


@pytest.mark.parametrize("workers", [1, 4])
def test_load_images_policies(tmp_path, workers):
    from oar_ocr_tpu_torch.config.runtime import ParallelPolicy

    paths = _write_pages(tmp_path)
    (tmp_path / "junk.png").write_bytes(b"not an image")
    order = [paths[0], str(tmp_path / "junk.png"), paths[1]]
    par = ParallelPolicy(max_workers=workers)
    with pytest.raises(ImageLoadError):
        load_images(order, BatchLoadPolicy.FAIL_FAST, parallel=par)
    images, loaded = load_images(order, BatchLoadPolicy.SKIP_ERRORS,
                                 parallel=par)
    assert loaded == paths
    assert all(np.array_equal(im, cv2.imread(p)[:, :, ::-1])
               for im, p in zip(images, paths))


def test_structure_predict_paths_refuses_a_bad_path(tmp_path):
    """``OARStructure.predict_paths`` decodes through ``load_images``
    before any model runs: an undecodable path raises ``ImageLoadError``
    (a layout-only pipeline on PicoDet, the smallest variant)."""
    from oar_ocr_tpu_torch.pipelines.structure import OARStructureBuilder

    pipe = (OARStructureBuilder().with_runtime(Runtime("float32",
                                                       device="cpu"))
            .with_layout_variant("pp-doclayout-s").with_tables(False)
            .with_formulas(False).with_seals(False).build())
    paths = _write_pages(tmp_path)
    with pytest.raises(ImageLoadError):
        pipe.predict_paths([paths[0], str(tmp_path / "missing.png")])
    got = pipe.predict_paths(paths[:1])
    assert got[0].source_path == paths[0]
    assert (got[0].width, got[0].height) == (480, 320)

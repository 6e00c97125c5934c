"""The port's model registry against the JAX package's, on the CPU.

``registry/upstream.py`` is a verbatim copy (held line for line in
``test_torch_host_copies.py``), ``registry/models.py`` one but for the
wording of how downloading is switched on (held here); the two run side
by side under one temporary ``$OAR_TPU_HOME``: the tables,
``resolve_model_path`` (a path, a cache hit, a cache miss with the
converter hint, an unknown name, a checksum mismatch), ``asset_path``,
``upstream_provenance``, ``sha256_file``, and ``fetch_upstream`` with an
injected opener as ``test_registry_weights.py`` drives it (never the
network): disabled by default, retried, verified, cached. Then the
builder: ``with_det_source`` of a registry name reads the cached
artifact and predicts.
"""

import dataclasses
import hashlib
import io
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from oar_ocr_tpu.errors import DownloadError as JDownloadError
from oar_ocr_tpu.errors import ModelLoadError as JModelLoadError
from oar_ocr_tpu.registry import models as jm
from oar_ocr_tpu_torch.errors import DownloadError, ModelLoadError
from oar_ocr_tpu_torch.registry import models as pm
from torch_jax_tree import one_torch_thread  # noqa: F401

ASSETS = Path(__file__).resolve().parents[1] / "assets"


@pytest.fixture
def home(tmp_path, monkeypatch):
    """One temporary ``$OAR_TPU_HOME`` for both packages."""
    monkeypatch.setattr(pm, "OAR_TPU_HOME", str(tmp_path))
    monkeypatch.setattr(jm, "OAR_TPU_HOME", str(tmp_path))
    monkeypatch.delenv("OAR_TPU_ALLOW_DOWNLOAD", raising=False)
    return tmp_path


def _both(fn_name, *args, **kw):
    """(port result or exception, JAX result or exception)."""
    out = []
    for mod in (pm, jm):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except Exception as e:           # noqa: BLE001 — compared below
            out.append(e)
    return out


def _same_error(ours, ref, kind, jkind):
    assert isinstance(ours, kind) and isinstance(ref, jkind), (ours, ref)
    assert str(ours) == str(ref)
    assert ours.context == ref.context


def test_tables_match():
    assert list(pm.MODEL_REGISTRY) == list(jm.MODEL_REGISTRY)
    for name, e in pm.MODEL_REGISTRY.items():
        assert dataclasses.asdict(e) == dataclasses.asdict(
            jm.MODEL_REGISTRY[name])
    assert pm.UPSTREAM_ARTIFACTS == jm.UPSTREAM_ARTIFACTS
    assert pm.ASSET_REGISTRY == jm.ASSET_REGISTRY
    for name in ("ch_svtrv2_rec.onnx", "ppocrv5_dict.txt", "a b&c.onnx"):
        assert pm.artifact_url(name) == jm.artifact_url(name)
    for name, e in pm.MODEL_REGISTRY.items():
        assert pm.upstream_provenance(e) == jm.upstream_provenance(
            jm.MODEL_REGISTRY[name])


@pytest.mark.parametrize("case", ["path", "hit", "miss", "unknown",
                                  "mismatch", "unverified"])
def test_resolve_model_path_matches_jax(case, home, monkeypatch):
    name = "pp-ocrv5_mobile_det"
    cached = home / "models" / f"{name}.safetensors"
    if case == "path":
        p = home / "x.safetensors"
        p.write_bytes(b"x")
        ours, ref = _both("resolve_model_path", str(p))
        assert ours == ref == str(p)
        return
    if case == "unknown":
        ours, ref = _both("resolve_model_path", "no-such-model")
        _same_error(ours, ref, ModelLoadError, JModelLoadError)
        return
    if case == "miss":
        ours, ref = _both("resolve_model_path", name)
        _same_error(ours, ref, DownloadError, JDownloadError)
        assert "tools/convert_weights.py" in str(ours)
        assert ours.context["cache_path"] == str(cached)
        return
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"artifact")
    if case in ("mismatch", "unverified"):
        for mod in (pm, jm):
            monkeypatch.setitem(mod.MODEL_REGISTRY, name, dataclasses.replace(
                mod.MODEL_REGISTRY[name], sha256="0" * 64))
    if case == "mismatch":
        ours, ref = _both("resolve_model_path", name)
        _same_error(ours, ref, DownloadError, JDownloadError)
        assert ours.context["actual"] == hashlib.sha256(
            b"artifact").hexdigest()
        return
    kw = {"verify": False} if case == "unverified" else {}
    ours, ref = _both("resolve_model_path", name, **kw)
    assert ours == ref == str(cached)


def test_asset_path_and_sha256(home):
    ours, ref = _both("asset_path", "test_tokenizer.json")
    assert ours == ref == str(ASSETS / "test_tokenizer.json")
    assert _both("asset_path", "ppocrv5_dict.txt") == [None, None]
    (home / "assets").mkdir()
    (home / "assets" / "ppocrv5_dict.txt").write_text("a\nb\n")
    ours, ref = _both("asset_path", "ppocrv5_dict.txt")
    assert ours == ref == str(home / "assets" / "ppocrv5_dict.txt")
    p = home / "f"
    p.write_bytes(bytes(range(256)) * 4099)
    assert pm.sha256_file(str(p)) == jm.sha256_file(str(p)) == \
        hashlib.sha256(p.read_bytes()).hexdigest()


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("case", ["disabled", "retry", "checksum", "size"])
def test_fetch_upstream_matches_jax(case, home, monkeypatch):
    """Each package fetches into its own directory with its own opener;
    the calls, the files and the errors agree."""
    payload = b"fake-onnx-bytes"
    digest = hashlib.sha256(payload).hexdigest()
    expect = {"retry": (digest, len(payload)), "checksum": ("0" * 64, 15),
              "size": (digest, 99), "disabled": (digest, len(payload))}
    if case != "disabled":
        monkeypatch.setenv("OAR_TPU_ALLOW_DOWNLOAD", "1")
    results = []
    for mod in (pm, jm):
        monkeypatch.setitem(mod.UPSTREAM_ARTIFACTS, "fake.onnx",
                            expect[case])
        calls = []

        def opener(url, calls=calls):
            calls.append(url)
            if case == "retry" and len(calls) < 3:
                raise OSError("connection reset")
            return _Resp(payload)

        target = home / mod.__name__.split(".")[0]
        target.mkdir()
        try:
            path = mod.fetch_upstream("fake.onnx", target_dir=str(target),
                                      opener=opener)
            again = mod.fetch_upstream("fake.onnx", target_dir=str(target),
                                       opener=opener)
            assert again == path
            results.append((Path(path).read_bytes(), len(calls)))
        except Exception as e:           # noqa: BLE001 — compared below
            results.append((type(e).__name__, str(e), len(calls),
                            sorted(p.name for p in target.iterdir())))
    ours, ref = results
    if case == "disabled":            # the message is reworded in the port
        assert (ours[0], ours[2:]) == (ref[0], ref[2:]) == \
            ("DownloadError", (0, []))
        assert "OAR_TPU_ALLOW_DOWNLOAD=1" in ours[1]
        assert "OAR_TPU_ALLOW_DOWNLOAD=1" in ref[1]
        return
    assert ours == ref
    if case == "retry":
        assert ours == (payload, 3)
    else:
        assert ours[0] == "DownloadError" and ours[2] == 3 and not ours[3]


def test_builder_reads_registry_name(home):
    """``with_det_source(name)`` in the port: the cache's artifact (here
    the bench detector's file, which is pp-ocrv5_mobile_det's shape)
    becomes the detector's weights, and the pipeline predicts."""
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint

    src = ASSETS / "bench_det.safetensors"
    (home / "models").mkdir()
    shutil.copy(src, home / "models" / "pp-ocrv5_mobile_det.safetensors")
    pipe = (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", device="cpu"))
            .with_det_source("pp-ocrv5_mobile_det").build())
    want = load_jax_checkpoint(str(src))
    got = pipe.detector.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    page = np.full((160, 320, 3), 255, np.uint8)
    page[30:52, 20:240] = 20
    page[90:112, 40:300] = 20
    res = pipe.predict([page])
    assert len(res[0].regions) == 2


def test_models_copy_differs_only_in_wording():
    """``registry/models.py`` is the original line for line but for its
    docstring's port paragraph and the three rewordings it names."""
    import difflib

    root = Path(__file__).resolve().parents[1]
    ours = (root / "oar_ocr_tpu_torch/registry/models.py").read_text()
    ref = (root / "oar_ocr_tpu/registry/models.py").read_text()
    removed = [line[1:] for line in difflib.unified_diff(
        ref.splitlines(), ours.splitlines(), lineterm="", n=0)
        if line.startswith("-") and not line.startswith("---")]
    assert sorted(removed) == sorted([
        "than ONNX files. In this zero-egress environment download is "
        "disabled;",
        "# The same flow exists here behind OAR_TPU_ALLOW_DOWNLOAD=1 — this",
        "# sandbox forbids egress, so it is opt-in; outside it the "
        "framework",
        '            "upstream artifacts outside sandboxed environments)",'])

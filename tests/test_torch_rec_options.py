"""The recognizer's dictionary options and the fitted recognizer in
bfloat16, the port against the JAX package on the CPU.

Weights: ``assets/fitted_rec.safetensors`` (chip_smoke's phase 4
recognizer fitted to drawn lines on the card, PP-LCNetV3 ×0.95, vocab
96), carried into the JAX tree by ``torch_jax_tree.jax_tree_from_port``.
Input: phase 6's drawn text page (seed 23, 20 lines held out from the
fit), as the card's machine draws it: ``assets/text_page_23.png`` with
its line boxes and strings in ``text_page_23.json``. ``cv2.putText``
draws other glyphs under other OpenCV builds (this page was drawn with
OpenCV 4.13 on the card's machine), and the fit reads only those.

- The fitted recognizer in float32 and in bfloat16: each package's own
  dispatch (warp, normalize, model, CTC) on the 20 lines, the same 20
  texts. In bfloat16 both read line 11 ('jyKqw') as 'hrKqw' where float32
  reads 'hrKgw': the split is the fitted model's in bfloat16, not the
  port's (ROADMAP queue 3).
- ``charset``, ``use_space_char=False`` and ``reverse=True`` (RTL, with
  Arabic letters in the dictionary): the same texts as JAX, float32.
- ``OAROCRBuilder.with_charset_file`` end to end (the bench detector,
  the weights from a path through ``with_det_source``) on the page's
  lines inverted: the same boxes and texts as the JAX builder's.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.models.recognition.recognizer import CropPlan as JCropPlan
from oar_ocr_tpu.models.recognition.recognizer import \
    CTCRecognizer as JCTCRecognizer
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer as JSVTR
from oar_ocr_tpu.pipelines.ocr import OAROCRBuilder as JBuilder
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.weights import load_params as jload_params
from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.models.recognition.recognizer import (CropPlan,
                                                             CTCRecognizer)
from oar_ocr_tpu_torch.ops.ctc import default_charset
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import read_safetensors
from oar_ocr_tpu_torch.utils.parity import compare_results
from torch_jax_tree import (jax_tree_from_port, one_db_path,  # noqa: F401
                            one_torch_thread)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
ARABIC = [chr(0x0627 + i) for i in range(26)]
# name → (charset, use_space_char, reverse), each 95 symbols with the
# space so the fitted head's 96 outputs keep their meaning
CHARSETS = {
    "custom": (list(default_charset())[::-1], True, False),
    "no_space": (list(default_charset()) + ["é"], False, False),
    "rtl": ([ARABIC[ord(c) - 97] if "a" <= c <= "z" else c
             for c in default_charset()], True, True),
}


@pytest.fixture(scope="module")
def fitted():
    sd = {k: torch.from_numpy(v) for k, v in read_safetensors(
        str(ASSETS / "fitted_rec.safetensors")).items()}
    return sd, jax_tree_from_port(JSVTR(vocab_size=96), (1, 48, 64, 3), sd)


@pytest.fixture(scope="module")
def page():
    img = np.ascontiguousarray(cv2.imread(
        str(ASSETS / "text_page_23.png"))[:, :, ::-1])
    meta = json.loads((ASSETS / "text_page_23.json").read_text())
    quads = [np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)
             for x0, y0, x1, y1 in meta["boxes"]]
    return img, quads, meta["texts"]


def _read_both(fitted, page, dtype, with_jax=True, **opts):
    """The 20 lines' texts: (the port's, the JAX package's or None)."""
    sd, tree = fitted
    img, quads, _ = page
    rt = Runtime(dtype, device="cpu")
    rec = CTCRecognizer(sd, runtime=rt, **opts)
    ours = [t for t, _c, _k in rec.recognize_chunk(
        rt.put_pages([img], img.shape[:2]),
        [CropPlan.from_quad(0, q) for q in quads])]
    if not with_jax:
        return ours, None
    jrt = JRuntime(JRuntimeConfig(compute_dtype=dtype, use_mesh=False))
    jrec = JCTCRecognizer(tree, runtime=jrt, **opts)
    ref = [t for t, _c, _k in jrec.recognize_chunk(
        jrt.put_pages([img], img.shape[:2]),
        [JCropPlan.from_quad(0, q) for q in quads])]
    return ours, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fitted_recognizer_matches_jax(fitted, page, dtype):
    ours, ref = _read_both(fitted, page, dtype)
    assert ours == ref
    truth = page[2]
    assert sum(a == b for a, b in zip(ours, truth)) >= 12, "vacuous"
    assert ours[11] == ("hrKqw" if dtype == "bfloat16" else "hrKgw")


@pytest.mark.parametrize("name", list(CHARSETS))
def test_charset_options_match_jax(fitted, page, name):
    charset, space, reverse = CHARSETS[name]
    opts = dict(charset=charset, use_space_char=space, reverse=reverse)
    ours, ref = _read_both(fitted, page, "float32", **opts)
    assert ours == ref
    plain, _ = _read_both(fitted, page, "float32", with_jax=False,
                          charset=charset, use_space_char=space)
    if name == "rtl":
        assert any(c in ARABIC for t in ours for c in t)
        assert ours != plain                 # the runs were reversed
        assert sorted("".join(ours)) == sorted("".join(plain))
    else:
        assert ours == plain


def test_builder_charset_file_matches_jax(fitted, page, tmp_path,
                                         monkeypatch, one_db_path):
    """The bench detector finds no drawn glyph line (it was trained on
    solid blocks), so the page holds the first 8 lines inverted, white
    glyphs on dark strips, which it finds. The JAX pipeline runs its
    non-speculative consume (``OAR_TPU_NO_SPEC_REC``), the one the port
    has: its speculative one recognizes the candidates below
    ``box_thresh`` too, in the same chunks, which changes the chunks'
    width buckets and so SVTR's padded attention (here one text, '^'
    against '^^')."""
    monkeypatch.setenv("OAR_TPU_NO_SPEC_REC", "1")
    sd, tree = fitted
    src, quads, _ = page
    img = np.full((640, 480, 3), 255, np.uint8)
    for i, q in enumerate(quads[:8]):
        (x0, y0), (x1, y1) = q[0].astype(int), q[2].astype(int)
        img[20 + i * 76:68 + i * 76, 30:30 + x1 - x0] = 255 - src[y0:y1,
                                                                 x0:x1]
    path = tmp_path / "dict.txt"
    path.write_text("\n".join(CHARSETS["custom"][0]) + "\n\n",
                    encoding="utf-8")
    det = str(ASSETS / "bench_det.safetensors")
    ours = (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", device="cpu"))
            .with_charset_file(str(path)).with_det_source(det)
            .with_rec_params(sd).build().predict([img]))
    ref = (JBuilder("general")
           .with_runtime(JRuntime(JRuntimeConfig(compute_dtype="float32",
                                                 use_mesh=False)))
           .with_charset_file(str(path))
           .with_det_params(jload_params(det)).with_rec_params(tree)
           .build().predict([img]))
    assert len(ref[0].regions) >= 8, "vacuous reference"
    report = compare_results(ours, ref)
    assert report["ok"], report
    assert sum(1 for r in ours[0].regions if r.text) >= 5


def test_vocab_over_int16_refused():
    """The int16 CTC packing (``ops/ctc.pack_ctc_raw``) caps the
    vocabulary at 32767, as in JAX: refused before any model is built."""
    big = [chr(0x4E00 + i) for i in range(32766)]
    with pytest.raises(InvalidInputError):
        CTCRecognizer(charset=big, runtime=Runtime("float32", device="cpu"))
    rec = CTCRecognizer(charset=big[:4], use_space_char=False,
                        runtime=Runtime("float32", device="cpu"))
    assert rec.decoder.vocab_size == 5
    assert rec.model.head.ctc_head.fc.out_features == 5

"""The port's CLI (``python -m oar_ocr_tpu_torch.cli``) on the CPU.

- The parser has the JAX CLI's eight subcommands with the same
  arguments, defaults and choices, plus ``--device {cuda,cpu}``
  (default ``cuda``) on each; without a card the default raises
  ``ConfigError``.
- ``ocr``, ``recognize`` and ``detect`` with ``--device cpu`` on two PNGs
  print one JSON line per image, equal to the API's results on the same
  pages (the CLI's models are seeded, as the API's defaults are).
- ``vlm mineru-2.5 --dev-tiny --device cpu`` prints the JAX CLI's JSON
  lines, the JAX model given the port's seeded weights
  (``torch_exact_common``); ``bench`` (ROADMAP queue 1, item 5) raises
  ``UnsupportedError`` naming its item.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from oar_ocr_tpu import cli as jcli
from oar_ocr_tpu_torch import cli
from oar_ocr_tpu_torch.errors import ConfigError, UnsupportedError
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.predictors.predictors import (TextDetectionPredictor,
                                                    TextRecognitionPredictor)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl.exact_models import EXACT_FACTORIES
from torch_jax_tree import one_torch_thread  # noqa: F401

SUBCOMMANDS = ["ocr", "structure", "detect", "recognize", "layout", "vl",
               "vlm", "bench"]


def _actions(parser):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {name: {a.dest: (a.option_strings, a.default, a.choices,
                            a.nargs)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_parser_matches_jax(name):
    ours, ref = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert list(ours) == list(ref) == SUBCOMMANDS
    device = ours[name].pop("device")
    assert device == (["--device"], "cuda", ["cuda", "cpu"], None)
    assert ours[name] == ref[name]


@pytest.fixture
def pngs(tmp_path):
    paths = []
    for i, text in enumerate(("OCR 12", "port")):
        img = np.full((96, 320, 3), 255, np.uint8)
        cv2.putText(img, text, (10, 60), cv2.FONT_HERSHEY_SIMPLEX, 1.4,
                    (20, 20, 20), 3)
        img[70:90, 20:200 + 40 * i] = 40
        path = tmp_path / f"line{i}.png"
        cv2.imwrite(str(path), img)
        paths.append(str(path))
    return paths


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def _images(paths):
    return [np.ascontiguousarray(cv2.imread(p)[:, :, ::-1]) for p in paths]


def test_ocr_cli_matches_api(pngs, capsys):
    cli.main(["ocr", *pngs, "--device", "cpu"])
    got = _lines(capsys)
    want = (OAROCRBuilder("general").with_runtime(Runtime(device="cpu"))
            .build().predict(_images(pngs)))
    assert [g["source_path"] for g in got] == pngs
    for g, w in zip(got, want):
        w = w.to_dict()
        w["source_path"] = g["source_path"]
        assert g == json.loads(json.dumps(w))


def test_recognize_cli_matches_api(pngs, capsys):
    cli.main(["recognize", *pngs, "--device", "cpu"])
    got = _lines(capsys)
    want = TextRecognitionPredictor(runtime=Runtime(device="cpu")).predict(
        _images(pngs))
    assert [(g["source_path"], g["text"], g["confidence"]) for g in got] \
        == [(p, t, c) for p, (t, c) in zip(pngs, want)]


def test_detect_cli_matches_api(pngs, capsys):
    cli.main(["detect", *pngs, "--device", "cpu", "--thresh", "0.2",
              "--box-thresh", "0.3"])
    got = _lines(capsys)
    from oar_ocr_tpu_torch.tasks.tasks import TextDetectionConfig

    want = TextDetectionPredictor(
        TextDetectionConfig(thresh=0.2, box_thresh=0.3),
        runtime=Runtime(device="cpu")).predict(_images(pngs))
    assert got == [{"source_path": p, "boxes": [b.tolist() for b in boxes],
                    "scores": scores} for p, (boxes, scores) in
                   zip(pngs, want)]


@pytest.mark.parametrize("argv,item", [
    (["bench", "--device", "cpu"], "item 5")])
def test_unported_subcommands_raise(argv, item):
    with pytest.raises(UnsupportedError, match=item):
        cli.main(argv)


def test_vlm_matches_jax_cli(pngs, capsys, monkeypatch):
    """``vlm mineru-2.5 --dev-tiny --device cpu``: the JAX CLI's JSON lines
    (the JAX model on the port's weights of the same seed)."""
    from oar_ocr_tpu.vl import exact_models as jem
    from torch_exact_common import make_pair

    argv = ["vlm", "mineru-2.5", *pngs, "--dev-tiny", "--max-new-tokens",
            "5"]
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    _, ref = make_pair("mineru_exact", seed=0)     # the CLI's seed
    monkeypatch.setattr(jem, "exact_from_registry", lambda name, **kw: ref)
    jcli.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(pngs) and got == want
    assert json.loads(got[0])["model"] == "mineru-2.5"


@pytest.mark.parametrize("name", sorted(
    set(EXACT_FACTORIES) | {"mineru-diffusion-v1", "paddleocr-vl-0.9b",
                            "hunyuanocr-1.5"}))
def test_vlm_every_registry_name(name, pngs, capsys, monkeypatch):
    """``vlm NAME --dev-tiny --device cpu`` for every exact family's
    registry name and the PaddleOCR-VL and HunyuanOCR ones: one JSON
    line a page, naming the model. HunyuanOCR's tiny config keeps the
    published special ids, outside its 512-token vocabulary (the JAX
    embedding gives NaN rows, the port's raises; ROADMAP queue 3), so
    its case moves them into the vocabulary, as
    ``test_torch_hunyuan.py`` does."""
    import dataclasses

    from oar_ocr_tpu_torch.vl import hunyuan

    tiny = hunyuan.HunyuanOCRConfig.tiny
    monkeypatch.setattr(hunyuan.HunyuanOCRConfig, "tiny",
                        lambda self: dataclasses.replace(
                            tiny(self), image_start_id=500,
                            image_end_id=501, image_token_id=502))
    cli.main(["vlm", name, *pngs, "--dev-tiny", "--device", "cpu",
              "--max-new-tokens", "3"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["source_path"], x["model"]) for x in lines] == \
        [(p, name) for p in pngs]
    assert all(isinstance(x["text"], str) for x in lines)


def test_default_device_is_the_card(pngs):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(ConfigError):
        cli.main(["recognize", pngs[0]])

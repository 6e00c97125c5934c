"""The port's MinerU two-step helpers (``vl/mineru_layout.py``) against
the JAX package's, and MinerU's and MonkeyOCRv2's entry points on their
``tiny()`` configs (weights as in ``test_torch_vl_families.py``).

The module is a copy of ``oar_ocr_tpu/vl/mineru_layout.py``, and imports
``resize_for_mineru`` from the port's ``vl/doc_parser.py`` as the
original does: the source test below holds both, the rest compares
results on the same inputs.
"""

from pathlib import Path

import numpy as np
import pytest

from oar_ocr_tpu.vl import doc_parser as j_doc
from oar_ocr_tpu.vl import mineru_layout as j_ml
from oar_ocr_tpu_torch.vl import doc_parser
from oar_ocr_tpu_torch.vl import mineru_layout as ml
from test_torch_vl_families import _img, make_pair
from torch_jax_tree import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_source_is_the_original_and_its_import():
    """The port's module is the original, line for line, and the
    ``resize_for_mineru`` it imports from ``vl/doc_parser.py`` is the
    original's function, line for line."""
    ours = (ROOT / "oar_ocr_tpu_torch/vl/mineru_layout.py").read_text()
    ref = (ROOT / "oar_ocr_tpu/vl/mineru_layout.py").read_text()
    assert ours == ref
    assert "    from .doc_parser import resize_for_mineru\n" in ours

    def func(path):
        src = (ROOT / path).read_text()
        return src[src.index("def resize_for_mineru("):src.index(
            "\n\nclass FamilyBackend")]

    assert func("oar_ocr_tpu_torch/vl/doc_parser.py") == func(
        "oar_ocr_tpu/vl/doc_parser.py")


_RAW = ("<|box_start|>10 20 500 80<|box_end|>"
        "<|ref_start|>title<|ref_end|><|rotate_up|>\n"
        "<|box_start|>10 100 990 400<|box_end|>"
        "<|ref_start|>table<|ref_end|><|rotate_right|>\n"
        "garbage line\n"
        "<|box_start|>10 500 990 600<|box_end|>"
        "<|ref_start|>nonsense_type<|ref_end|>\n"
        "<|box_start|>10 700 10 800<|box_end|>"
        "<|ref_start|>text<|ref_end|>\n"
        "<|box_start|>500 400 100 100<|box_end|>"
        "<|ref_start|>equation<|ref_end|>\n"
        "<|box_start|>10 900 1500 950<|box_end|>"
        "<|ref_start|>text<|ref_end|>\n")


def _json(blocks):
    return [b.to_json() for b in blocks]


def test_parse_layout_output_matches():
    got = ml.parse_layout_output(_RAW)
    assert _json(got) == _json(j_ml.parse_layout_output(_RAW))
    assert [b.block_type for b in got] == ["title", "table", "equation"]
    assert (ml.LAYOUT_PROMPT, ml.LAYOUT_IMAGE_SIZE) == \
        (j_ml.LAYOUT_PROMPT, j_ml.LAYOUT_IMAGE_SIZE)
    for t in ("table", "equation", "code", "text"):
        assert ml.prompt_for_block(t) == j_ml.prompt_for_block(t)


@pytest.mark.parametrize("shape,edge", [((100, 200, 3), 28),
                                        ((40, 101, 3), 1),
                                        ((60, 30, 3), 28),
                                        ((7, 900, 3), 28)])
def test_prepare_for_extract_and_resize_match(shape, edge):
    img = np.random.default_rng(shape[0]).integers(0, 255, shape, np.uint8)
    blocks = [ml.ContentBlock("image", (0.0, 0.0, 0.5, 0.5)),
              ml.ContentBlock("table", (0.0, 0.0, 0.5, 1.0), angle=90),
              ml.ContentBlock("text", (0.5, 0.0, 1.0, 1.0)),
              ml.ContentBlock("equation", (0.0, 0.0, 1.0, 0.3), angle=180),
              ml.ContentBlock("text", (0.0, 0.0, 0.5, 1.0))]
    jblocks = [j_ml.ContentBlock(b.block_type, b.bbox, b.angle)
               for b in blocks]
    crops, prompts, idx = ml.prepare_for_extract(img, blocks, edge)
    jcrops, jprompts, jidx = j_ml.prepare_for_extract(img, jblocks, edge)
    assert (prompts, idx) == (jprompts, jidx)
    assert all(np.array_equal(a, b) for a, b in zip(crops, jcrops))
    assert np.array_equal(doc_parser.resize_for_mineru(img, edge),
                          j_doc.resize_for_mineru(img, edge))


class _FakeFamily:
    class cfg:
        tasks = ("ocr",)

    def __init__(self, layout_raw, mod):
        self.layout_raw, self.mod, self.calls = layout_raw, mod, []

    def generate(self, images, task, *, max_new_tokens, prompt=None):
        self.calls.append((images[0].shape, prompt))
        if prompt == self.mod.LAYOUT_PROMPT:
            return [self.layout_raw]
        if prompt == "\nTable Recognition:":
            return ["<fcel>a<fcel>b<nl><fcel>c<ecel><nl>"]
        return ["cell-a cell-b " + "ab" * 30]


def test_run_two_step_matches():
    raw = ("<|box_start|>0 0 500 500<|box_end|>"
           "<|ref_start|>text<|ref_end|>\n"
           "<|box_start|>0 500 1000 1000<|box_end|>"
           "<|ref_start|>table<|ref_end|>\n"
           "<|box_start|>500 0 1000 500<|box_end|>"
           "<|ref_start|>image<|ref_end|>")
    img = np.zeros((200, 200, 3), np.uint8)
    ours, ref = _FakeFamily(raw, ml), _FakeFamily(raw, j_ml)
    got = ml.run_two_step(ours, img, max_new_tokens=8)
    assert _json(got) == _json(j_ml.run_two_step(ref, img, max_new_tokens=8))
    assert ours.calls == ref.calls
    assert ours.calls[0][0][:2] == (ml.LAYOUT_IMAGE_SIZE,) * 2
    assert got[1].content.startswith("<table>") and got[2].content is None


def test_mineru_two_step_and_monkey_match():
    ours, ref = make_pair("mineru")
    img = _img(4, 80, 120)
    got = ours.parse_two_step(img, max_new_tokens=4)
    want = ref.parse_two_step(img, max_new_tokens=4)
    assert _json(got) == _json(want)
    ours, ref = make_pair("monkeyocrv2")
    for task in ("end2end", "table", "formula"):
        assert ours.generate([img], task, max_new_tokens=6) == \
            ref.generate([img], task, max_new_tokens=6)
    res, jres = (m.parse_end2end(img, max_new_tokens=6) for m in (ours, ref))
    assert (res.width, res.height) == (jres.width, jres.height)
    assert len(res.elements) == len(jres.elements)

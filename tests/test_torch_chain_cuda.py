"""The document chain's card paths: K1 at the chain's model inputs, the
classifiers and the UVDoc rectifier on the card against the CPU.

The CPU side of each is held to the JAX package in
``tests/test_torch_classify_rectify.py``; this file imports only the port
(the card's machine has no flax). Every test needs a card and is marked
``cuda``. Weights are seeded and calibrated on the CPU
(``utils/calibrate.calibrated_state_dict``), so both devices run the
same numbers.
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.models.classification import pp_lcnet as cls
from oar_ocr_tpu_torch.models.rectification.uvdoc import UVDocRectifier
from oar_ocr_tpu_torch.models.rectification.uvdoc_exact import UVDocNetExact
from oar_ocr_tpu_torch.ops import normalize
from oar_ocr_tpu_torch.ops.warp import (NormSpec, resize_matrix,
                                        sample_pixels, sample_transform)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.utils.calibrate import (calibrated_state_dict,
                                               tempered_uvdoc)

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU form, and the card "
                    "is held against the CPU")


def _pages(n=4, h=640, w=480):
    rng = np.random.default_rng(3)
    pages = np.full((n, h, w, 3), 255, np.uint8)
    for i in range(n):
        for r in range(8):
            y = 30 + r * 70
            pages[i, y:y + 26, 40:40 + int(rng.integers(100, 400))] = \
                rng.integers(0, 80, 3, dtype=np.uint8)
    return pages


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
# the chain's K1 inputs in chip_smoke.py: 16 pages, one page, and a
# text-line pool of one det batch there (8 pages, ~300 lines)
@pytest.mark.parametrize("shape", [(16, 224, 224), (1, 712, 488),
                                   (308, 80, 160)],
                         ids=["doc_ori", "uvdoc", "line_ori"])
def test_k1_at_chain_inputs(shape, out):
    """K1 on the raw samples of the chain's inputs against its plain
    version: float32 ≤ 1e-6 absolute, bfloat16 ≤ 1 ulp."""
    _need_card()
    n, h, w = shape
    pages = torch.from_numpy(_pages()).cuda()
    mats = torch.from_numpy(np.stack(
        [resize_matrix(640 - i % 64, 480, h, w) for i in range(n)])).cuda()
    x = sample_pixels(pages, mats, torch.arange(n, device="cuda") % 4,
                      out_h=h, out_w=w)
    norm = NormSpec.imagenet_rgb()
    vh = torch.full((n,), h - 3, dtype=torch.int32, device="cuda")
    vw = torch.full((n,), w - 5, dtype=torch.int32, device="cuda")
    dt = getattr(torch, out)
    before = normalize.LAUNCHES_BY_CALLER["test"]
    got = normalize.normalize_masked(x, norm.alpha, norm.beta, valid_h=vh,
                                     valid_w=vw, pad=0.5, out_dtype=dt,
                                     caller="test")
    assert normalize.LAUNCHES_BY_CALLER["test"] == before + 1
    ref = normalize.normalize_ref(x, norm.alpha, norm.beta, valid_h=vh,
                                  valid_w=vw, pad=0.5, out_dtype=dt)
    if dt == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-6
    else:
        ulps = (got.view(torch.int16).int() - ref.view(torch.int16).int())
        assert int(ulps.abs().max()) <= 1


@pytest.fixture(scope="module")
def classifiers():
    _need_card()
    pages = _pages()
    out = {}
    for name, factory in (("doc", cls.doc_orientation_classifier),
                          ("line", cls.textline_orientation_classifier)):
        c = factory(runtime=Runtime("float32", device="cpu"))
        h, w = c.preprocess.crop_h, c.preprocess.crop_w
        mats, idx = c.page_inputs([(640, 480)] * 4)
        v = torch.full((4,), max(h, w), dtype=torch.int32)
        x = sample_transform(torch.from_numpy(pages), torch.from_numpy(mats),
                             torch.from_numpy(idx), v, v, out_h=h, out_w=w,
                             norm=NormSpec.imagenet_rgb())
        out[name] = (factory, calibrated_state_dict(
            c.model, torch.Generator().manual_seed(7), x))
    return out


@pytest.mark.parametrize("name", ["doc", "line"])
def test_classifier_card_matches_cpu(classifiers, name):
    """Probabilities of pages and of quads within 1e-4, float32."""
    _need_card()
    factory, sd = classifiers[name]
    pages = _pages()
    shapes = [(640, 480), (600, 480), (640, 400), (500, 300)]
    quads = [(i % 4, np.array([[30, 30 + 70 * i], [300, 32 + 70 * i],
                               [300, 58 + 70 * i], [30, 56 + 70 * i]],
                              np.float32)) for i in range(8)]
    probs = {}
    for dev in ("cuda", "cpu"):
        c = factory({k: v.clone() for k, v in sd.items()},
                    runtime=Runtime("float32", device=dev, cfg=ONE_DEVICE))
        up = c.runtime.put(pages)
        probs[dev] = (c.probs_pages(up, shapes), c.probs_quads(up, quads))
    for got, want in zip(probs["cuda"], probs["cpu"]):
        assert float(np.abs(got - want).max()) <= 1e-4


def test_uvdoc_card_matches_cpu():
    """UVDoc at full width on the card against the CPU, float32: the
    untempered calibrated net's grid within 1e-4; the rectified page of
    the tempered net (``utils/calibrate.tempered_uvdoc``, as chip_smoke's
    chain runs it) max|Δ| ≤ 1 on at most 0.1% of the pixels."""
    _need_card()
    page = _pages(1, 600, 420)[0]
    mats = resize_matrix(600, 420, 712, 488)[None]
    x = sample_transform(
        torch.from_numpy(page[None]), torch.from_numpy(mats),
        torch.zeros(1, dtype=torch.int64),
        torch.full((1,), 488, dtype=torch.int32),
        torch.full((1,), 712, dtype=torch.int32), out_h=712, out_w=488,
        norm=NormSpec(alpha=(1 / 255.0,) * 3, beta=(0.0,) * 3))
    sd = calibrated_state_dict(UVDocNetExact(32),
                               torch.Generator().manual_seed(3), x)
    grids, out = {}, {}
    for dev in ("cuda", "cpu"):
        rt = Runtime("float32", device=dev, cfg=ONE_DEVICE)
        r = UVDocRectifier({k: v.clone() for k, v in sd.items()}, runtime=rt)
        grids[dev] = r.grid(r.runtime.put(page[None]), mats).cpu()
        out[dev] = UVDocRectifier(tempered_uvdoc(sd), runtime=rt).rectify(
            page)
    assert float((grids["cuda"] - grids["cpu"]).abs().max()) <= 1e-4
    d = np.abs(out["cuda"].astype(np.int16) - out["cpu"].astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3

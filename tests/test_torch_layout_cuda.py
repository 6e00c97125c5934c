"""Layout detection and the structure pipeline on the card, held against
the port on the CPU.

The CPU side is held to the JAX package in ``tests/test_torch_layout.py``
and ``tests/test_torch_structure.py``; this file imports only the port
(the card's machine has no flax). Every test needs a card and is marked
``cuda``. Weights are seeded on the CPU, so both devices run the same
numbers: N(0, 1/fan_in) plus seeded noise, which spreads the scores so
that rounding does not decide a top-k or an NMS, RT-DETR's tempered
(``utils/calibrate.tempered_rtdetr``; a random decoder amplifies
rounding). Gates: K1 float32 ≤ 1e-6 absolute and bfloat16 ≤ 1 ulp
against its plain version; NMS on the same inputs identical; detections
with the same labels, scores within 1e-4 and corners within 1e-4 of the
page side (float32, TF32 off); structure results with the same
elements, texts and markdown.
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
from oar_ocr_tpu_torch.models.detection.picodet_exact import PicoDetExact
from oar_ocr_tpu_torch.models.detection.rtdetr import RTDETRExact
from oar_ocr_tpu_torch.models.layers import init_state_dict
from oar_ocr_tpu_torch.ops import nms, normalize
from oar_ocr_tpu_torch.ops.warp import resize_matrix, sample_pixels
from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
from oar_ocr_tpu_torch.pipelines.structure import (OARStructure,
                                                   OARStructureConfig)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.utils.calibrate import tempered_rtdetr

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

pytestmark = pytest.mark.cuda

RT_KW = dict(arch="T", hidden_dim=64, num_queries=32, num_decoder_layers=2,
             nhead=8, dim_feedforward=128)
PICO_KW = dict(scale=0.5, neck_feat=64, head_convs=2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU form, and the card "
                    "is held against the CPU")


def _noisy(model, seed, scale):
    """Seeded random weights plus seeded noise; BatchNorm variances kept
    in [0.75, 1.25]."""
    gen = torch.Generator().manual_seed(seed)
    sd = init_state_dict(model, gen)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=gen) * 0.5 + 0.75
        else:
            sd[k] = v + torch.randn(v.shape, generator=gen) * scale
    return sd


def _pages(n=2, h=320, w=480):
    rng = np.random.default_rng(3)
    pages = np.full((n, h, w, 3), 255, np.uint8)
    for i in range(n):
        for r in range(4):
            y = 30 + r * 70
            pages[i, y:y + 26, 40:40 + int(rng.integers(100, 400))] = \
                rng.integers(0, 80, 3, dtype=np.uint8)
    return pages


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(800, 800), (640, 640)],
                         ids=["rtdetr_l", "picodet_l"])
def test_k1_at_layout_inputs(hw, out):
    """K1 at the layout inputs (4 pages to 800×800 and to 640×640, x/255
    with the R/B swap of the BGR variants) against its plain version."""
    _need_card()
    h, w = hw
    pages = torch.from_numpy(_pages(4, 1280, 960)).cuda()
    mats = torch.from_numpy(np.stack([resize_matrix(1280, 960, h, w)] * 4)
                            ).cuda()
    x = sample_pixels(pages, mats, torch.arange(4, device="cuda"),
                      out_h=h, out_w=w)
    a, b = (1 / 255.0,) * 3, (0.0,) * 3
    v = torch.full((4,), h, dtype=torch.int32, device="cuda")
    dt = getattr(torch, out)
    before = normalize.LAUNCHES_BY_CALLER["layout"]
    got = normalize.normalize_masked(x, a, b, valid_h=v, valid_w=v, pad=0.0,
                                     swap_rb=True, out_dtype=dt,
                                     caller="layout")
    assert normalize.LAUNCHES_BY_CALLER["layout"] == before + 1
    ref = normalize.normalize_ref(x, a, b, valid_h=v, valid_w=v, pad=0.0,
                                  swap_rb=True, out_dtype=dt)
    if dt == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-6
    else:
        ulps = (got.view(torch.int16).int() - ref.view(torch.int16).int())
        assert int(ulps.abs().max()) <= 1


def test_nms_card_matches_cpu():
    """``topk_candidates`` and ``nms_fixed`` on a batch of 4 pages of 2000
    candidate anchors × 5 classes: identical on the card and the CPU."""
    _need_card()
    gen = torch.Generator().manual_seed(5)
    xy = torch.rand((4, 2000, 2), generator=gen) * 600
    boxes = torch.cat([xy, xy + torch.rand((4, 2000, 2), generator=gen)
                       * 120 + 4], -1)
    scores = torch.rand((4, 2000, 5), generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        cand = nms.topk_candidates(scores.to(dev), boxes.to(dev), k=400)
        out[dev] = nms.nms_fixed(*cand, iou_thresh=0.6, score_thresh=0.5,
                                 max_det=100)
    for g, c in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g.cpu(), c)
    assert int(out["cpu"][3].sum()) > 0


def _same_boxes(got, want, side):
    """Per page the same count, and each CPU box matched by an unused card
    box of its label, scores within 1e-4 and corners within 1e-4 of the
    page side (order is free among scores closer than the gate)."""
    assert [len(p) for p in got] == [len(p) for p in want]
    for gp, wp in zip(got, want):
        free = list(range(len(gp)))
        for w in wp:
            hit = next((i for i in free if gp[i].label == w.label
                        and abs(gp[i].score - w.score) <= 1e-4
                        and float(np.abs(gp[i].box - w.box).max())
                        <= 1e-4 * side), None)
            assert hit is not None, (w.label, w.score, w.box)
            free.remove(hit)


@pytest.mark.parametrize("which", ["picodet", "rtdetr"])
def test_detect_card_matches_cpu(which):
    """``LayoutDetector.detect`` at the tests' sizes on the card and on
    the CPU, float32, and K1 counted under the caller ``layout``."""
    _need_card()
    variant, model, kw, thr = (
        ("pp-doclayout-s", PicoDetExact(23, **PICO_KW), PICO_KW, 0.6)
        if which == "picodet" else
        ("pp-doclayout_plus-l", RTDETRExact(20, **RT_KW), RT_KW, 0.6))
    sd = _noisy(model, 11, 0.15)
    if which == "rtdetr":
        sd = tempered_rtdetr(sd)
    pages = _pages()
    shapes = [(320, 480), (300, 400)]
    res = {}
    for dev in ("cuda", "cpu"):
        det = LayoutDetector(variant, {k: v.clone() for k, v in sd.items()},
                             score_thresh=thr, net_overrides=kw,
                             runtime=Runtime("float32", device=dev,
                                             cfg=ONE_DEVICE))
        before = normalize.LAUNCHES_BY_CALLER["layout"]
        res[dev] = det.detect(det.runtime.put(pages), shapes)
        if dev == "cuda":
            assert normalize.LAUNCHES_BY_CALLER["layout"] == before + 1
    assert sum(len(p) for p in res["cpu"]) > 0
    _same_boxes(res["cuda"], res["cpu"], max(pages.shape[1:3]))


def test_structure_card_matches_cpu():
    """``OARStructure`` (PicoDet-S layout at the tests' size, the general
    OCR and the seal OCR on seeded weights) on the card and on the CPU,
    float32: the same elements, texts and markdown."""
    _need_card()
    layout_sd = _noisy(PicoDetExact(23, **PICO_KW), 12, 0.15)
    results = {}
    for dev in ("cuda", "cpu"):
        rt = Runtime("float32", device=dev, cfg=ONE_DEVICE)
        layout = LayoutDetector("pp-doclayout-s", dict(layout_sd),
                                score_thresh=0.6, net_overrides=PICO_KW,
                                runtime=rt)
        ocr = (OAROCRBuilder("general").with_runtime(rt)
               .with_batch_sizes(image=2, region=64).build())
        seal = (OAROCRBuilder("seal").with_runtime(rt)
                .with_det_config(limit_side_len=320)
                .with_batch_sizes(image=2, region=64).build())
        pipe = OARStructure(layout=layout, ocr=ocr, seal_ocr=seal,
                            cfg=OARStructureConfig(use_tables=False,
                                                   use_formulas=False,
                                                   image_batch_size=2),
                            runtime=rt)
        results[dev] = pipe.predict(list(_pages()))
    n = 0
    for g, w in zip(results["cuda"], results["cpu"]):
        assert len(g.elements) == len(w.elements)
        for a, b in zip(g.elements, w.elements):
            assert (a.label, a.order_index, a.text) == \
                (b.label, b.order_index, b.text)
            assert float(np.abs(np.asarray(a.box) - np.asarray(b.box))
                         .max()) <= 1e-2
            n += 1
        assert g.to_markdown() == w.to_markdown()
    assert n > 0

"""The port's layout detection against the JAX package on the CPU.

Weights: the JAX model's ``init_params_fast`` leaves plus seeded numpy
noise (BatchNorm variances drawn in [0.75, 1.25]), carried to the port by
``runtime/weights.params_from_jax``; inputs from numpy seeds. Models at
the tests' sizes: RT-DETR at the "T" arch (two decoder layers, hidden 64,
8 heads, FFN 128, 32 queries, as ``test_rtdetr_parity.py``), PicoDet at
LCNet scale 0.5, CSP-PAN 64, two head convs (as
``test_picodet_parity.py``); one of each per module.

Tolerances:

- NMS, top-k and ``rtdetr_postprocess`` on the same inputs: identical
  outputs (the same comparisons on the same float32 numbers; the JAX
  order among equal values, lower index first, on purpose tested with
  exact ties);
- float32 models: backbone features, logits, scores and boxes within
  1e-4 of max|ref| (the two frameworks sum convolutions and products in
  other orders; the readings were ≤ 1.3e-6 of max|ref|);
- ``LayoutDetector.detect`` in float32: the same number of boxes per
  page, each JAX box matched by a port box of the same label, score
  within 1e-5 and corners within 1e-3 px (order is free only among
  scores closer than 1e-5);
- bfloat16 (both packages under a bfloat16 runtime): the same dtypes at
  every stage, backbone and neck maps within 2^-4·max|ref| (bfloat16
  keeps 8 significant bits and the two frameworks round at other points,
  the BatchNorm folded into the convolution here, applied after it
  there; the readings were 0.7-1.9 % of max|ref|), RT-DETR's selected
  query logits (sorted, a set) within 2^-4·max|ref|; PicoDet's decoded
  scores within 2e-3 and boxes within 2^-4·max|ref|; ``detect``'s
  bfloat16 input tile within one bfloat16 rounding of the JAX package's
  (2^-7·|ref| + 1e-6)
  and its model outputs on that tile as above (``detect``'s boxes are
  not compared end to end in bfloat16: see the test).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.models.detection import rtdetr as jrt
from oar_ocr_tpu.models.detection.layout import LayoutDetector as JLayout
from oar_ocr_tpu.models.detection.picodet_exact import \
    PicoDetExact as JPicoDet
from oar_ocr_tpu.ops import nms as jnms
from oar_ocr_tpu.ops import warp as jwarp
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import flatten_params, unflatten_params
from oar_ocr_tpu_torch.models.detection import rtdetr
from oar_ocr_tpu_torch.models.detection.layout import LayoutDetector
from oar_ocr_tpu_torch.models.detection.picodet_exact import PicoDetExact
from oar_ocr_tpu_torch.models.layers import load_weights
from oar_ocr_tpu_torch.ops import nms, warp
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax

CPU = dict(device="cpu")
RT_KW = dict(arch="T", hidden_dim=64, num_queries=32, num_decoder_layers=2,
             nhead=8, dim_feedforward=128)
PICO_KW = dict(scale=0.5, neck_feat=64, head_convs=2)
BF16_REL = 2.0 ** -4


def perturbed(flat, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.random(np.shape(v)) * 0.5 + 0.75).astype(np.float32)
            if k.endswith("/var") else
            (np.asarray(v, np.float32) + rng.normal(0, scale, np.shape(v))
             ).astype(np.float32) for k, v in sorted(flat.items())}


def jrt_runtime(dtype):
    return JRuntime(JRuntimeConfig(compute_dtype=dtype, use_mesh=False))


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def rt_pair():
    module = jrt.RTDETRExact(num_classes=7, **RT_KW)
    flat = perturbed(flatten_params(init_params_fast(
        module, (1, 128, 128, 3))), 21, 0.05)
    return module, flat


@pytest.fixture(scope="module")
def pico_pair():
    module = JPicoDet(num_classes=5, **PICO_KW)
    flat = perturbed(flatten_params(init_params_fast(
        module, (1, 128, 96, 3))), 22, 0.05)
    return module, flat


def _port_rt(flat, dtype=torch.float32):
    return load_weights(rtdetr.RTDETRExact(7, **RT_KW), params_from_jax(flat),
                        dtype=dtype)


def _port_pico(flat, dtype=torch.float32):
    return load_weights(PicoDetExact(5, **PICO_KW), params_from_jax(flat),
                        dtype=dtype)


# ------------------------------- NMS -------------------------------

def _candidates(seed, k=48, classes=3):
    """Boxes in clusters (so they overlap across and within classes),
    scores on a grid of 7 values (so many tie exactly)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 200, (6, 2))
    c = centers[rng.integers(0, 6, k)] + rng.normal(0, 6, (k, 2))
    wh = rng.uniform(10, 50, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.choice(np.linspace(0.05, 0.95, 7), k).astype(np.float32)
    labels = rng.integers(0, classes, k).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches(seed):
    """iou_matrix, nms_fixed (one page and a batch of pages) and
    topk_candidates: identical outputs, ties and cross-class overlaps
    included."""
    boxes, scores, labels = _candidates(seed)
    assert len(np.unique(scores)) < len(scores)          # ties exist
    np.testing.assert_array_equal(
        nms.iou_matrix(torch.from_numpy(boxes)).numpy(),
        np.asarray(jnms.iou_matrix(jnp.asarray(boxes))))
    kw = dict(iou_thresh=0.3, score_thresh=0.2, max_det=40)
    batch = [(boxes, scores, labels), _candidates(seed + 10)]
    got = nms.nms_fixed(*(torch.from_numpy(np.stack(a)) for a in
                          zip(*batch)), **kw)
    for i, page in enumerate(batch):
        ref = jnms.nms_fixed(*(jnp.asarray(a) for a in page), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))
    valid = np.asarray(got[3][0])
    assert 0 < valid.sum() < 40 and not valid[valid.sum():].any()
    assert (got[1][0].numpy()[~valid] == -1).all()
    assert (got[2][0].numpy()[~valid] == -1).all()

    rng = np.random.default_rng(seed)
    cls = rng.choice(np.linspace(0, 1, 5), (40, 4)).astype(np.float32)
    got = nms.topk_candidates(torch.from_numpy(cls),
                              torch.from_numpy(boxes[:40]), k=30)
    ref = jnms.topk_candidates(jnp.asarray(cls), jnp.asarray(boxes[:40]),
                               k=30)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_topk_ties_lower_index_first():
    """``topk_stable`` orders equal values by index, as ``lax.top_k``."""
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    vals, idx = nms.topk_stable(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    assert idx.tolist() == [[1, 3, 0, 2]] == np.asarray(ji).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ------------------------------- RT-DETR -------------------------------

@pytest.mark.parametrize("which", ["rtdetr", "picodet"])
def test_strict_conversion(which, rt_pair, pico_pair):
    """Every JAX parameter maps onto a port tensor of the same size and
    none is left over (``denoising_class_embed.weight``, the unused score
    heads and ``FusedMHA``'s (d, 3d) ``in_proj_weight`` included)."""
    module, flat = rt_pair if which == "rtdetr" else pico_pair
    port = (rtdetr.RTDETRExact(7, **RT_KW) if which == "rtdetr"
            else PicoDetExact(5, **PICO_KW))
    sd = params_from_jax(flat)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    if which == "rtdetr":
        assert sd["transformer.denoising_class_embed.weight"].shape == (8, 64)
        np.testing.assert_array_equal(
            sd["neck.encoder.0.layers.0.self_attn.in_proj_weight"].numpy(),
            flat["params/neck/encoder.0.layers.0/self_attn/in_proj_weight"])


def test_rtdetr_helpers_match():
    """The host anchors and position embedding, the inverse sigmoid and
    the bilinear gather against the JAX functions."""
    shapes = [(16, 16), (8, 8), (4, 4)]
    a, v = rtdetr.generate_anchors(shapes)
    ja, jv = jrt.generate_anchors(shapes)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(rtdetr.sincos_pos_embed_2d(5, 3, 16),
                                  jrt.sincos_pos_embed_2d(5, 3, 16))
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-0.1, 1.1, 50), [0.0, 1.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(
        rtdetr._inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jrt._inverse_sigmoid(jnp.asarray(x))), rtol=1e-6)
    value = rng.normal(size=(2, 3, 6 * 5, 4)).astype(np.float32)
    gx = rng.uniform(-2, 7, (2, 3, 20)).astype(np.float32)
    gy = rng.uniform(-2, 8, (2, 3, 20)).astype(np.float32)
    np.testing.assert_allclose(
        rtdetr._bilinear_gather(torch.from_numpy(value),
                                torch.from_numpy(gx), torch.from_numpy(gy),
                                6, 5).numpy(),
        np.asarray(jrt._bilinear_gather(jnp.asarray(value), jnp.asarray(gx),
                                        jnp.asarray(gy), 6, 5)),
        atol=1e-6)


def test_rtdetr_matches(rt_pair):
    """Backbone features, logits and boxes within 1e-4 of max|ref|; the
    postprocess on the same logits and boxes identical."""
    module, flat = rt_pair
    tree = unflatten_params(flat)
    port = _port_rt(flat)
    x = np.random.default_rng(0).normal(size=(2, 128, 128, 3)
                                        ).astype(np.float32)
    sub = {c: v["backbone"] for c, v in tree.items()}
    ref_feats = jax.jit(jrt.PPHGNetV2Det(arch="T").apply)(sub,
                                                          jnp.asarray(x))
    with torch.no_grad():
        feats = port.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        logits, boxes = port(torch.from_numpy(x))
    for got, ref in zip(feats, ref_feats):
        assert rel_err(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-4
    ref_logits, ref_boxes = jax.jit(module.apply)(tree, jnp.asarray(x))
    assert logits.dtype == boxes.dtype == torch.float32
    assert rel_err(logits.numpy(), ref_logits) <= 1e-4
    assert rel_err(boxes.numpy(), ref_boxes) <= 1e-4

    got = rtdetr.rtdetr_postprocess(torch.from_numpy(np.array(ref_logits)),
                                    torch.from_numpy(np.array(ref_boxes)),
                                    num_top=20)
    ref = jrt.rtdetr_postprocess(ref_logits, ref_boxes, num_top=20)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_picodet_matches(pico_pair):
    """Scores and boxes within 1e-4 of max|ref|, float32."""
    module, flat = pico_pair
    port = _port_pico(flat)
    x = np.random.default_rng(1).normal(size=(2, 128, 96, 3)
                                        ).astype(np.float32)
    scores, boxes = jax.jit(module.apply)(unflatten_params(flat),
                                          jnp.asarray(x))
    with torch.no_grad():
        got_s, got_b = port(torch.from_numpy(x))
    assert got_s.dtype == got_b.dtype == torch.float32
    assert rel_err(got_s.numpy(), scores) <= 1e-4
    assert rel_err(got_b.numpy(), boxes) <= 1e-4


# --------------------------- LayoutDetector ---------------------------

def _pages():
    rng = np.random.default_rng(5)
    pages = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    pages[:, 40:90, 30:220] = 20
    return pages, [(256, 256), (200, 240)]


def _box_iou(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def assert_same_boxes(got, ref, *, score_tol=None, box_tol=None,
                      min_iou=None):
    """Per page: the same count, and each JAX box matched, in order, by
    an unused port box of the same label within the tolerances."""
    assert [len(p) for p in got] == [len(p) for p in ref]
    for g_page, r_page in zip(got, ref):
        free = list(range(len(g_page)))
        for r in r_page:
            def ok(g):
                if g.label != r.label:
                    return False
                if min_iou is not None:
                    return _box_iou(g.box, r.box) >= min_iou
                return (abs(g.score - r.score) <= score_tol and
                        float(np.abs(g.box - r.box).max()) <= box_tol)
            hit = next((i for i in free if ok(g_page[i])), None)
            assert hit is not None, (r.label, r.score, r.box)
            free.remove(hit)


VARIANTS = {
    # (variant, net overrides, score threshold, weight noise)
    "picodet": ("picodet-s_layout_3cls", PICO_KW, 0.6, 0.2),
    "rtdetr": ("pp-doclayout_plus-l", RT_KW, 0.7, 0.15),
}


@pytest.fixture(scope="module")
def detectors():
    """One JAX detector's parameters per variant, perturbed."""
    out = {}
    for key, (variant, ov, thr, noise) in VARIANTS.items():
        j = JLayout(variant, score_thresh=thr, runtime=jrt_runtime("float32"),
                    net_overrides=ov)
        flat = flatten_params(jax.tree.map(np.asarray, j.params))
        out[key] = perturbed(flat, 30, noise)
    return out


@pytest.mark.parametrize("key", ["picodet", "rtdetr"])
def test_detect_matches(key, detectors):
    """``LayoutDetector.detect`` on two pages (256×256 and 200×240 in a
    256×256 upload): the same boxes, labels and scores, float32."""
    variant, ov, thr, _ = VARIANTS[key]
    flat = detectors[key]
    pages, shapes = _pages()
    j = JLayout(variant, unflatten_params(flat), score_thresh=thr,
                runtime=jrt_runtime("float32"), net_overrides=ov)
    t = LayoutDetector(variant, params_from_jax(flat), score_thresh=thr,
                       runtime=Runtime("float32", **CPU), net_overrides=ov)
    ref = j.detect(jnp.asarray(pages), shapes)
    got = t.detect(torch.from_numpy(pages), shapes, page_indices=[0, 1])
    assert all(len(p) > 0 for p in ref)
    assert_same_boxes(got, ref, score_tol=1e-5, box_tol=1e-3)
    # one page alone, at its index in the upload
    got1 = t.detect(torch.from_numpy(pages), shapes[1:], page_indices=[1])
    assert_same_boxes(got1, ref[1:], score_tol=1e-5, box_tol=1e-3)


# ------------------------------ bfloat16 ------------------------------

def test_rtdetr_bf16_matches(rt_pair):
    """Under bfloat16: the backbone and neck maps in bfloat16 within
    2^-4·max|ref|, the logits and boxes float32 and finite, and the
    selected queries' encoder logits (sorted by their largest class
    logit) within 2^-4·max|ref|."""
    module, flat = rt_pair
    tree = unflatten_params(flat)
    port = _port_rt(flat, torch.bfloat16)
    x = np.random.default_rng(2).normal(size=(2, 128, 128, 3)
                                        ).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    sub = lambda name: {c: v[name] for c, v in tree.items()}  # noqa: E731
    ref_feats = jax.jit(jrt.PPHGNetV2Det(arch="T").apply)(sub("backbone"),
                                                          xb)
    ref_neck = jax.jit(jrt.HybridEncoder(
        hidden_dim=64, nhead=8, dim_feedforward=128).apply)(sub("neck"),
                                                           ref_feats)
    ref_out = jax.jit(jrt.RTDETRTransformer(
        num_classes=7, hidden_dim=64, num_queries=32, nhead=8,
        dim_feedforward=128, num_decoder_layers=2).apply)(
            sub("transformer"), ref_neck)
    with torch.no_grad():
        feats = port.backbone(torch.from_numpy(x).bfloat16()
                              .permute(0, 3, 1, 2))
        neck = port.neck(feats)
        out = port.transformer(neck)
    for got, ref in zip(list(feats) + list(neck),
                        list(ref_feats) + list(ref_neck)):
        assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
        assert rel_err(got.float().permute(0, 2, 3, 1).numpy(),
                       ref.astype(jnp.float32)) <= BF16_REL
    logits, boxes, enc = out
    assert logits.dtype == boxes.dtype == torch.float32
    assert [str(a.dtype) for a in ref_out] == ["float32", "float32",
                                               "bfloat16"]
    assert enc.dtype == torch.bfloat16
    assert torch.isfinite(logits).all() and torch.isfinite(boxes).all()
    ref_enc = np.sort(np.asarray(ref_out[2].astype(jnp.float32)).max(-1), -1)
    got_enc = np.sort(enc.float().numpy().max(-1), -1)
    assert rel_err(got_enc, ref_enc) <= BF16_REL


def test_picodet_bf16_matches(pico_pair):
    """Under bfloat16: float32 scores within 2e-3 and boxes within
    2^-4·max|ref| of the JAX package's bfloat16 model."""
    module, flat = pico_pair
    port = _port_pico(flat, torch.bfloat16)
    x = np.random.default_rng(3).normal(size=(2, 128, 96, 3)
                                        ).astype(np.float32)
    scores, boxes = jax.jit(module.apply)(unflatten_params(flat),
                                          jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got_s, got_b = port(torch.from_numpy(x).bfloat16())
    assert got_s.dtype == got_b.dtype == torch.float32
    assert str(scores.dtype) == str(boxes.dtype) == "float32"
    assert float(np.abs(got_s.numpy() - np.asarray(scores)).max()) <= 2e-3
    assert rel_err(got_b.numpy(), boxes) <= BF16_REL


@pytest.mark.parametrize("key", ["picodet", "rtdetr"])
def test_detect_bf16_matches(key, detectors):
    """``detect`` under bfloat16, stage by stage: the input tile in
    bfloat16 within one rounding of the JAX package's (|Δ| ≤
    2^-7·|ref| + 1e-6: the same float32 gather and normalize up to
    float32 rounding, then one cast), the weights in bfloat16, the model's
    float32 outputs on the JAX package's own tile (PicoDet: scores and
    boxes within 2^-4 and 2^-4·max|ref|; these weights are 4x noisier than
    ``test_picodet_bf16_matches``'s, and the readings were 2.0e-2 on the
    scores; RT-DETR: float32 and finite, its
    bfloat16 query selection is held in ``test_rtdetr_bf16_matches``),
    and the same box count per page. End to end the boxes are not gated:
    a random network's bfloat16 rounding moves near-tied selections, and
    the JAX package's own bfloat16 boxes match its float32 boxes at a mean
    best IoU of 0.85 on these pages, as the port's bfloat16 boxes match
    the JAX package's at 0.82-0.85."""
    variant, ov, thr, _ = VARIANTS[key]
    flat = detectors[key]
    pages, shapes = _pages()
    j = JLayout(variant, unflatten_params(flat), score_thresh=thr,
                runtime=jrt_runtime("bfloat16"), net_overrides=ov)
    t = LayoutDetector(variant, params_from_jax(flat), score_thresh=thr,
                       runtime=Runtime("bfloat16", **CPU), net_overrides=ov)
    assert next(t.model.parameters()).dtype == torch.bfloat16
    ih, iw = t.variant.input_hw
    mats = np.stack([jwarp.resize_matrix(h, w, ih, iw) for h, w in shapes])
    full = lambda v: jnp.full((2,), v, jnp.int32)   # noqa: E731
    jx = jwarp.sample_transform(
        jnp.asarray(pages), jnp.asarray(mats), jnp.arange(2, dtype=jnp.int32),
        full(iw), full(ih), out_h=ih, out_w=iw,
        norm=j._norm, out_dtype=jnp.bfloat16)
    tfull = lambda v: torch.full((2,), v, dtype=torch.int32)  # noqa: E731
    tx = warp.sample_transform(
        torch.from_numpy(pages), torch.from_numpy(mats), torch.arange(2),
        tfull(iw), tfull(ih), out_h=ih, out_w=iw, norm=t._norm,
        out_dtype=torch.bfloat16, caller="layout")
    assert tx.dtype == torch.bfloat16 and str(jx.dtype) == "bfloat16"
    ref_x = np.asarray(jx.astype(jnp.float32))
    err = np.abs(tx.float().numpy() - ref_x)
    assert (err <= 2.0 ** -7 * np.abs(ref_x) + 1e-6).all()
    ref = jax.jit(j.model.apply)(j.params, jx)
    with torch.no_grad():
        got = t.model(torch.from_numpy(np.array(jx.astype(jnp.float32)))
                      .bfloat16())
    assert [g.dtype for g in got] == [torch.float32, torch.float32]
    assert [str(r.dtype) for r in ref] == ["float32", "float32"]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    if key == "picodet":
        assert float(np.abs(got[0].numpy() - np.asarray(ref[0])).max()) \
            <= BF16_REL
        assert rel_err(got[1].numpy(), ref[1]) <= BF16_REL
    assert [len(p) for p in t.detect(torch.from_numpy(pages), shapes)] == \
        [len(p) for p in j.detect(jnp.asarray(pages), shapes)]


def test_tempered_rtdetr_scales_only_its_layers():
    """``utils/calibrate.tempered_rtdetr`` (the card run's random RT-DETR)
    scales the box heads' last layers and the decoder layers' residual
    branches by 0.1 and leaves every other tensor as it was."""
    from oar_ocr_tpu_torch.utils.calibrate import tempered_rtdetr

    sd = {k: torch.ones_like(v) for k, v in
          rtdetr.RTDETRExact(7, **RT_KW).state_dict().items()}
    out = tempered_rtdetr(sd)
    scaled = {k for k in sd if not torch.equal(out[k], sd[k])}
    want = {k for k in sd if k.startswith("transformer.enc_bbox_head."
                                          "layers.2.")
            or (k.startswith("transformer.dec_bbox_head.")
                and ".layers.2." in k)
            or (k.startswith("transformer.decoder.layers.")
                and (".self_attn.out_proj." in k
                     or ".cross_attn.output_proj." in k
                     or ".linear2." in k))}
    assert scaled == want and len(want) == 2 * 2 + 2 * 2 * 3 + 2
    assert all(torch.allclose(out[k], torch.full_like(sd[k], 0.1))
               for k in want)

"""The port's document chain against the JAX package on the CPU: the
classifiers (PP-LCNet v1 and the LCNet trunk classifier), their
preprocess matrices and ``sample_transform`` input, the UVDoc net, the
grid sampler and the rectifier, the ``DocumentPreprocessor``, the
bfloat16 dtype policy, and ``OAROCR`` with document orientation,
text-line orientation, word boxes and rectification.

The same weights go into both packages: JAX parameters (``init_params_fast``
plus seeded noise, or a JAX pipeline's own) through ``params_from_jax``.
Inputs are seeded numpy arrays. Tolerances: logits 1e-4 relative to
max|logit|, probabilities and scores 1e-5, the UVDoc grid 1e-5, sampled
tiles 1e-5 (float32) or one bfloat16 rounding (bfloat16 out), slanted
samples and their scores 1e-4 (XLA computes their coordinates with fused
multiply-adds, which round otherwise at sharp edges); rectified
uint8 pages max|Δ| ≤ 1 on at most 0.1% of pixels (a float32 summation
order that differs moves a pixel that sits at .5 by one); bfloat16
against the JAX package under ``compute_dtype="bfloat16"``: dtypes equal,
probabilities within 2e-2, the grid within 2e-2.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oar_ocr_tpu.config.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.models.classification import pp_lcnet as jcls
from oar_ocr_tpu.models.classification.pp_lcnet_exact import \
    PPLCNetV1Cls as JPPLCNetV1Cls
from oar_ocr_tpu.models.rectification import uvdoc as juvdoc
from oar_ocr_tpu.models.rectification.uvdoc_exact import \
    UVDocNetExact as JUVDocNetExact
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer
from oar_ocr_tpu.ops import grid_sample as jgrid
from oar_ocr_tpu.ops import warp as jwarp
from oar_ocr_tpu.ops.ctc import default_charset
from oar_ocr_tpu.pipelines import preprocess as jpre
from oar_ocr_tpu.pipelines.ocr import OAROCR as JOAROCR
from oar_ocr_tpu.pipelines.ocr import OAROCRBuilder as JBuilder
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import flatten_params, load_params
from oar_ocr_tpu_torch.models.classification import pp_lcnet as cls
from oar_ocr_tpu_torch.models.classification.pp_lcnet_exact import \
    PPLCNetV1Cls
from oar_ocr_tpu_torch.models.layers import load_weights
from oar_ocr_tpu_torch.models.rectification import uvdoc
from oar_ocr_tpu_torch.models.rectification.uvdoc_exact import UVDocNetExact
from oar_ocr_tpu_torch.ops import grid_sample, warp
from oar_ocr_tpu_torch.pipelines import preprocess
from oar_ocr_tpu_torch.pipelines.ocr import OAROCR, OAROCRBuilder
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import (params_from_jax,
                                               read_safetensors, torch_name)
from oar_ocr_tpu_torch.utils.calibrate import calibrated_state_dict
from oar_ocr_tpu_torch.utils.parity import compare_results

BENCH_DET = Path(__file__).resolve().parents[1] / "assets" / \
    "bench_det.safetensors"
CPU = dict(device="cpu")


def jrt(dtype="float32"):
    return JRuntime(JRuntimeConfig(compute_dtype=dtype, use_mesh=False))


def perturbed(module, shape, seed):
    """JAX ``init_params_fast``, then seeded noise on every leaf (BatchNorm
    variances kept positive), as ``test_torch_models.py`` does."""
    flat = flatten_params(init_params_fast(module, shape))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(flat.items()):
        v = np.asarray(v, np.float32)
        if k.endswith("/var"):
            out[k] = (rng.random(v.shape) * 0.5 + 0.75).astype(np.float32)
        else:
            out[k] = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    return out


def lecun(module, shape, seed, grid_gain=1.0):
    """Shape-only JAX init with lecun-normal kernels (flax's default, but
    without running the model eagerly): BatchNorm at identity, biases 0.
    ``grid_gain`` scales UVDoc's grid projection so the random grid spans
    the page (otherwise every output pixel samples the page's centre)."""
    flat = flatten_params(init_params_fast(module, shape))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k.endswith("/kernel"):
            v = rng.normal(0, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            if "out_point_positions2D/proj" in k:
                v = v * grid_gain
        elif k.endswith("/var") or k.endswith("/scale"):
            v = np.ones_like(v)
        else:
            v = np.zeros_like(v)
        out[k] = v.astype(np.float32)
    return out


def jax_flat(module, shape, state_dict):
    """The JAX flat parameters of ``module`` holding a port state_dict's
    values: the inverse of ``params_from_jax`` (OIHW → HWIO, (out, in) →
    (in, out)), key by key through ``torch_name``."""
    out = {}
    for k, v in flatten_params(init_params_fast(module, shape)).items():
        t = state_dict[torch_name(k)].numpy()
        if k.endswith("/kernel") and t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)
        elif k.endswith("/kernel") and t.ndim == 2:
            t = t.T
        assert t.shape == np.shape(v), k
        out[k] = np.ascontiguousarray(t, np.float32)
    return out


def calibrated(port_factory, jax_module, pages, seed):
    """Seeded port weights with calibrated BatchNorm statistics
    (``utils/calibrate.calibrated_state_dict``: random N(0, 1/fan_in) weights
    alone give exactly uniform probabilities) for a classifier made by
    ``port_factory``, and the same weights as JAX flat parameters."""
    c = port_factory(runtime=Runtime("float32", **CPU))
    hw = (c.preprocess.crop_h, c.preprocess.crop_w)
    mats, idx = c.page_inputs([p.shape[:2] for p in pages])
    full = torch.full((len(pages),), max(hw), dtype=torch.int32)
    x = warp.sample_transform(
        torch.from_numpy(np.stack(pages)), torch.from_numpy(mats),
        torch.from_numpy(idx), full, full, out_h=hw[0], out_w=hw[1],
        norm=warp.NormSpec.imagenet_rgb())
    sd = calibrated_state_dict(c.model, torch.Generator().manual_seed(seed),
                               x)
    return sd, jax_flat(jax_module, (1, *hw, 3), sd)


def unflatten(flat):
    from oar_ocr_tpu.runtime.weights import unflatten_params

    return unflatten_params(flat)


def _page(rng, h, w):
    """A white page with dark blocks of text-like rows."""
    img = np.full((h, w, 3), 255, np.uint8)
    for r in range(max(2, h // 60)):
        y = 20 + r * 50
        x0 = int(rng.integers(10, 40))
        img[y:y + 24, x0:x0 + int(rng.integers(w // 3, w - 60))] = \
            rng.integers(0, 90, 3, dtype=np.uint8)
    return img


# ----------------------------- preprocess -----------------------------

@pytest.mark.parametrize("hw", [(1280, 960), (320, 480), (37, 901),
                                (224, 224)])
def test_preprocess_matrices_match(hw):
    h, w = hw
    np.testing.assert_array_equal(
        cls.ClassifierPreprocess().matrix(h, w),
        jcls.ClassifierPreprocess().matrix(h, w))
    np.testing.assert_array_equal(
        cls.DirectResizePreprocess(80, 160).matrix(h, w),
        jcls.DirectResizePreprocess(80, 160).matrix(h, w))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["imagenet_rgb", "uvdoc", "rec_bgr"])
def test_sample_transform_matches(norm, out_dtype):
    """The gather, then K1's plain version: swap, x·alpha + beta, the
    valid mask with its pad, the cast."""
    rng = np.random.default_rng(3)
    pages = np.stack([_page(rng, 96, 128), _page(rng, 96, 128)])
    pages[..., 1] = rng.integers(0, 256, pages.shape[:3])
    mats = np.stack([cls.ClassifierPreprocess(64, 40, 56).matrix(90, 120),
                     cls.DirectResizePreprocess(40, 56).matrix(70, 128)])
    mats[1, 0, 1] = 0.3                           # a slanted sample
    idx = np.array([1, 0], np.int32)
    vw, vh = np.array([56, 31], np.int32), np.array([40, 22], np.int32)
    spec = {"imagenet_rgb": "imagenet_rgb", "rec_bgr": "rec_bgr",
            "uvdoc": None}[norm]
    jnorm = (getattr(jwarp.NormSpec, spec)() if spec else
             jwarp.NormSpec(alpha=(1 / 255.0,) * 3, beta=(0.0,) * 3))
    tnorm = (getattr(warp.NormSpec, spec)() if spec else
             warp.NormSpec(alpha=(1 / 255.0,) * 3, beta=(0.0,) * 3))
    assert (tnorm.alpha, tnorm.beta, tnorm.swap_rb) == \
        (jnorm.alpha, jnorm.beta, jnorm.swap_rb)
    ref = np.asarray(jwarp.sample_transform(
        jnp.asarray(pages), jnp.asarray(mats), jnp.asarray(idx),
        jnp.asarray(vw), jnp.asarray(vh), out_h=40, out_w=56, norm=jnorm,
        out_dtype=getattr(jnp, out_dtype), pad_value=-0.5).astype(
            np.float32))
    t = torch.from_numpy
    got = warp.sample_transform(
        t(pages), t(mats), t(idx), t(vw), t(vh), out_h=40, out_w=56,
        norm=tnorm, out_dtype=getattr(torch, out_dtype), pad_value=-0.5)
    assert got.dtype == getattr(torch, out_dtype)
    got = got.float().numpy()
    assert np.all(got[1, 22:] == -0.5) and np.all(got[1, :, 31:] == -0.5)
    if out_dtype == "float32":
        # the axis-aligned item within 1e-5; the slanted one within 1e-4:
        # XLA fuses its coordinate multiply-adds into FMAs, which moves a
        # sample at a sharp edge by ~1e-3 of a grey level before alpha
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-4, rtol=0)
    else:       # one bfloat16 rounding of the same float32 value
        np.testing.assert_allclose(got, ref, atol=1e-4,
                                   rtol=2.0 ** -8)


# ----------------------------- classifiers -----------------------------

@pytest.fixture(scope="module", params=[(1.0, 4, (224, 224)),
                                        (0.25, 2, (80, 160))],
                ids=["doc_ori_x1_0", "textline_x0_25"])
def v1_pair(request):
    scale, classes, hw = request.param
    flat = perturbed(JPPLCNetV1Cls(class_num=classes, scale=scale),
                     (1, *hw, 3), 21)
    port = load_weights(PPLCNetV1Cls(classes, scale), params_from_jax(flat))
    return request.param, flat, port


def test_pplcnet_v1_cls_matches(v1_pair):
    (scale, classes, hw), flat, port = v1_pair
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JPPLCNetV1Cls(class_num=classes,
                                           scale=scale).apply)(
        unflatten(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, classes)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(),
                               rtol=0)


def test_pplcnet_trunk_classifier_matches():
    """The non-default LCNet trunk classifier (``backbones.PPLCNetV3`` in
    cls mode, flax ``"SAME"`` padding, its own SE) at a narrow scale."""
    module = jcls.PPLCNetClassifier(num_classes=3, scale=0.5)
    flat = perturbed(module, (1, 64, 96, 3), 22)
    port = load_weights(cls.PPLCNetClassifier(3, 0.5), params_from_jax(flat))
    x = np.random.default_rng(2).normal(size=(2, 63, 97, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(module.apply)(unflatten(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(),
                               rtol=0)


# (port factory, JAX module, calibration seed); the doc seed turns both
# pages of _ocr_pages (classes 2 and 3, clear top-2 gaps), so every page
# of the pipeline test is rotated and mapped back
CLASSIFIERS = {
    "doc": ("doc_orientation_classifier", lambda: JPPLCNetV1Cls(
        class_num=4, scale=1.0), 62),
    "line": ("textline_orientation_classifier", lambda: JPPLCNetV1Cls(
        class_num=2, scale=0.25), 31),
}


@pytest.fixture(scope="module")
def classifier_pairs():
    """(JAX, port, port state_dict) doc-orientation and text-line
    classifiers on the same calibrated weights, float32."""
    rng = np.random.default_rng(30)
    calib = [_page(rng, 320, 480) for _ in range(4)]
    out = {}
    for name, (factory, module, seed) in CLASSIFIERS.items():
        sd, flat = calibrated(getattr(cls, factory), module(), calib, seed)
        j = getattr(jcls, factory)(unflatten(flat), runtime=jrt())
        t = getattr(cls, factory)(params_from_jax(flat),
                                  runtime=Runtime("float32", **CPU))
        out[name] = (j, t, sd)
    return out


def test_calibrated_weights_round_trip(classifier_pairs):
    """The calibrated port weights went into JAX and back unchanged, and
    they give probabilities that are not a tie."""
    for j, t, sd in classifier_pairs.values():
        back = params_from_jax(flatten_params(j.params))
        assert back.keys() == sd.keys()
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
        page = _page(np.random.default_rng(9), 320, 480)
        probs = t.probs_pages(torch.from_numpy(page[None]), [(320, 480)])
        assert np.ptp(probs) > 1e-2, probs


def test_classify_pages_matches(classifier_pairs):
    j, t, _ = classifier_pairs["doc"]
    rng = np.random.default_rng(4)
    shapes = [(320, 480), (300, 200), (320, 256)]
    pages = np.zeros((3, 320, 480, 3), np.uint8)
    for i, (h, w) in enumerate(shapes):
        pages[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    ref = j.classify_pages(jnp.asarray(pages), shapes)
    got = t.classify_pages(torch.from_numpy(pages), shapes)
    assert [c for c, _ in got] == [c for c, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                               atol=1e-5, rtol=0)
    probs = t.probs_pages(torch.from_numpy(pages), shapes)
    np.testing.assert_allclose(probs.max(1), [s for _, s in ref],
                               atol=1e-5, rtol=0)


def test_classify_quads_matches(classifier_pairs):
    j, t, _ = classifier_pairs["line"]
    rng = np.random.default_rng(5)
    pages = rng.integers(0, 256, (2, 160, 240, 3), dtype=np.uint8)
    quads = [(0, np.array([[10, 10], [200, 14], [199, 40], [9, 36]],
                          np.float32)),
             (1, np.array([[30, 120], [40, 20], [70, 22], [60, 124]],
                          np.float32)),
             (1, np.array([[5, 60], [230, 60], [230, 90], [5, 90]],
                          np.float32))]
    ref = j.classify_quads(jnp.asarray(pages), quads)
    got = t.classify_quads(torch.from_numpy(pages), quads)
    assert [c for c, _ in got] == [c for c, _ in ref]
    # the axis-aligned quad within 1e-5; the two slanted ones within 1e-4:
    # their samples sit where XLA's fused coordinate multiply-adds round
    # otherwise (test_sample_transform_matches)
    np.testing.assert_allclose(got[2][1], ref[2][1], atol=1e-5, rtol=0)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                               atol=1e-4, rtol=0)
    assert t.classify_quads(torch.from_numpy(pages), []) == []


# ----------------------------- UVDoc -----------------------------

@pytest.mark.parametrize("case", ["identity", "shift"])
def test_grid_sample_matches(case):
    rng = np.random.default_rng(6)
    img = rng.random((2, 12, 17, 3)).astype(np.float32) * 255
    ys, xs = np.meshgrid(np.arange(9, dtype=np.float32),
                         np.arange(15, dtype=np.float32), indexing="ij")
    coords = np.stack([xs, ys], -1)[None].repeat(2, 0)
    if case == "shift":
        coords = coords + np.array([[0.37, -0.61]], np.float32) * \
            np.array([1.0, 2.0], np.float32)[:, None, None, None] * 3
        coords[1, 0, 0] = (-0.4, 20.5)            # clamped to the border
    ref = np.asarray(jgrid.grid_sample(jnp.asarray(img), jnp.asarray(coords)))
    got = grid_sample.grid_sample(torch.from_numpy(img),
                                  torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-6)
    if case == "identity":
        np.testing.assert_array_equal(got, img[:, :9, :15])
    g = rng.uniform(-1, 1, (2, 5, 4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        grid_sample.normalized_grid_to_pixels(torch.from_numpy(g), 12,
                                              17).numpy(),
        np.asarray(jgrid.normalized_grid_to_pixels(jnp.asarray(g), 12, 17)),
        atol=1e-5)


def test_uvdoc_exact_matches():
    """The net at a narrow width and a small input; the 2-D grid within
    1e-5 and the 3-D head within 1e-4 relative."""
    module = JUVDocNetExact(num_filter=8, block_nums=(2, 2))
    flat = perturbed(module, (1, 96, 64, 3), 41)
    port = load_weights(UVDocNetExact(8, (2, 2)), params_from_jax(flat))
    x = (np.random.default_rng(7).random((2, 96, 64, 3)) * 0.6).astype(
        np.float32)
    g2, g3 = jax.jit(module.apply)(unflatten(flat), jnp.asarray(x))
    with torch.no_grad():
        t2, t3 = port(torch.from_numpy(x))
    assert t2.dtype == t3.dtype == torch.float32
    assert tuple(t2.shape) == np.asarray(g2).shape == (2, 6, 4, 2)
    assert 0.05 < float(np.abs(np.asarray(g2)).mean()) < 1.0   # not vacuous
    np.testing.assert_allclose(t2.numpy(), np.asarray(g2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t3.numpy(), np.asarray(g3),
                               atol=1e-4 * np.abs(np.asarray(g3)).max(),
                               rtol=0)


def _rectified_gate(got, ref):
    """max|Δ| ≤ 1 on at most 0.1% of the pixels; returns the share."""
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1, int(d.max())
    share = float((d > 0).mean())
    assert share <= 1e-3, share
    return share


@pytest.fixture(scope="module")
def uvdoc_pair():
    """(JAX, port) rectifiers at the real 712×488 input, num_filter 4,
    lecun weights with the grid projection scaled ×3 so the grid moves
    the page's text without scrambling it (the detector still finds it)."""
    module = JUVDocNetExact(num_filter=4)
    flat = lecun(module, (1, 712, 488, 3), 47, grid_gain=3.0)
    j = juvdoc.UVDocRectifier(unflatten(flat), runtime=jrt(), num_filter=4)
    t = uvdoc.UVDocRectifier(params_from_jax(flat), num_filter=4,
                             runtime=Runtime("float32", **CPU))
    return flat, j, t


def test_uvdoc_rectifier_matches(uvdoc_pair):
    _, j, t = uvdoc_pair
    page = _page(np.random.default_rng(8), 300, 420)
    ref, got = j.rectify(page), t.rectify(page)
    assert got.shape == ref.shape == page.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - page).mean() > 5      # it moved pixels
    _rectified_gate(got, ref)


def test_legacy_uvdoc_net_matches():
    module = juvdoc.UVDocNet(width=4)
    flat = perturbed(module, (1, 96, 64, 3), 43)
    port = load_weights(uvdoc.UVDocNet(width=4), params_from_jax(flat))
    x = np.random.default_rng(9).random((1, 96, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(module.apply)(unflatten(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ----------------------------- preprocessor -----------------------------

def test_document_preprocessor_orientation_matches(classifier_pairs):
    j, t, _ = classifier_pairs["doc"]
    rng = np.random.default_rng(10)
    images = [_page(rng, 320, 480), _page(rng, 480, 320),
              _page(rng, 256, 300)]
    ref = jpre.DocumentPreprocessor(orientation=j, runtime=jrt()).preprocess(
        images)
    got = preprocess.DocumentPreprocessor(
        orientation=t, runtime=Runtime("float32", **CPU)).preprocess(images)
    for g, r in zip(got, ref):
        assert (g.orientation.angle, g.orientation.rotated_w,
                g.orientation.rotated_h, g.rectified, g.can_map_back) == \
            (r.orientation.angle, r.orientation.rotated_w,
             r.orientation.rotated_h, r.rectified, r.can_map_back)
        np.testing.assert_array_equal(g.image, r.image)
    for k in range(4):
        np.testing.assert_array_equal(
            preprocess.rotate_image(images[1], 90 * k),
            jpre.rotate_image(images[1], 90 * k))


# ----------------------------- bfloat16 -----------------------------

def _dtypes_jax(module, params, x):
    _, state = jax.jit(lambda p, v: module.apply(
        p, v, capture_intermediates=True, mutable=["intermediates"]))(
            params, x)
    inter = state["intermediates"]
    return {name: inter[name]["__call__"][0].dtype
            for name in ("conv1", "last_conv", "fc")}


def _dtypes_port(model, x):
    seen = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, o.dtype))
        for n in ("conv1", "last_conv", "fc")]
    with torch.no_grad():
        out = model(x)
    for h in hooks:
        h.remove()
    return seen, out


@pytest.mark.parametrize("which", ["doc", "line"])
def test_bf16_dtype_policy_matches(which):
    """Under bfloat16 the tile, trunk and last_conv compute in bfloat16,
    the fc and the probabilities in float32, in both packages; the
    probabilities agree within 2e-2."""
    factory, module, _ = CLASSIFIERS[which]
    hw = (224, 224) if which == "doc" else (80, 160)
    flat = perturbed(module(), (1, *hw, 3), 51)
    j = getattr(jcls, factory)(unflatten(flat), runtime=jrt("bfloat16"))
    t = getattr(cls, factory)(params_from_jax(flat),
                              runtime=Runtime("bfloat16", **CPU))
    rng = np.random.default_rng(11)
    pages = rng.integers(0, 256, (2, 320, 480, 3), dtype=np.uint8)
    shapes = [(320, 480), (300, 400)]
    mats = np.stack([j.preprocess.matrix(h, w) for h, w in shapes])
    full = jnp.full((2,), max(hw), jnp.int32)
    jx = jwarp.sample_transform(
        jnp.asarray(pages), jnp.asarray(mats), jnp.arange(2, dtype=jnp.int32),
        full, full, out_h=hw[0], out_w=hw[1],
        norm=jwarp.NormSpec.imagenet_rgb(), out_dtype=jnp.bfloat16)
    tfull = torch.full((2,), max(hw), dtype=torch.int32)
    tx = warp.sample_transform(
        torch.from_numpy(pages), torch.from_numpy(mats), torch.arange(2),
        tfull, tfull, out_h=hw[0], out_w=hw[1],
        norm=warp.NormSpec.imagenet_rgb(), out_dtype=torch.bfloat16)
    assert str(jx.dtype) == "bfloat16" and tx.dtype == torch.bfloat16
    jd = _dtypes_jax(j.model, j.params, jx)
    td, _ = _dtypes_port(t.model, tx)
    assert {k: str(v) for k, v in jd.items()} == \
        {"conv1": "bfloat16", "last_conv": "bfloat16", "fc": "float32"}
    assert td == {"conv1": torch.bfloat16, "last_conv": torch.bfloat16,
                  "fc": torch.float32}
    ref = np.stack([s for _, s in j.classify_pages(jnp.asarray(pages),
                                                   shapes)])
    probs = t.probs_pages(torch.from_numpy(pages), shapes)
    assert probs.dtype == np.float32
    np.testing.assert_allclose(probs.max(1), ref, atol=2e-2, rtol=0)


def test_bf16_uvdoc_grid_matches(uvdoc_pair):
    """UVDoc under bfloat16: the input tile and the net in bfloat16, the
    grid float32 and within 2e-2 of the JAX package's."""
    flat, _, _ = uvdoc_pair
    j = juvdoc.UVDocRectifier(unflatten(flat), runtime=jrt("bfloat16"),
                              num_filter=4)
    t = uvdoc.UVDocRectifier(params_from_jax(flat), num_filter=4,
                             runtime=Runtime("bfloat16", **CPU))
    page = _page(np.random.default_rng(12), 300, 420)
    mats = jwarp.resize_matrix(300, 420, 712, 488)[None]
    ih, iw = 712, 488
    full = lambda v: jnp.full((1,), v, jnp.int32)   # noqa: E731
    jx = jwarp.sample_transform(
        jnp.asarray(page[None]), jnp.asarray(mats), full(0), full(iw),
        full(ih), out_h=ih, out_w=iw,
        norm=jwarp.NormSpec(alpha=(1 / 255.0,) * 3, beta=(0.0,) * 3),
        out_dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(j.model.apply)(j.params, jx)[0])
    got = t.grid(torch.from_numpy(page[None]), mats)
    assert got.dtype == torch.float32 and t.model.resnet_head[0].conv.weight \
        .dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0)


# ----------------------------- the pipeline -----------------------------

def _ocr_pages():
    rng = np.random.default_rng(7)
    pages = []
    for p in range(2):
        img = np.full((320, 480, 3), 255, np.uint8)
        for r in range(4):
            w = (300, 180, 360, 120)[(r + p) % 4]
            y = 30 + r * 70
            img[y:y + 26, 40:40 + w] = rng.integers(0, 80)
        pages.append(img)
    # the second page arrives rotated 90° clockwise
    pages[1] = np.ascontiguousarray(np.rot90(pages[1], -1))
    return pages


@pytest.fixture(scope="module")
def weights():
    """The trained bench detector and a perturbed random recognizer (its
    texts are not empty)."""
    vocab = 2 + len(default_charset())
    rec_tree = unflatten(perturbed(SVTRRecognizer(vocab_size=vocab),
                                   (1, 48, 64, 3), 61))
    det_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            load_params(str(BENCH_DET)))
    return det_tree, rec_tree


@pytest.fixture(scope="module")
def jax_general(weights):
    """One JAX general pipeline; each test wraps its detector and
    recognizer in an ``OAROCR`` with the stages it needs, as the JAX
    builder wires them (``ocr.py:636-656``), so their compiled programs
    are shared (the jit is per detector and recognizer)."""
    det_tree, rec_tree = weights
    return (JBuilder("general").with_runtime(jrt())
            .with_det_params(det_tree).with_rec_params(rec_tree)
            .with_batch_sizes(image=2, region=64)).build()


def _pipes(weights, jax_general, word_boxes=False, preprocessor=None,
           line_orienter=None):
    _, rec_tree = weights
    cfg = dataclasses.replace(jax_general.cfg, return_word_boxes=word_boxes)
    jpipe = JOAROCR(jax_general.detector, jax_general.recognizer, cfg,
                    jax_general.runtime, preprocessor=preprocessor,
                    line_orienter=line_orienter)
    port = (OAROCRBuilder("general")
            .with_runtime(Runtime("float32", **CPU))
            .with_det_params(params_from_jax(read_safetensors(str(BENCH_DET))))
            .with_rec_params(params_from_jax(flatten_params(rec_tree)))
            .with_batch_sizes(image=2, region=64))
    return jpipe, port


def _with_stages(pipe, preprocessor=None, line_orienter=None):
    """``pipe`` with the given stages, as the JAX side takes them: the
    builder's options make stages on seeded random weights only."""
    return OAROCR(pipe.detector, pipe.recognizer, pipe.cfg, pipe.runtime,
                  preprocessor=preprocessor, line_orienter=line_orienter)


def _same_regions(ours, ref):
    report = compare_results(ours, ref)
    assert report["ok"], report
    for o, r in zip(ours, ref):
        assert (o.width, o.height, o.orientation_angle, o.rectified) == \
            (r.width, r.height, r.orientation_angle, r.rectified)
        for a, b in zip(o.regions, r.regions):
            assert a.orientation_angle == b.orientation_angle
            assert a.word_texts == b.word_texts
            assert (a.word_boxes is None) == (b.word_boxes is None)
            for qa, qb in zip(a.word_boxes or [], b.word_boxes or []):
                np.testing.assert_allclose(qa, qb, atol=1e-3)
    return report


def test_ocr_orientation_textline_word_boxes_match(weights, jax_general,
                                                  classifier_pairs):
    """Document orientation, text-line orientation and word boxes on the
    calibrated classifier weights; boxes and word boxes map back through
    the page rotation. The JAX pipeline takes the classifiers as its
    builder would make them (``ocr.py:641-656``), with these weights."""
    (jdoc, tdoc, _), (jline, tline, _) = (classifier_pairs["doc"],
                                          classifier_pairs["line"])
    jpipe, port = _pipes(
        weights, jax_general, word_boxes=True,
        preprocessor=jpre.DocumentPreprocessor(orientation=jdoc,
                                               runtime=jrt()),
        line_orienter=jline)
    pipe = port.with_word_boxes().build()
    pipe = _with_stages(pipe, preprocessor=preprocess.DocumentPreprocessor(
        orientation=tdoc, runtime=pipe.runtime), line_orienter=tline)
    pages = _ocr_pages()
    # the page classes must not hinge on a near tie
    probs = pipe.preprocessor.orientation.probs_pages(
        pipe.runtime.put_pages(pages, (480, 480)),
        [p.shape[:2] for p in pages])
    top2 = np.sort(probs, 1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3), probs
    ours, ref = pipe.predict(pages), jpipe.predict(pages)
    _same_regions(ours, ref)
    assert sum(len(r.regions) for r in ref) >= 6, "vacuous reference"
    assert any(x.word_boxes for r in ours for x in r.regions)
    angles = [x.orientation_angle for r in ours for x in r.regions]
    assert set(angles) == {0, 180}, angles          # both turns ran
    assert any(r.orientation_angle for r in ours)   # a page was turned


def test_ocr_rectification_matches(weights, jax_general, uvdoc_pair):
    """Rectification (orientation off): the rectified pages first, under
    the uint8 gate, then the OCR results on them. The pages are the two
    of :func:`_ocr_pages`, with the rectifier of :func:`uvdoc_pair`: the
    ±1 pixels (37 and 35 of 460,800 here) sit on block edges that the
    detector's threshold does not hinge on, and 21 regions come out."""
    flat, jrect, trect = uvdoc_pair
    jpipe, port = _pipes(weights, jax_general,
                         preprocessor=jpre.DocumentPreprocessor(
                             rectifier=jrect, use_orientation=False,
                             use_rectification=True, runtime=jrt()))
    pipe = port.build()
    pipe = _with_stages(pipe, preprocessor=preprocess.DocumentPreprocessor(
        rectifier=trect, use_orientation=False, use_rectification=True,
        runtime=pipe.runtime))
    pages = _ocr_pages()
    for page in pages:
        _rectified_gate(trect.rectify(page), jrect.rectify(page))
    ours, ref = pipe.predict(pages), jpipe.predict(pages)
    assert all(r.rectified and r.orientation_angle is None for r in ours)
    _same_regions(ours, ref)
    assert sum(len(r.regions) for r in ref) >= 6, "vacuous reference"


def test_builder_wires_every_stage():
    """Every option of the JAX builder builds, with seeded random weights
    when none are given."""
    rt = Runtime("float32", **CPU)
    pipe = (OAROCRBuilder("general").with_runtime(rt)
            .with_doc_orientation().with_doc_rectification()
            .with_textline_orientation().with_word_boxes().build())
    assert pipe.preprocessor.orientation.name == "doc_ori"
    assert isinstance(pipe.preprocessor.rectifier.model, UVDocNetExact)
    assert pipe.line_orienter.name == "line_ori"
    assert pipe.cfg.return_word_boxes
    off = (OAROCRBuilder("general").with_runtime(rt)
           .with_doc_orientation().with_doc_orientation(False).build())
    assert off.preprocessor is None and off.line_orienter is None

"""The port's models and weight conversion against the JAX package.

Every JAX model is initialised with ``init_params_fast``, every leaf is then
perturbed with seeded numpy noise (so BatchNorm statistics, LAB scalars
and biases all carry non-trivial values), and the same flat parameters
go through ``params_from_jax`` into the port. Outputs must agree to
atol 2e-4 / rtol 1e-3, the tolerances of ``test_golden_parity.py``.
Both sides run in float32 on the CPU.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oar_ocr_tpu.models.detection.db import DBNet
from oar_ocr_tpu.models.lcnetv3 import PPLCNetV3
from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import flatten_params, unflatten_params
from oar_ocr_tpu_torch.models.detection.db import DBNet as TDBNet
from oar_ocr_tpu_torch.models.layers import load_weights
from oar_ocr_tpu_torch.models.recognition.svtr import \
    SVTRRecognizer as TSVTRRecognizer
from oar_ocr_tpu_torch.runtime.weights import (params_from_jax,
                                               read_safetensors)

ATOL, RTOL = 2e-4, 1e-3
BENCH_DET = Path(__file__).resolve().parents[1] / "assets" / "bench_det.safetensors"


def perturbed_flat(module, example_shape, seed):
    """JAX init_params_fast, then seeded noise on every leaf (variances kept
    positive)."""
    flat = flatten_params(init_params_fast(module, example_shape))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(flat.items()):
        v = np.asarray(v, np.float32)
        if k.endswith("/var"):
            out[k] = (rng.random(v.shape) * 0.5 + 0.75).astype(np.float32)
        else:
            out[k] = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    return out


def torch_apply(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x))


@pytest.fixture(scope="module")
def det_pair():
    flat = perturbed_flat(DBNet(backbone_scale=0.75), (1, 64, 96, 3), 11)
    port = load_weights(TDBNet(0.75), params_from_jax(flat))
    return flat, port


@pytest.fixture(scope="module")
def rec_pair():
    flat = perturbed_flat(SVTRRecognizer(vocab_size=96, backbone_scale=0.95),
                          (1, 48, 64, 3), 12)
    port = load_weights(TSVTRRecognizer(96, 0.95), params_from_jax(flat))
    return flat, port


@pytest.mark.parametrize("mode", ["det", "rec"])
def test_lcnetv3_matches_jax(mode, det_pair, rec_pair):
    """The backbone alone, on the backbone subtree of the DB/SVTR params."""
    flat, port = det_pair if mode == "det" else rec_pair
    scale, shape = ((0.75, (1, 64, 96, 3)) if mode == "det"
                    else (0.95, (1, 48, 64, 3)))
    sub = {c: v["backbone"] for c, v in unflatten_params(flat).items()}
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = jax.jit(PPLCNetV3(scale=scale, mode=mode).apply)(sub,
                                                           jnp.asarray(x))
    got = torch_apply(port.backbone, x.transpose(0, 3, 1, 2))
    if mode == "rec":
        ref, got = (ref,), (got,)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(r), atol=ATOL, rtol=RTOL)


def test_dbnet_matches_jax(det_pair):
    flat, port = det_pair
    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    ref = jax.jit(DBNet(backbone_scale=0.75).apply)(unflatten_params(flat),
                                                    jnp.asarray(x))
    got = torch_apply(port, x)
    assert got.shape == (2, 64, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_svtr_matches_jax(rec_pair):
    flat, port = rec_pair
    x = np.random.default_rng(2).normal(size=(2, 48, 64, 3)).astype(
        np.float32)
    ref = jax.jit(SVTRRecognizer(vocab_size=96, backbone_scale=0.95).apply)(
        unflatten_params(flat), jnp.asarray(x))
    got = torch_apply(port, x)
    assert got.shape == (2, 8, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_bench_det_checkpoint_reads_like_jax():
    """The numpy-only reader gives the same tensors as the JAX package's
    safetensors-based ``load_params``."""
    from oar_ocr_tpu.runtime.weights import load_params

    ours = read_safetensors(str(BENCH_DET))
    theirs = flatten_params(load_params(str(BENCH_DET)))
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == np.asarray(theirs[k]).dtype, k
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))


def test_bench_det_loads_strictly_into_dbnet():
    sd = params_from_jax(read_safetensors(str(BENCH_DET)))
    model = load_weights(TDBNet(0.75), sd)     # strict: no key missing
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_safetensors_reader_dtypes(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(3)
    arrays = {"a": rng.normal(size=(2, 3)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float16),
              "c": np.arange(6, dtype=np.int32).reshape(3, 2),
              "d": np.array([1, 0, 1], np.uint8)}
    path = tmp_path / "t.safetensors"
    save_file(arrays, str(path))
    got = read_safetensors(str(path))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    assert read_safetensors(path.read_bytes()).keys() == got.keys()


def test_params_from_jax_layouts():
    """Spot-check the layout rules: HWIO→OIHW, dense (in,out)→(out,in),
    flipped flax deconv → (in,out,kH,kW), BatchNorm buffer names."""
    rng = np.random.default_rng(4)
    conv = rng.normal(size=(3, 5, 2, 4)).astype(np.float32)
    dense = rng.normal(size=(6, 7)).astype(np.float32)
    deconv = rng.normal(size=(2, 2, 3, 5)).astype(np.float32)
    sd = params_from_jax({
        "params/backbone/conv1/conv/kernel": conv,
        "params/head/ctc_head/fc/kernel": dense,
        "params/head/binarize/conv2/kernel": deconv,
        "batch_stats/backbone/conv1/bn/var": np.ones(4, np.float32),
        "params/backbone/conv1/bn/scale": np.ones(4, np.float32),
        "params/backbone/blocks2.0/dw_conv/lab/scale": np.ones(1, np.float32),
    })
    np.testing.assert_array_equal(sd["backbone.conv1.conv.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.ctc_head.fc.weight"].numpy(),
                                  dense.T)
    np.testing.assert_array_equal(sd["head.binarize.conv2.weight"].numpy(),
                                  deconv[::-1, ::-1].transpose(2, 3, 0, 1))
    assert "backbone.conv1.bn.running_var" in sd
    assert "backbone.conv1.bn.weight" in sd
    assert "backbone.blocks2.0.dw_conv.lab.scale" in sd

"""The K1 normalize port against the JAX package.

CPU tensors take the port's plain version (``normalize_ref``); it is held
against JAX ``normalize_images(use_pallas=False)`` — the Pallas kernel's
own reference — and against the inline normalize + pad mask of the JAX
main path (``det_device.py:86-90`` det, pad 0; ``warp.py:308-317`` rec,
swap + pad β). Tolerances: 1e-6 absolute for float32 (values are O(1);
one ulp is ~2.4e-7); bfloat16 must equal the float32 result cast to
bfloat16 exactly. The CUDA kernel against the plain version needs a card
and is marked ``cuda``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from oar_ocr_tpu.core.constants import IMAGENET_MEAN, IMAGENET_STD
from oar_ocr_tpu.ops.normalize import normalize_images as j_normalize_images
from oar_ocr_tpu_torch.ops.normalize import (KERNEL, coefficients,
                                             normalize_images,
                                             normalize_masked, normalize_ref)

F32_TOL = 1e-6


def _pages(seed, shape=(2, 5, 7, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("swap_rb", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_normalize_images_matches_jax(swap_rb, out_dtype):
    x = _pages(0)
    before = KERNEL.launches
    ref = np.asarray(j_normalize_images(
        jnp.asarray(x), mean=IMAGENET_MEAN, std=IMAGENET_STD,
        swap_rb=swap_rb, out_dtype=jnp.float32, use_pallas=False))
    got = normalize_images(torch.from_numpy(x), mean=IMAGENET_MEAN,
                           std=IMAGENET_STD, swap_rb=swap_rb,
                           out_dtype=getattr(torch, out_dtype))
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=0)
    else:
        expect = torch.tensor(ref).to(torch.bfloat16)
        assert torch.equal(got, expect)
    assert KERNEL.launches == before     # CPU tensors never launch


def test_swap_moves_channel_data():
    """swap_rb swaps the data, not only the coefficients (3bc1760)."""
    x = np.zeros((1, 1, 1, 3), np.uint8)
    x[..., 0] = 255                      # pure red
    out = normalize_images(torch.from_numpy(x), mean=(0, 0, 0),
                           std=(1, 1, 1), scale=1.0, swap_rb=True)
    assert out[0, 0, 0].tolist() == [0.0, 0.0, 255.0]


def _jax_det_mask(out, dst_h, dst_w, pad):
    """det_device.py:86-90 on an already-resampled f32 tile."""
    b, h, w, _ = out.shape
    row = jnp.arange(h)[None, :, None, None]
    col = jnp.arange(w)[None, None, :, None]
    mask = (row < dst_h[:, None, None, None]) & (col < dst_w[:, None, None, None])
    return jnp.where(mask, out, pad)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_det_masked_form_matches_jax(out_dtype):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (3, 9, 12, 3)).astype(np.float32)
    dst_h = np.array([9, 4, 1], np.int32)
    dst_w = np.array([5, 12, 1], np.int32)
    alpha, beta = coefficients(IMAGENET_MEAN, IMAGENET_STD)
    ref = np.asarray(_jax_det_mask(
        jnp.asarray(x) * jnp.asarray(alpha, jnp.float32)
        + jnp.asarray(beta, jnp.float32),
        jnp.asarray(dst_h), jnp.asarray(dst_w), 0.0))
    got = normalize_masked(torch.from_numpy(x), alpha, beta,
                           valid_h=torch.from_numpy(dst_h),
                           valid_w=torch.from_numpy(dst_w), pad=0.0,
                           out_dtype=getattr(torch, out_dtype))
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=0)
    else:
        assert torch.equal(got, torch.tensor(ref).to(torch.bfloat16))
    assert np.all(got.float().numpy()[1, 4:] == 0.0)


def test_rec_masked_form_matches_jax():
    """warp.py:308-317: reverse channels, x·α + β, pad β beyond dst_w."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (2, 4, 16, 3)).astype(np.float32)
    dst_w = np.array([10, 16], np.int32)
    alpha, beta = (2.0 / 255.0,) * 3, (-1.0,) * 3
    t = jnp.asarray(x)[..., ::-1]
    t = t * jnp.asarray(alpha, jnp.float32) + jnp.asarray(beta, jnp.float32)
    col = jnp.arange(16)[None, None, :, None]
    ref = np.asarray(jnp.where(col < jnp.asarray(dst_w)[:, None, None, None],
                               t, jnp.asarray(beta, jnp.float32)))
    got = normalize_masked(torch.from_numpy(x), alpha, beta,
                           valid_h=torch.full((2,), 4, dtype=torch.int32),
                           valid_w=torch.from_numpy(dst_w), pad=beta,
                           swap_rb=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_TOL, rtol=0)
    assert np.all(got.numpy()[0, :, 10:] == -1.0)


def test_bad_inputs_raise():
    from oar_ocr_tpu_torch.errors import InvalidInputError

    with pytest.raises(InvalidInputError):
        normalize_images(torch.zeros((2, 3, 4), dtype=torch.uint8),
                         mean=IMAGENET_MEAN, std=IMAGENET_STD)
    with pytest.raises(InvalidInputError):
        normalize_images(torch.zeros((1, 2, 2, 3), dtype=torch.int32),
                         mean=IMAGENET_MEAN, std=IMAGENET_STD)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_kernel_matches_plain(in_dtype, out_dtype, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (3, 37, 53, 3)).astype(in_dtype)
    xd = torch.from_numpy(x).cuda()
    alpha, beta = coefficients(IMAGENET_MEAN, IMAGENET_STD)
    kw = dict(swap_rb=True, out_dtype=getattr(torch, out_dtype))
    if masked:
        kw.update(valid_h=torch.tensor([37, 20, 1], dtype=torch.int32),
                  valid_w=torch.tensor([53, 9, 1], dtype=torch.int32),
                  pad=beta)
    before = KERNEL.launches
    got = (normalize_masked(xd, alpha, beta, **{
        k: (v.cuda() if isinstance(v, torch.Tensor) else v)
        for k, v in kw.items()}) if masked else
        normalize_images(xd, mean=IMAGENET_MEAN, std=IMAGENET_STD, **kw))
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = normalize_ref(torch.from_numpy(x), alpha, beta, **kw)
    assert torch.equal(got.cpu(), ref)

"""The port's five exact vision towers against the JAX package's, on the
CPU.

Each tower runs its ``tiny()`` config in float32 in both packages on the
port's seeded weights, carried into the flax tree by ``torch_jax_tree``
(every flax leaf found with its shape, and back). The gate: the output
within 1e-5 · max(1, max|ref|). The CPU towers attend through K2's plain
version (``flash_attention_ref``), which is held here once at head dim 80
(MinerU's) against the JAX Pallas kernel in interpret mode; the host
helpers (InternVL tiling, the Qwen2-VL merge-block positions and rope
tables) against the JAX ones and the reference's fixture values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.ops.flash_attention import flash_attention as j_flash
from oar_ocr_tpu.vl import vision_towers as jvt
from oar_ocr_tpu_torch.ops import flash_attention as fa
from oar_ocr_tpu_torch.vl import vision_towers as vt
from oar_ocr_tpu_torch.vl.exact_models import exact_state_dict
from torch_jax_tree import jax_tree_from_port, one_torch_thread  # noqa: F401


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _rope(cfg, gh, gw):
    hp, wp = vt.mineru_vision_positions(gh, gw, cfg.merge)
    return vt._qwen_vision_rope(hp, wp, cfg.head_dim, cfg.rope_theta)


def _inputs(kind, cfg, rng):
    """The tower's arguments (numpy) on a 4 × 6 patch grid (HPD: 2 tiles)."""
    if kind == "internvit":
        return (rng.standard_normal((2, cfg.grid ** 2, 3 * cfg.patch ** 2))
                .astype(np.float32),)
    gh, gw = 4, 6
    tp = getattr(cfg, "temporal_patch", 1)
    patches = rng.standard_normal((gh * gw, 3 * tp * cfg.patch ** 2)
                                  ).astype(np.float32)
    cos, sin = _rope(cfg, gh, gw)
    if kind == "ovis":
        pos = rng.standard_normal((gh * gw, cfg.hidden)).astype(np.float32)
        return patches, pos, cos, sin
    return patches, cos, sin


_TOWERS = {
    "qwen2vl": (jvt.MinerUVisionModel, vt.MinerUVisionConfig),
    "glm": (jvt.GlmVisionModel, vt.GlmVisionConfig),
    "ovis": (jvt.OvisVisionModel, vt.OvisVisionConfig),
    "monkey": (jvt.MonkeyVisionModel, vt.MonkeyVisionConfig),
    "internvit": (jvt.HpdVisionModel, vt.HpdVisionConfig),
}


@pytest.mark.parametrize("kind", sorted(_TOWERS))
def test_tower_matches_jax(kind):
    """Each tower, port against JAX, on the port's seeded weights."""
    jcls, cfg_cls = _TOWERS[kind]
    cfg = cfg_cls().tiny()
    jcfg = getattr(jvt, cfg_cls.__name__)().tiny()
    assert cfg == cfg.__class__(**jcfg.__dict__)
    ours = vt.TOWERS[kind](cfg)
    sd = exact_state_dict(ours, torch.Generator().manual_seed(3))
    ours.load_state_dict(sd)
    args = _inputs(kind, cfg, np.random.default_rng(1))
    jmod = jcls(jcfg)
    tree = jax_tree_from_port(
        jmod, None, sd,
        init=lambda r: jmod.init(r, *(jnp.asarray(a) for a in args)))
    ref = np.asarray(jax.jit(jmod.apply)(tree, *(jnp.asarray(a)
                                                 for a in args)))
    with torch.no_grad():
        got = ours(*(torch.from_numpy(a) for a in args)).numpy()
    _close(got, ref)


def test_flash_ref_d80_matches_jax_kernel():
    """K2's plain version at MinerU's head dim 80 against the JAX Pallas
    kernel in interpret mode (T ≥ 128 takes the kernel there), with and
    without key lengths; also through the towers' (B, T, H, D) view."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 2, 160, 80)).astype(np.float32)
               for _ in range(3))
    for vlen in (None, np.array([160, 97], np.int32)):
        ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 valid_len=None if vlen is None
                                 else jnp.asarray(vlen), interpret=True))
        tv = None if vlen is None else torch.from_numpy(vlen)
        before = fa.KERNEL.launches
        got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), valid_len=tv)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
        views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1,
                                                                   3)))
                 .transpose(1, 2) for a in (q, k, v)]
        strided = fa.flash_attention(*views, valid_len=tv)
        np.testing.assert_allclose(strided.numpy(), ref, atol=1e-5, rtol=0)
        assert fa.KERNEL.launches == before    # CPU tensors never launch
    assert 80 in fa.KERNEL_HEAD_DIMS


def test_host_helpers_match_jax_and_fixtures():
    """InternVL tiling on the reference's fixture values, and the
    Qwen2-VL positions and rope tables equal to the JAX helpers."""
    ratios = vt.intern_target_ratios(1, 25)
    assert ratios == jvt.intern_target_ratios(1, 25)
    assert len(vt.intern_target_ratios(1, 4)) == 8
    for (w, h), want in (((514, 64), (8, 1)), ((760, 865), (2, 2)),
                         ((248, 193), (5, 4)), ((720, 1150), (2, 3))):
        assert vt.intern_closest_ratio(w, h, 448, ratios) == want
        assert jvt.intern_closest_ratio(w, h, 448, ratios) == want
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (97, 141, 3), dtype=np.uint8)
    for mb in (1, 4, 12):
        ours = vt.intern_tile_image(img, image_size=32, max_blocks=mb)
        ref = jvt.intern_tile_image(img, image_size=32, max_blocks=mb)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    assert len(vt.intern_tile_image(np.zeros((865, 760, 3), np.uint8),
                                    image_size=448, max_blocks=12)) == 5
    hp, wp = vt.mineru_vision_positions(4, 4, 2)
    np.testing.assert_array_equal(hp[:4], [0, 0, 1, 1])
    np.testing.assert_array_equal(wp[4:8], [2, 3, 2, 3])
    for gh, gw in ((4, 6), (92, 68)):
        ours, ref = (vt.mineru_vision_positions(gh, gw, 2),
                     jvt.mineru_vision_positions(gh, gw, 2))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(vt._qwen_vision_rope(*ours, 80, 1e4),
                        jvt._qwen_vision_rope(*ref, 80, 1e4)):
            np.testing.assert_array_equal(a, b)
    x = jnp.asarray(rng.standard_normal((5,)).astype(np.float32))
    np.testing.assert_allclose(
        vt.quick_gelu(torch.from_numpy(np.array(x))).numpy(),
        np.asarray(jvt.quick_gelu(x)), rtol=1e-6, atol=1e-7)

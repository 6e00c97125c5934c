"""The port's PP-HGNetV2 and the server det / rec models against the JAX
modules on the CPU, float32.

Weights: the port's seeded weights with every BatchNorm calibrated on
the test input (``utils/calibrate.calibrated_state_dict``; identity
statistics would tie a random HGNetV2's scores), carried into the JAX
tree by ``torch_jax_tree.jax_tree_from_port``, which also checks that
``params_from_jax`` maps every flax parameter strictly, with no case of
its own. Gates, relative to max|ref|:

- ``PPHGNetV2`` in the det, rec and cls modes at a narrow config (stem 8,
  four stages up to 64 channels, a second block in one stage so the
  identity residual runs) on seeded inputs of odd sizes (the asymmetric
  ``"SAME"`` padding at stride 2 and (2, 1));
- the server ``DBNet`` (full PP-HGNetV2-B4, 31.3 M parameters) at
  96×96, its probability map;
- (the server ``SVTRRecognizer`` is in ``test_torch_server_ocr.py``).

Each JAX float32 output is held to the port's float64 run of the same
weights: within 1e-5, or within four times the port float32's own
distance from it where that is larger. A random calibrated HGNetV2
amplifies rounding with depth, so the two float32 runs do not meet 1e-5
directly: the JAX module's B4 probability map lies 8.8e-5 from the
port's, the port's 8.0e-5 from float64; on the narrow net the JAX
float32 lies 2.2-2.5 times as far from the port's float64 as the port's
own float32 does (1.9e-5 against 8.8e-6 on the stride-32 map; it adds
the BatchNorm after each convolution where the port folds it in). A
fault in the port moves its float64 run away from the JAX float32 by
far more than rounding does.
"""

import copy

import numpy as np
import pytest
import torch

from oar_ocr_tpu.models.detection.db import DBNet as JDBNet
from oar_ocr_tpu.models.hgnet import PPHGNetV2 as JPPHGNetV2
from oar_ocr_tpu_torch.models.detection.db import DBNet
from oar_ocr_tpu_torch.models.detection.detector import DBDetector
from oar_ocr_tpu_torch.models.hgnet import PPHGNetV2
from oar_ocr_tpu_torch.models.recognition.recognizer import CTCRecognizer
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.utils.calibrate import calibrated_state_dict
from torch_jax_tree import (jax_tree_from_port,  # noqa: F401
                            one_torch_thread, rel_err)

# (mid, out, blocks, downsample, layer_num): every stage downsamples;
# stage 1's second block has the identity residual
NARROW = ((8, 16, 1, False, 2), (8, 32, 2, True, 2), (16, 32, 1, True, 3),
          (16, 64, 1, True, 2))
TOL = 1e-5


def gate(port32, port64, jax32):
    """The JAX float32 output within TOL of the port's float64 one, or
    within four times the port float32's own distance from it."""
    assert rel_err(jax32, port64) <= max(TOL, 4 * rel_err(port32, port64))


def _calibrated(module, x_nhwc, seed, nchw=False):
    x = torch.from_numpy(x_nhwc)
    if nchw:
        x = x.permute(0, 3, 1, 2)
    return calibrated_state_dict(module, torch.Generator().manual_seed(seed),
                                 x)


@pytest.mark.parametrize("mode,shape", [("det", (1, 70, 90, 3)),
                                        ("rec", (2, 48, 84, 3)),
                                        ("cls", (2, 61, 67, 3))])
def test_hgnet_modes_match(mode, shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    model = PPHGNetV2(mode, stages=NARROW, stem_width=8)
    sd = _calibrated(model, x, 5, nchw=True)
    jmod = JPPHGNetV2(mode=mode, stages=NARROW, stem_width=8)
    ref = jmod.apply(jax_tree_from_port(jmod, shape, sd), x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(xt)
        f64 = copy.deepcopy(model).double()(xt.double())


    if mode == "det":
        assert len(got) == len(ref) == 4
        for g, g64, r in zip(got, f64, ref):
            assert g.shape[2:] == r.shape[1:3]           # strides 4 … 32
            gate(g.permute(0, 2, 3, 1).numpy(),
                 g64.permute(0, 2, 3, 1).numpy(), r)
        assert [g.shape[1] for g in got] == [16, 32, 32, 64]
    elif mode == "rec":
        assert got.shape == (2, 64, 1, 84 // 8 + 1)    # height 48 → 1 row
        gate(got[:, :, 0].permute(0, 2, 1).numpy(),
             f64[:, :, 0].permute(0, 2, 1).numpy(), ref)
    else:
        gate(got.numpy(), f64.numpy(), ref)


def _port_runs(model, x):
    """The port's float32 and float64 outputs on the NHWC input ``x``."""
    xt = torch.from_numpy(x)
    with torch.no_grad():
        return (model(xt).numpy(),
                copy.deepcopy(model).double()(xt.double()).numpy())


@pytest.fixture(scope="module")
def server_det():
    x = np.random.default_rng(4).standard_normal((1, 96, 96, 3)).astype(
        np.float32)
    model = DBNet(backbone="hgnet")
    sd = _calibrated(model, x, 6)
    return model, sd, x


def test_server_dbnet_matches(server_det):
    model, sd, x = server_det
    jmod = JDBNet(backbone="hgnet")
    tree = jax_tree_from_port(jmod, (1, 64, 64, 3), sd)
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var")))
    assert n_params == 31_292_561
    ref = np.asarray(jmod.apply(tree, x))
    got, got64 = _port_runs(model, x)
    assert got.shape == ref.shape == (1, 96, 96)
    gate(got, got64, ref)
    assert ref.std() > 1e-3, "a flat probability map: vacuous"


def test_server_models_run_in_the_runtime_dtype(server_det):
    """Under a bfloat16 Runtime the server models hold bfloat16 weights
    (the JAX ``ConvBNAct`` computes in ``x.dtype``); float32 keeps
    float32."""
    _model, sd, _x = server_det
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        rt = Runtime(name, device="cpu")
        det = DBDetector(sd, backbone="hgnet", runtime=rt)
        assert {p.dtype for p in det.model.parameters()} == {dtype}
        assert det.model.backbone.HGBlock_5.ConvBNAct_7.Conv_0.weight.dtype \
            == dtype
        rec = CTCRecognizer(backbone="hgnet", runtime=rt)
        assert {p.dtype for p in rec.model.parameters()} == {dtype}
        assert rec.model.head.ctc_encoder.encoder.conv1.conv.in_channels \
            == 2048

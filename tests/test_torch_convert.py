"""Upstream weights into the port without the JAX package: ONNX
initializers, the official-name maps and the converter, on the CPU.

- ``runtime/onnx_extract`` equals the JAX original on a hand-encoded
  model (raw, ``float_data`` and ``int64_data`` tensors, a node it must
  skip; the encoder of ``test_fetch_and_verify.py``) and rejects a file
  that is no ONNX model the same way.
- Det and rec at small width: JAX parameters → the JAX package's
  ``export_ppocr_format`` (official names) → an ONNX file → the port's
  extract and ``build_ppocr_map`` → the port's forward, which equals the
  JAX forward on the same input within 1e-5 of the output's max. The map
  is strict both ways (a missing tensor raises ``ModelLoadError`` naming
  it, ``unused_sources`` is empty).
- cls, SLANet, SLANeXt and PP-FormulaNet at small width: the deploy
  tensors the JAX per-family map expects (``convert_weights.
  _export_for_map``, the exact inverse of each of its rules) go through
  the port's map to exactly the state_dict ``params_from_jax`` makes of
  the same parameters (whose forwards the family tests hold to JAX), and
  ``jax_flat_params`` gives the JAX flat parameters back bit for bit.
- ``tools/port_convert_weights.py`` and ``tools/convert_weights.py`` on
  the same official-name source, det and rec at full width: the same
  keys, bit-equal tensors. The JAX tool builds its flax tree only to
  read the tree's names and ranks; the test gives it the shape-only
  ``init_params_fast`` of the same module, which saves ~20 s of eager
  init a model and leaves its output unchanged.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.runtime import onnx_extract as j_onnx
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import unflatten_params
from oar_ocr_tpu_torch.errors import ModelLoadError
from oar_ocr_tpu_torch.models.layers import init_state_dict, load_weights
from oar_ocr_tpu_torch.runtime import onnx_extract, ppocr_maps
from oar_ocr_tpu_torch.runtime.weights import (params_from_jax,
                                               read_safetensors,
                                               write_safetensors)
from test_fetch_and_verify import _field, _onnx_bytes, _varint
from test_torch_flax_keys import flat_shapes
from torch_jax_tree import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def perturbed(module, shape, seed, *extra):
    """Seeded normal leaves (BatchNorm variances in [0.75, 1.25)): the
    flat parameters of ``module``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in sorted(flat_shapes(module, shape, *extra).items()):
        v = (rng.random(s) * 0.5 + 0.75 if k.endswith("/var")
             else rng.normal(0, 0.05, s))
        out[k] = v.astype(np.float32)
    return out


# ----------------------------- ONNX extraction -----------------------------

def test_onnx_extract_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    tensors = {
        "conv1.weight": rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
        "fc.bias": rng.standard_normal((7,)).astype(np.float32),
        "head.fc.weight": rng.standard_normal((5, 6)).astype(np.float32),
        "shape_const": np.array([1, -1, 48, 320], np.int64),
    }
    data = _onnx_bytes(tensors, {"fc.bias": "float_data",
                                 "shape_const": "int64_data"})
    path = tmp_path / "model.onnx"
    path.write_bytes(data)
    for src in (data, str(path)):
        ours, ref = (onnx_extract.extract_initializers(src),
                     j_onnx.extract_initializers(src))
        assert list(ours) == list(ref) and set(ours) == set(tensors)
        for k, v in tensors.items():
            assert ours[k].dtype == ref[k].dtype == v.dtype
            np.testing.assert_array_equal(ours[k], ref[k])
            np.testing.assert_array_equal(ours[k], v)


def test_onnx_extract_rejects_non_onnx():
    for bad in (_field(1, 0, _varint(8)), b"\x08\x08"):
        with pytest.raises(ValueError) as ours:
            onnx_extract.extract_initializers(bad)
        with pytest.raises(ValueError) as ref:
            j_onnx.extract_initializers(bad)
        assert str(ours.value) == str(ref.value)


# ------------------------- official-name maps: det/rec -------------------------

def _det_rec(kind):
    from oar_ocr_tpu.models.detection.db import DBNet as J
    from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer as JR
    from oar_ocr_tpu_torch.models.detection.db import DBNet as T
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer as TR

    if kind == "det":
        return J(backbone_scale=0.35), T(0.35), (1, 64, 96, 3)
    return JR(vocab_size=40, backbone_scale=0.35), TR(40, 0.35), (1, 48, 96, 3)


@pytest.mark.parametrize("kind", ["det", "rec"])
def test_official_map_forward_matches_jax(kind, tmp_path):
    from oar_ocr_tpu.runtime.ppocr_maps import export_ppocr_format

    jm, tm, shape = _det_rec(kind)
    flat = perturbed(jm, shape, 21)
    official = export_ppocr_format(unflatten_params(flat))
    path = tmp_path / f"{kind}.onnx"
    path.write_bytes(_onnx_bytes({k: np.ascontiguousarray(v)
                                  for k, v in official.items()}))
    tensors = onnx_extract.extract_initializers(str(path))
    cm = ppocr_maps.build_ppocr_map(tm, name=kind)
    assert cm.unused_sources(tensors) == []
    sd = ppocr_maps.convert_official(tm, cm, tensors)
    assert set(sd) == set(tm.state_dict())
    model = load_weights(tm, {k: torch.from_numpy(v.copy())
                              for k, v in sd.items()})

    x = np.random.default_rng(3).normal(size=(2, *shape[1:])).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(unflatten_params(flat),
                                       jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    # strict both ways
    some = sorted(tensors)[7]
    short = {k: v for k, v in tensors.items() if k != some}
    with pytest.raises(ModelLoadError) as err:
        ppocr_maps.convert_official(tm, cm, short)
    assert some in str(err.value.context)
    assert len(cm.convert(short, strict=False)) == len(tensors) - 1
    extra = dict(tensors, **{"head.extra.weight": np.zeros(3, np.float32)})
    assert cm.unused_sources(extra) == ["head.extra.weight"]
    wrong = dict(tensors, **{some: np.zeros((1, 2, 3), np.float32)})
    with pytest.raises(ModelLoadError, match="wrong shape"):
        ppocr_maps.convert_official(tm, cm, wrong)


# --------------------- official-name maps: the other families ---------------------

def _family(kind):
    """(JAX module, init extra args, example shape, port module, JAX map
    builder, port map builder) at small width."""
    if kind == "cls":
        from oar_ocr_tpu.models.classification import pp_lcnet_exact as j
        from oar_ocr_tpu_torch.models.classification.pp_lcnet_exact import \
            PPLCNetV1Cls

        return (j.PPLCNetV1Cls(class_num=4, scale=0.25), (), (1, 64, 64, 3),
                PPLCNetV1Cls(4, 0.25), j.build_pplcnet_cls_map,
                ppocr_maps.build_pplcnet_cls_map)
    if kind == "slanet":
        from oar_ocr_tpu.models.recognition import slanet_exact as j
        from oar_ocr_tpu_torch.models.recognition.slanet_exact import \
            SLANetExact

        kw = dict(scale=0.5, neck_channels=16, hidden_size=24,
                  max_text_length=8, loc_reg_num=8)
        return (j.SLANetExact(**kw), (), (1, 64, 64, 3), SLANetExact(**kw),
                j.build_slanet_map, ppocr_maps.build_slanet_map)
    if kind == "slanext":
        from oar_ocr_tpu.models.recognition import slanext_exact as j
        from oar_ocr_tpu_torch.models.recognition.slanext_exact import \
            SLANeXtExact

        kw = dict(patch=8, dim=32, depth=2, heads=2, out_chans=16,
                  window=2, global_idx=(1,), net2_out=24, pos_grid=4,
                  hidden_size=24, max_text_length=8)
        return (j.SLANeXtExact(**kw), (), (1, 32, 32, 3), SLANeXtExact(**kw),
                j.build_slanext_map, ppocr_maps.build_slanext_map)
    from oar_ocr_tpu.models.recognition import pp_formulanet_exact as j
    from oar_ocr_tpu_torch.models.recognition import \
        pp_formulanet_exact as t

    jc, tc = j.PPFormulaNetConfig().tiny(), t.PPFormulaNetConfig().tiny()
    return (j.PPFormulaNetModule(jc), (jnp.zeros((1, 1), jnp.int32),),
            (1, *jc.image_hw, 3), t.PPFormulaNetModule(tc),
            j.build_formulanet_map, ppocr_maps.build_formulanet_map)


@pytest.mark.parametrize("kind", ["cls", "slanet", "slanext", "formula"])
def test_official_map_families(kind):
    from tools.convert_weights import _export_for_map

    jm, extra, shape, tm, jmap, tmap = _family(kind)
    flat = perturbed(jm, shape, 31, *extra)
    tree = unflatten_params(flat)
    deploy = _export_for_map(jmap(tree, name=kind), tree)
    cm = tmap(tm, name=kind)
    assert cm.unused_sources(deploy) == []
    assert sorted(s for _, s, _ in cm.rules) == sorted(deploy)
    sd = ppocr_maps.convert_official(tm, cm, deploy)
    ref = params_from_jax(flat)
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert np.array_equal(v, ref[k].numpy()), k
    back = ppocr_maps.jax_flat_params(tm, sd)
    assert set(back) == set(flat)
    for k, v in back.items():
        assert np.array_equal(v, flat[k]), k
    exported = ppocr_maps.export_ppocr_format(
        tm, {k: torch.from_numpy(v.copy()) for k, v in sd.items()},
        hf_prefix="head.decoder." if kind == "formula" else None)
    assert set(exported) == set(deploy)
    for k, v in exported.items():
        assert np.array_equal(v, deploy[k]), k


# ----------------------------- the two converters -----------------------------

@pytest.fixture(scope="module")
def official_sources(tmp_path_factory):
    """Official-name tensors of pp-ocrv5_mobile_det / _rec at full width
    (the port's seeded weights through ``export_ppocr_format``), as the
    safetensors dumps both converters take."""
    from oar_ocr_tpu_torch.models.detection.db import DBNet
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer

    d = tmp_path_factory.mktemp("official")
    out = {}
    for name, model in (("pp-ocrv5_mobile_det", DBNet()),
                        ("pp-ocrv5_mobile_rec", SVTRRecognizer(18385))):
        sd = init_state_dict(model, torch.Generator().manual_seed(4))
        path = str(d / f"{name}.safetensors")
        write_safetensors(ppocr_maps.export_ppocr_format(model, sd), path)
        out[name] = (path, sd)
    return out


@pytest.mark.parametrize("name", ["pp-ocrv5_mobile_det",
                                  "pp-ocrv5_mobile_rec"])
def test_converter_matches_jax_tool(name, official_sources, tmp_path,
                                    monkeypatch):
    from oar_ocr_tpu.models.detection.db import DBNet
    from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer
    from tools import convert_weights as cw
    from tools import port_convert_weights as pcw

    monkeypatch.setitem(cw.MODEL_BUILDERS, "text_detection",
                        lambda v: init_params_fast(DBNet(backbone="lcnet"),
                                                   (1, 64, 64, 3)))
    monkeypatch.setitem(cw.MODEL_BUILDERS, "text_recognition",
                        lambda v: init_params_fast(SVTRRecognizer(
                            vocab_size=cw._rec_vocab_size(v),
                            backbone="lcnet"), (1, 48, 320, 3)))
    src, sd = official_sources[name]
    assert pcw.main(["--model", name, "--source", src,
                     "--out-dir", str(tmp_path / "port")]) == 0
    assert cw.main(["--model", name, "--source", src,
                    "--out-dir", str(tmp_path / "jax")]) == 0
    ours = read_safetensors(str(tmp_path / "port" / f"{name}.safetensors"))
    ref = read_safetensors(str(tmp_path / "jax" / f"{name}.safetensors"))
    assert set(ours) == set(ref)
    for k, v in ours.items():
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        assert np.array_equal(v.view(np.uint32), ref[k].view(np.uint32)), k
    back = params_from_jax(ours)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_converter_describe_and_errors(official_sources, tmp_path, capsys):
    from tools import port_convert_weights as pcw

    assert pcw.main(["--model", "pp-ocrv5_mobile_det", "--describe"]) == 0
    names = capsys.readouterr().out.split()
    src, _ = official_sources["pp-ocrv5_mobile_det"]
    assert sorted(names) == sorted(read_safetensors(src))
    assert "backbone.conv1.bn._mean" in names
    assert pcw.main(["--model", "no-such-model", "--source", src]) == 2
    assert pcw.main(["--model", "paddleocr-vl-0.9b", "--source", src]) == 2
    # the det tensors are no recognizer
    with pytest.raises(ModelLoadError):
        pcw.main(["--model", "pp-ocrv5_mobile_rec", "--source", src,
                  "--out-dir", str(tmp_path)])


@pytest.mark.parametrize("family", ["mineru", "glmocr", "ovisocr2",
                                    "hpd_parsing", "monkeyocrv2",
                                    "mineru_diffusion"])
def test_vl_map_round_trip(family):
    """An exact VL stack's HF-name map (``ppocr_maps.build_vl_map``):
    ``export_vl_format`` then convert gives the state_dict back, bit for
    bit; the flax keys of the artifact (``jax_flat_params``) are the JAX
    tree's (``torch_name`` back gives the port keys); a patch embedding
    stored as the checkpoint's convolution maps onto the Linear that
    computes the same function."""
    from oar_ocr_tpu_torch.runtime.weights import torch_name
    from oar_ocr_tpu_torch.vl.exact_models import (ExactVLMNet,
                                                   exact_state_dict,
                                                   family_spec)

    net = ExactVLMNet(*family_spec(family, tiny=True))
    sd = exact_state_dict(net, torch.Generator().manual_seed(1))
    net.load_state_dict(sd)
    cm = ppocr_maps.build_vl_map(net, name=family)
    deploy = ppocr_maps.export_vl_format(net)
    assert set(deploy) == set(sd) and not cm.unused_sources(deploy)
    back = ppocr_maps.convert_official(net, cm, deploy)
    assert all(np.array_equal(back[k], sd[k].numpy()) for k in sd)
    flat = ppocr_maps.jax_flat_params(net)
    assert {torch_name(k) for k in flat} == set(sd)
    if family == "hpd_parsing":
        assert all(k.startswith(("params/hpd_vision/",
                                 "params/language_model.")) for k in flat)
    # the checkpoint's convolution (D, 3, [t,] p, p) → the patch Linear
    key = next(k for k in sd if any(k.endswith(n + ".weight")
                                    for n in ppocr_maps._PATCH_LINEARS))
    lin = sd[key]
    d, p = lin.shape[0], int(round((lin.shape[1] / 3) ** 0.5))
    if 3 * p * p != lin.shape[1]:
        return                                     # temporal patches
    conv = torch.randn(d, 3, p, p)
    patch = torch.randn(1, 3, p, p)
    flat_in = patch.permute(0, 2, 3, 1).reshape(1, -1)   # (p, p, 3) order
    w = torch.from_numpy(ppocr_maps._hf_patch_conv(conv.numpy()))
    torch.testing.assert_close(flat_in @ w.T,
                               torch.nn.functional.conv2d(patch, conv)
                               .reshape(1, d), rtol=1e-5, atol=1e-5)


def test_vl_converter_matches_jax_tool(tmp_path, monkeypatch):
    """``port_convert_weights --model mineru-2.5`` on the HF-name tensors
    the JAX converter's map expects writes the JAX converter's artifact,
    key for key and bit for bit (the tool's VL builder swapped for the
    development dims)."""
    from oar_ocr_tpu.runtime.weights import flatten_params
    from torch_exact_common import jax_tree
    from tools import convert_weights as cw
    from tools import port_convert_weights as pcw

    from oar_ocr_tpu_torch.runtime.weights import write_safetensors
    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.vl.exact_models import (ExactVLMNet, family_spec,
                                                   mineru_exact)

    ours = mineru_exact(tiny=True, seed=2,
                        runtime=Runtime("float32", device="cpu"))
    tree = jax_tree(ours)
    jcm = cw._vlm_map("mineru-2.5", tree)
    deploy = cw._export_for_map(jcm, tree)
    src = str(tmp_path / "mineru_hf.safetensors")
    write_safetensors(deploy, src)
    monkeypatch.setitem(pcw.MODEL_BUILDERS, "vlm", lambda variant, **_:
                        ExactVLMNet(*family_spec("mineru", tiny=True)))
    assert pcw.main(["--model", "mineru-2.5", "--source", src,
                     "--out-dir", str(tmp_path)]) == 0
    got = read_safetensors(str(tmp_path / "mineru25.safetensors"))
    want = flatten_params(jcm.convert(deploy))
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(v.view(np.uint32),
                              np.asarray(want[k], np.float32).view(
                                  np.uint32)), k
    back = params_from_jax(got)
    assert all(torch.equal(back[k], v)
               for k, v in ours.net.state_dict().items())


def test_port_tools_import_no_jax():
    """The converter modules, the registry, the PDF path and both tools
    load neither jax nor any ``oar_ocr_tpu`` module (in a subprocess,
    where nothing else imported them first)."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import oar_ocr_tpu_torch.registry.models\n"
        "import oar_ocr_tpu_torch.runtime.onnx_extract\n"
        "import oar_ocr_tpu_torch.runtime.ppocr_maps\n"
        "import oar_ocr_tpu_torch.utils.pdf\n"
        "import oar_ocr_tpu_torch.utils.pdf_render\n"
        "import oar_ocr_tpu_torch.utils.visualization\n"
        "import oar_ocr_tpu_torch.core.batch\n"
        "import oar_ocr_tpu_torch.pipelines.processors\n"
        "import port_convert_weights, port_fetch_and_verify\n"
        "port_convert_weights.build_model_and_map('pp-ocrv5_mobile_det')\n"
        "port_convert_weights.build_model_and_map('hpd-parsing-1b')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr

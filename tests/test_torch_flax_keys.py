"""The flax key of every port tensor for each topology the converter
builds, on the CPU.

``runtime/ppocr_maps.jax_flat_key`` inverts ``weights.torch_name``: a
port state_dict key and the module holding it → the flax key of the JAX
package's artifact format. Flax names hold dots (``blocks3.0``,
``head.decoder.model.decoder``) where the port nests modules, so the
inverse groups the key's parts by the converted families' dotted names.
Here, for one registry entry per topology of
``tools/port_convert_weights.py``, at full width, the port module (on
``meta``) gives exactly the JAX module's own flax keys
(``jax.eval_shape`` of its ``init``, no compute), each tensor with the
JAX leaf's number of elements, and the official-name map has one rule a
tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oar_ocr_tpu_torch.runtime import ppocr_maps
from torch_jax_tree import one_torch_thread  # noqa: F401


def flat_shapes(module, shape, *extra):
    """``'/'``-joined flax key → leaf shape of ``module.init`` (no
    compute)."""
    tree = jax.eval_shape(lambda r: module.init(
        r, jnp.zeros(shape, jnp.float32), *extra), jax.random.PRNGKey(0))
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


TOPOLOGIES = ["pp-ocrv5_mobile_det", "pp-ocrv5_server_det",
              "pp-ocrv5_mobile_rec", "pp-ocrv5_server_rec",
              "pp-lcnet_x1_0_doc_ori", "pp-lcnet_x0_25_textline_ori",
              "slanet", "slanext_wired", "pp-formulanet-s",
              "pp-formulanet-l", "pp-doclayout-s",
              "pp-doclayout_plus-l", "uvdoc"]


def _jax_module(name):
    """The module ``tools/convert_weights.py`` builds for ``name``, with
    the example input its init takes."""
    from oar_ocr_tpu.domain.layout import LAYOUT_VARIANTS
    from oar_ocr_tpu.models.classification.pp_lcnet_exact import \
        PPLCNetV1Cls
    from oar_ocr_tpu.models.detection.db import DBNet
    from oar_ocr_tpu.models.detection.picodet_exact import PicoDetExact
    from oar_ocr_tpu.models.detection.rtdetr import RTDETRExact
    from oar_ocr_tpu.models.recognition import pp_formulanet_exact as pf
    from oar_ocr_tpu.models.recognition.slanet_exact import SLANetExact
    from oar_ocr_tpu.models.recognition.slanext_exact import SLANeXtExact
    from oar_ocr_tpu.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu.models.rectification.uvdoc_exact import UVDocNetExact
    from tools.convert_weights import _rec_vocab_size

    bb = "hgnet" if "server" in name else "lcnet"
    if name.endswith("_det"):
        return DBNet(backbone=bb), (1, 64, 64, 3), ()
    if name.endswith("_rec"):
        return (SVTRRecognizer(vocab_size=_rec_vocab_size(name),
                               backbone=bb), (1, 48, 320, 3), ())
    if "lcnet" in name:
        return (PPLCNetV1Cls(class_num=2 if "textline" in name else 4,
                             scale=0.25 if "textline" in name else 1.0),
                (1, 224, 224, 3), ())
    if name == "slanet":
        return SLANetExact(loc_reg_num=4), (1, 488, 488, 3), ()
    if name.startswith("slanext"):
        return SLANeXtExact(), (1, 512, 512, 3), ()
    if "formulanet" in name:
        cfg = pf.PPFormulaNetConfig()
        cfg = cfg.large() if name.endswith("-l") else cfg
        return (pf.PPFormulaNetModule(cfg), (1, *cfg.image_hw, 3),
                (jnp.zeros((1, 1), jnp.int32),))
    if name == "uvdoc":
        return UVDocNetExact(num_filter=32), (1, 712, 488, 3), ()
    v = LAYOUT_VARIANTS[name]
    if v.net.startswith("rtdetr"):
        return (RTDETRExact(num_classes=v.num_classes,
                            arch=v.net.split("-")[1]),
                (1, *v.input_hw, 3), ())
    scale, nf, hc = v.picodet_dims
    return (PicoDetExact(num_classes=v.num_classes, scale=scale,
                         neck_feat=nf, head_convs=hc),
            (1, *v.input_hw, 3), ())


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_flax_keys_of_every_topology(name):
    from tools import port_convert_weights as pcw

    jm, shape, extra = _jax_module(name)
    shapes = flat_shapes(jm, shape, *extra)
    model, cm = pcw.build_model_and_map(name)
    modules = dict(model.named_modules())
    sd = model.state_dict()
    keys = {ppocr_maps.jax_flat_key(k, modules.get(k.rpartition(".")[0])): k
            for k in sd}
    assert set(keys) == set(shapes)
    for fk, tk in keys.items():
        assert np.prod(shapes[fk]) == sd[tk].numel(), fk
    assert len(cm.rules) == len(shapes)

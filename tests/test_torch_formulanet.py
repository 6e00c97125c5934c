"""The port's exact formula models against the JAX package on the CPU:
PP-FormulaNet-S (HGNetV2 + MBart), PP-FormulaNet-L (the full Vary ViT
with ``net_3`` and ``mm_projector_vary`` + MBart) and UniMERNet
(Donut-Swin + MBart).

Models at the tests' size: ``PPFormulaNetConfig().tiny()`` (HGNetV2 "T",
64×64, MBart 32 / 4 heads, vocab 64), ``.tiny_large()`` (a 4-layer Vary
ViT of 16 at 32×32, MBart 24) and ``UniMERNetConfig().tiny()`` (Swin 16
of depths (1, 2) at 32×48, MBart 32). Weights: the JAX modules'
``eval_shape`` leaves materialized by ``init_params_fast_fn`` plus seeded
numpy noise of 0.1 (BatchNorm variances in [0.75, 1.25]), carried to the
port by ``runtime/weights.params_from_jax`` and loaded strictly (every
JAX parameter maps, none is left). Inputs and crops from numpy seeds.

Gates: the encoder sequence and the decoder's logits on seeded ids
within 1e-5 of max|ref|; the recognizers' strings identical at
``max_new_tokens=7`` (the JAX host's ``(x/255 − mean)/std`` against the
port's K1 plain version).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.models.recognition import pp_formulanet_exact as jp
from oar_ocr_tpu.models.recognition import unimernet as ju
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.runtime import init_params_fast_fn
from oar_ocr_tpu.runtime.weights import flatten_params, unflatten_params
from oar_ocr_tpu_torch.models.layers import load_weights
from oar_ocr_tpu_torch.models.recognition import pp_formulanet_exact as tp
from oar_ocr_tpu_torch.models.recognition import unimernet as tu
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax

from test_torch_formula import formula_crops, perturbed, rel_err

REL = 1e-5
# name → (JAX config, port config, JAX module, port module, JAX
# recognizer, port recognizer)
MODELS = {
    "s": (jp.PPFormulaNetConfig().tiny(), tp.PPFormulaNetConfig().tiny(),
          jp.PPFormulaNetModule, tp.PPFormulaNetModule,
          jp.PPFormulaNetRecognizer, tp.PPFormulaNetRecognizer),
    "l": (jp.PPFormulaNetConfig().tiny_large(),
          tp.PPFormulaNetConfig().tiny_large(),
          jp.PPFormulaNetModule, tp.PPFormulaNetModule,
          jp.PPFormulaNetRecognizer, tp.PPFormulaNetRecognizer),
    "unimernet": (ju.UniMERNetConfig().tiny(), tu.UniMERNetConfig().tiny(),
                  ju.UniMERNetModule, tu.UniMERNetModule,
                  ju.UniMERNetRecognizer, tu.UniMERNetRecognizer),
}
_PAIRS = {}


class Pair:
    """A model's JAX module and port module on the same seeded weights;
    ``replace`` changes both configs' fields alike."""

    def __init__(self, name, **replace):
        (jcfg, tcfg, jmod, tmod, self.jrec, self.trec) = MODELS[name]
        self.jcfg = dataclasses.replace(jcfg, **replace)
        self.tcfg = dataclasses.replace(tcfg, **replace)
        self.module = jmod(self.jcfg)
        hw = self.jcfg.image_hw
        leaves = init_params_fast_fn(lambda r: self.module.init(
            r, jnp.zeros((1, *hw, 3), jnp.float32),
            jnp.zeros((1, 2), jnp.int32)))
        self.flat = perturbed(flatten_params(leaves), 7, 0.1)
        self.params = unflatten_params(self.flat)
        self.state = params_from_jax(self.flat)
        self.port = load_weights(tmod(self.tcfg), self.state)
        self.encode = jax.jit(lambda p, x: self.module.apply(
            p, x, method=type(self.module).encode))
        self.decode = jax.jit(lambda p, ids, enc: self.module.apply(
            p, ids, enc, method=type(self.module).decode))


def pair(name) -> Pair:
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name)
    return _PAIRS[name]


@pytest.mark.parametrize("name", list(MODELS))
def test_configs_match(name):
    jcfg, tcfg = MODELS[name][:2]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if name != "unimernet":
        assert dataclasses.asdict(tcfg.mbart()) == \
            dataclasses.asdict(jcfg.mbart())
        for make in ("large", "tiny", "tiny_large"):
            assert dataclasses.asdict(getattr(tp.PPFormulaNetConfig(),
                                              make)()) == \
                dataclasses.asdict(getattr(jp.PPFormulaNetConfig(), make)())


@pytest.mark.parametrize("name", list(MODELS))
def test_weights_convert_strictly(name):
    """Every JAX parameter maps onto the port and none is left; the
    L model has the projector and ``net_3``, S the bridge, and
    UniMERNet's MBart sits at ``decoder.model.decoder``."""
    p = pair(name)
    keys = set(p.port.state_dict())
    assert keys == set(p.state)
    want = {"s": "head.enc_to_dec_proj.weight",
            "l": "backbone.mm_projector_vary.weight",
            "unimernet": "decoder.model.decoder.layers.1.fc2.weight"}[name]
    assert want in keys
    if name == "l":
        assert "backbone.vision_tower_high.net_3.weight" in keys
        assert not any("enc_to_dec_proj" in k for k in keys)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_decode_match(name, seed):
    p = pair(name)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, *p.jcfg.image_hw, 3)).astype(np.float32)
    enc_j = p.encode(p.params, jnp.asarray(x))
    with torch.no_grad():
        enc_t = p.port.encode(torch.from_numpy(x))
        assert rel_err(enc_t, enc_j) <= REL
        ids = rng.integers(0, p.jcfg.vocab_size, (2, 8)).astype(np.int32)
        lj = p.decode(p.params, jnp.asarray(ids), enc_j)
        lt = p.port.decode(torch.from_numpy(ids).long(), enc_t)
    assert rel_err(lt, lj) <= REL


@pytest.mark.parametrize("name", list(MODELS))
def test_recognizer_strings_match(name):
    p = pair(name)
    crops = formula_crops(11, n=3)
    want = p.jrec(p.params, cfg=p.jcfg, runtime=JRuntime(JRuntimeConfig(
        compute_dtype="float32", use_mesh=False))).recognize(
            crops, max_new_tokens=7)
    got = p.trec(p.state, cfg=p.tcfg, runtime=Runtime(
        "float32", device="cpu")).recognize(crops, max_new_tokens=7)
    assert got == want
    assert all(s for s in got)


def test_recognizer_edges():
    """No crops → []; the S adapter's ``FormulaResult``s; a vocab renders
    the ids."""
    rt = Runtime("float32", device="cpu")
    cfg = tp.PPFormulaNetConfig().tiny()
    vocab = [f"v{i}" for i in range(cfg.vocab_size)]
    rec = tp.PPFormulaNetRecognizer(None, cfg=cfg, vocab=vocab, runtime=rt)
    assert rec.recognize([]) == []
    crops = formula_crops(3, n=2)
    texts = rec.recognize(crops, max_new_tokens=4)
    assert all(t.startswith("v") for t in texts)
    # the adapter decodes up to 96 tokens: positions for 128
    adapter = tp.PPFormulaNetExactAdapter(
        None, cfg=dataclasses.replace(cfg, max_positions=128), vocab=vocab,
        runtime=rt)
    res = adapter.recognize(crops)
    assert [r.score for r in res] == [1.0, 1.0]
    assert all(r.latex == " ".join(r.latex.split()) for r in res)
    uni = tu.UniMERNetRecognizer(None, cfg=tu.UniMERNetConfig().tiny(),
                                 runtime=rt)
    assert uni.recognize([]) == []
    assert len(uni.recognize(crops, max_new_tokens=3)) == 2

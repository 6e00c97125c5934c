"""The table models' decode graph and their K1 inputs on the card.

The CPU side is held to the JAX package in ``tests/test_torch_tables.py``
and ``tests/test_torch_table_pipeline.py``; this file imports only the
port (the card's machine has no flax). Every test needs a card and is
marked ``cuda``. Models at the tests' size (as ``test_torch_tables.py``)
on seeded weights; the decoders' EOS logit raised so that the rows of a
batch finish at different steps, and the ``<td></td>`` logit so that
they emit cells.

Gates: the decode graph against the eager loop on the card, both from
the same memory: the same steps run, and logits and corners bit-equal
over the whole buffers (the graph writes the pre-fill once every row is
done), at 6 rows and at 5; a second decode of a batch replays its
captured graph with no new capture. K1 at each table model's input (SLANet: the 488×488 warp into
the compute dtype; SLANet_plus and SLANeXt: the keep-ratio canvas,
float32, the pad 0 after normalizing) against its plain version:
float32 ≤ 1e-6 absolute, bfloat16 ≤ 1 ulp.
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.models.layers import init_state_dict
from oar_ocr_tpu_torch.models.recognition.sla_decode import (EOS_ID,
                                                             DecodeGraphs)
from oar_ocr_tpu_torch.models.recognition.slanet import SLANet, SLANetModel
from oar_ocr_tpu_torch.models.recognition.slanet_exact import (
    SLANetExact, SLANetExactModel)
from oar_ocr_tpu_torch.models.recognition.slanext_exact import (
    SLANeXtExact, SLANeXtExactModel)
from oar_ocr_tpu_torch.ops import normalize
from oar_ocr_tpu_torch.runtime.runtime import Runtime

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

pytestmark = pytest.mark.cuda

NEXT_KW = dict(dim=64, depth=2, heads=2, window=4, global_idx=(1,),
               pos_grid=8, out_chans=32, net2_out=48, hidden_size=32)
TD_ID = 8
# name → (port model, generator bias key, EOS bias, memory channels)
MODELS = {
    "slanet": (lambda: SLANet(backbone_scale=0.25, max_steps=40),
               "SLAHead_0.cell.out_struct.bias", 96),
    "slanet_plus": (lambda: SLANetExact(scale=0.25, max_text_length=40),
                    "head.structure_generator.1.bias", 96),
    "slanext": (lambda: SLANeXtExact(max_text_length=40, **NEXT_KW),
                "head.structure_generator.1.bias", 48),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph and K1 run only "
                    "there")


def _head(name, eos_bias):
    make, key, _c = MODELS[name]
    model = make()
    sd = init_state_dict(model, torch.Generator().manual_seed(7))
    sd[key] = sd[key].clone()
    sd[key][EOS_ID] += eos_bias
    sd[key][TD_ID] += 1.0
    model.load_state_dict(sd, strict=True)
    return model.eval().requires_grad_(False).cuda().head


@pytest.mark.parametrize("name", list(MODELS))
def test_graph_equals_eager(name):
    """The captured chunks against the eager loop, bit for bit, at 6 rows
    and at 5 (a graph of its own); the second decode of a batch only
    replays."""
    _need_card()
    c = MODELS[name][2]
    memory = torch.randn((6, 16, c), generator=torch.Generator()
                         .manual_seed(3)).cuda() * 2.0
    for eos_bias in (0.0, 2.0, 4.0):
        head = _head(name, eos_bias)
        el, eo, esteps = head.decode(memory)
        graphs = DecodeGraphs(head)
        gl, go, gsteps = graphs.decode(memory)
        assert gsteps == esteps
        assert torch.equal(gl, el) and torch.equal(go, eo)
        st = next(iter(graphs.states.values()))
        graph = st.graph
        gl2, _go2, _s = graphs.decode(memory * 0.5)
        assert st.graph is graph                  # replayed, not recaptured
        el2, _eo2, _s = head.decode(memory * 0.5)
        assert torch.equal(gl2, el2)
        gl3, go3, gsteps3 = graphs.decode(memory[:5])   # a second key
        assert len(graphs.states) == 2 and st.graph is graph
        el3, eo3, esteps3 = head.decode(memory[:5])
        assert gsteps3 == esteps3
        assert torch.equal(gl3, el3) and torch.equal(go3, eo3)
        ids = el.argmax(-1).cpu().numpy()
        if esteps < head.steps:                   # an early exit
            assert all((row == EOS_ID).any() for row in ids)


def _k1_inputs(model, pages, regions):
    """The first K1 input a table model's ``recognize`` hands to
    ``normalize_masked`` (the gather's float32 tile and its arguments)."""
    from oar_ocr_tpu_torch.ops import warp

    seen, launch = [], warp.normalize_masked

    def record(x, alpha, beta, **kw):
        if not seen:
            seen.append((x, alpha, beta, kw))
        return launch(x, alpha, beta, **kw)

    warp.normalize_masked = record
    try:
        model.recognize(pages, regions)
    finally:
        warp.normalize_masked = launch
    return seen[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_at_table_inputs(dtype):
    """K1 at the three table models' inputs against ``normalize_ref``."""
    _need_card()
    rt = Runtime(dtype, device="cuda", cfg=ONE_DEVICE)
    rng = np.random.default_rng(0)
    pages = torch.from_numpy(rng.integers(0, 255, (2, 320, 480, 3),
                                          dtype=np.uint8)).cuda()
    regions = [(0, (10, 20, 300, 200)), (1, (40, 30, 460, 150))]
    models = [SLANetModel(runtime=rt, backbone_scale=0.25, max_steps=4),
              SLANetExactModel(runtime=rt, scale=0.25, max_text_length=4),
              SLANeXtExactModel(runtime=rt, input_size=128,
                                max_text_length=4, **NEXT_KW)]
    for model in models:
        x, alpha, beta, kw = _k1_inputs(model, pages, regions)
        assert kw["caller"] == "table"
        args = {k: kw[k] for k in ("valid_h", "valid_w", "pad", "swap_rb")}
        out = kw["out_dtype"]
        before = normalize.LAUNCHES_BY_CALLER["table"]
        got = normalize.normalize_masked(x, alpha, beta, out_dtype=out,
                                         caller="table", **args)
        assert normalize.LAUNCHES_BY_CALLER["table"] == before + 1
        ref = normalize.normalize_ref(x, alpha, beta, out_dtype=out, **args)
        if out == torch.bfloat16:
            ulps = (got.view(torch.int16).int()
                    - ref.view(torch.int16).int()).abs().max()
            assert int(ulps) <= 1
        else:
            assert float((got - ref).abs().max()) <= 1e-6
        if isinstance(model, SLANetModel):
            assert out == rt.compute_dtype
        else:
            assert out == torch.float32 and float(
                got[:, -1, -1].abs().max()) == 0.0   # the pad, 0.0

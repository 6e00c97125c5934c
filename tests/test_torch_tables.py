"""The port's three table-structure models against the JAX package on the
CPU, in float32.

Models at the tests' size, one fixture each, as
``test_slanet_parity.py`` / ``test_slanext_parity.py`` size them:
SLANet (PP-LCNetV3 ×0.25, hidden 256, 10 steps), SLANet_plus (PP-LCNet
×0.25, CSP-PAN 96, hidden 256, 8 + 1 steps) and SLANeXt (ViT dim 64,
depth 2, 2 heads, window 4, global block 1, hidden 32, 8 + 1 steps).
Weights: the JAX model's ``init_params_fast`` leaves plus seeded numpy
noise of 0.1 (0.3 for SLANeXt's early-exit head; BatchNorm variances in
[0.75, 1.25]), carried to the port by
``runtime/weights.params_from_jax`` and loaded strictly (every JAX
parameter maps, none is left). Inputs from numpy seeds.

Gates: logits and corners within 1e-5 of max|ref| (the two frameworks
sum convolutions and products in other orders; the readings were
≤ 1.3e-6), and the same argmax ids. The early-exit test runs each head
alone on a seeded (6, 16, C) memory with an EOS logit bias, picked from
the JAX head's own output, under which its rows finish at different
steps before the trip limit (a random decoder barely reads a random
image's pooled features, so whole models on random images finish all
rows at one step), and holds the port's eager loop to the JAX
``nn.while_loop``: the same ids over the whole buffer, logits and
corners within 1e-5 of max|ref|, confidences (the max softmax
probability) within 1e-5, and the pre-fill past the stop exact. The
memories are chosen well conditioned too: at 10× SLANet's (6, 16, 96)
memory both float32 decoders sit ~1e-4 of max|logit| from a float64 run
of the same head (1.25e-4 the port, 1.05e-4 the JAX package), so 1e-5
between them would hold by luck.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.models.recognition.slanet import SLAHead as JSLAHead
from oar_ocr_tpu.models.recognition.slanet import SLANet as JSLANet
from oar_ocr_tpu.models.recognition.slanet_exact import \
    SLAHeadExact as JSLAHeadExact
from oar_ocr_tpu.models.recognition.slanet_exact import \
    SLANetExact as JSLANetExact
from oar_ocr_tpu.models.recognition.slanext_exact import \
    SLANeXtExact as JSLANeXt
from oar_ocr_tpu.models.recognition.slanext_exact import \
    _get_rel_pos as j_get_rel_pos
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import flatten_params, unflatten_params
from oar_ocr_tpu_torch.models.layers import load_weights
from oar_ocr_tpu_torch.models.recognition.sla_decode import (
    EOS_ID, DecodeGraphs, DecodeState)
from oar_ocr_tpu_torch.models.recognition.slanet import (GRUWeights,
                                                         SLANet, gru_step)
from oar_ocr_tpu_torch.models.recognition.slanet_exact import SLANetExact
from oar_ocr_tpu_torch.models.recognition.slanext_exact import (
    SLANeXtExact, get_rel_pos, resize_linear)
from oar_ocr_tpu_torch.runtime.weights import params_from_jax

REL = 1e-5
NEXT_KW = dict(dim=64, depth=2, heads=2, window=4, global_idx=(1,),
               pos_grid=8, out_chans=32, net2_out=48, hidden_size=32)

# model → (JAX model, port model, input side, the early-exit test's
# weight noise, JAX head alone, its parameters' root, memory channels,
# memory scale, memory seed, EOS bias): under the bias the early-exit
# test's rows finish at steps [5, 0, 2, 0, 0, 1] (SLANet),
# [0, 0, 0, 3, 0, 2] (SLANet_plus) and [0, 0, 0, 0, 3, 0] (SLANeXt), each
# bias inside a range of ≥ 0.2 that gives the same steps
MODELS = {
    "slanet": (lambda: JSLANet(backbone_scale=0.25, max_steps=10),
               lambda: SLANet(backbone_scale=0.25, max_steps=10), 96, 0.1,
               lambda: JSLAHead(50, max_steps=10), "SLAHead_0", 96, 2.0, 0,
               1.45),
    "slanet_plus": (lambda: JSLANetExact(scale=0.25, max_text_length=8),
                    lambda: SLANetExact(scale=0.25, max_text_length=8), 96,
                    0.1, lambda: JSLAHeadExact(50, 256, 8, 8), "head", 96,
                    10.0, 5, 4.7),
    "slanext": (lambda: JSLANeXt(max_text_length=8, **NEXT_KW),
                lambda: SLANeXtExact(max_text_length=8, **NEXT_KW), 112,
                0.3, lambda: JSLAHeadExact(50, 32, 8, 8), "head", 48, 3.0,
                5, 6.0),
}
BIAS_KEY = {"SLAHead_0": "params/SLAHead_0/cell/out_struct/bias",
            "head": "params/head/structure_generator.1/bias"}


def perturbed(flat, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.random(np.shape(v)) * 0.5 + 0.75).astype(np.float32)
            if k.endswith("/var") else
            (np.asarray(v, np.float32) + rng.normal(0, scale, np.shape(v))
             ).astype(np.float32) for k, v in sorted(flat.items())}


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


class Pair:
    """A JAX model, its jitted apply, its perturbed flat parameters, and
    the port model on them."""

    def __init__(self, name):
        (j_make, t_make, self.side, noise, head, self.root, self.mem_c,
         self.mem_scale, self.mem_seed, self.bias) = MODELS[name]
        self.module = j_make()
        leaves = flatten_params(init_params_fast(
            self.module, (1, self.side, self.side, 3)))
        self.flat = perturbed(leaves, 31, 0.1)
        self.exit_flat = perturbed(leaves, 31, noise)
        self.apply = jax.jit(self.module.apply)
        self.head_apply = jax.jit(head().apply)
        self.t_make = t_make

    def port(self, flat):
        return load_weights(self.t_make(), params_from_jax(flat))

    def inputs(self, seed, n=3):
        return np.random.default_rng(seed).normal(
            0, 1, (n, self.side, self.side, 3)).astype(np.float32)

    def run(self, flat, x):
        jl, jo = self.apply(unflatten_params(flat), x)
        tl, to, steps = self.port(flat)(torch.from_numpy(x).permute(
            0, 3, 1, 2))
        return (np.asarray(jl), np.asarray(jo), tl.numpy(), to.numpy(),
                steps)


@pytest.fixture(scope="module")
def slanet():
    return Pair("slanet")


@pytest.fixture(scope="module")
def slanet_plus():
    return Pair("slanet_plus")


@pytest.fixture(scope="module")
def slanext():
    return Pair("slanext")


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches(name, seed, request):
    """Logits and corners of the whole decode within 1e-5 of max|ref|,
    the same ids."""
    pair = request.getfixturevalue(name)
    jl, jo, tl, to, _ = pair.run(pair.flat, pair.inputs(seed))
    assert rel_err(tl, jl) <= REL
    assert rel_err(to, jo) <= REL
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def exit_case(pair):
    """The early-exit tests' flat parameters (the EOS bias added) and
    their (6, 16, C) seeded memory."""
    flat = dict(pair.exit_flat)
    key = BIAS_KEY[pair.root]
    flat[key] = flat[key].copy()
    flat[key][EOS_ID] += pair.bias
    memory = (np.random.default_rng(pair.mem_seed).normal(
        0, 1, (6, 16, pair.mem_c))
              * pair.mem_scale).astype(np.float32)
    return flat, memory


@pytest.mark.parametrize("name", list(MODELS))
def test_early_exit_matches_while_loop(name, request):
    """Each head alone on a seeded memory, with an EOS bias under which
    its rows finish at different steps before the trip limit: the eager
    loop stops where ``nn.while_loop`` does, with the same ids, and the
    buffers (the pre-fill after the stop) within 1e-5;
    ``DecodeGraphs.decode`` on the CPU is that loop."""
    pair = request.getfixturevalue(name)
    flat, memory = exit_case(pair)
    x = memory if pair.root == "SLAHead_0" else memory.reshape(
        6, 4, 4, pair.mem_c)
    jl, jo = pair.head_apply(
        {"params": unflatten_params(flat)["params"][pair.root]}, x)
    jl, jo = np.asarray(jl), np.asarray(jo)
    head = pair.port(flat).head
    tl, to, steps = head.decode(torch.from_numpy(memory))
    tl, to = tl.numpy(), to.numpy()
    ids = jl.argmax(-1)
    first_eos = [int(np.argmax(row == EOS_ID)) for row in ids]
    assert all((row == EOS_ID).any() for row in ids)
    assert len(set(first_eos)) > 1, first_eos          # rows finish apart
    assert steps == max(first_eos) + 1 < ids.shape[1]  # stopped early
    np.testing.assert_array_equal(tl.argmax(-1), ids)
    assert rel_err(tl, jl) <= REL
    conf = torch.softmax(torch.from_numpy(tl), -1).amax(-1).numpy()
    j_conf = np.asarray(jax.nn.softmax(jl, -1).max(-1))
    assert np.abs(conf - j_conf).max() <= REL
    assert rel_err(to, jo) <= REL
    # the pre-fill past the stop: EOS logit 1.0, everything else 0
    assert (tl[:, steps:, EOS_ID] == 1.0).all()
    assert (np.delete(tl[:, steps:], EOS_ID, -1) == 0).all()
    assert (to[:, steps:] == 0).all()
    gl, go, gsteps = DecodeGraphs(head).decode(torch.from_numpy(memory))
    assert gsteps == steps
    assert np.array_equal(gl.numpy(), tl) and np.array_equal(go.numpy(), to)


@pytest.mark.parametrize("grid", [30, 32])
def test_rel_pos_and_pos_embed_resize(grid):
    """SLANeXt at 488 px: a grid of 30 against the checkpoint's 32; the
    global blocks' rel-pos tables (63 → 59) and ``pos_embed``
    (32×32 → 30×30) as ``jax.image.resize(linear, antialias=False)``."""
    rng = np.random.default_rng(grid)
    table = rng.normal(0, 1, (63, 64)).astype(np.float32)
    ref = np.asarray(j_get_rel_pos(grid, jnp.asarray(table)))
    got = get_rel_pos(grid, torch.from_numpy(table)).numpy()
    assert got.shape == (grid, grid, 64)
    assert rel_err(got, ref) <= REL
    pos = rng.normal(0, 1, (1, 32, 32, 48)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(pos), (1, grid, grid, 48),
                                      method="linear", antialias=False))
    got = resize_linear(torch.from_numpy(pos), (1, grid, grid, 48)).numpy()
    assert rel_err(got, ref) <= REL


def test_flax_gru_cell_map():
    """The flax ``nn.GRUCell`` of SLANet's decoder against the port's
    fused Paddle-layout :func:`gru_step` on ``params_from_jax``'s fused
    weights."""
    import flax.linen as nn

    hidden, in_dim = 24, 40
    cell = nn.GRUCell(hidden)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (5, in_dim)).astype(np.float32)
    h = rng.normal(0, 1, (5, hidden)).astype(np.float32)
    params = cell.init(jax.random.PRNGKey(0), h, x)
    flat = perturbed(flatten_params(jax.tree.map(np.asarray, params)), 4,
                     0.1)
    ref, _ = cell.apply(unflatten_params(flat), h, x)
    flat = {k.replace("params/", "params/cell/gru/"): v
            for k, v in flat.items()}
    sd = params_from_jax(flat)
    assert sorted(sd) == ["cell.gru.bias_hh", "cell.gru.bias_ih",
                          "cell.gru.weight_hh", "cell.gru.weight_ih"]
    w = GRUWeights(in_dim, hidden)
    w.load_state_dict({k.split(".")[-1]: v for k, v in sd.items()},
                      strict=True)
    with torch.no_grad():
        got = gru_step(torch.from_numpy(x), torch.from_numpy(h), w)
    assert rel_err(got.numpy(), np.asarray(ref)) <= REL
    assert (sd["cell.gru.bias_hh"][:2 * hidden] == 0).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_captured_step_matches_eager(name, request):
    """The captured step's body (``DecodeState.run_step``) run eagerly on
    the early-exit case, over the whole padded length as the card's
    replays run it: it counts the eager loop's steps, gives the same
    ids, buffers within 1e-5 of the eager loop's, and the pre-fill past
    its stop."""
    pair = request.getfixturevalue(name)
    flat, memory = exit_case(pair)
    head = pair.port(flat).head
    el, eo, steps = head.decode(torch.from_numpy(memory))
    st = DecodeState(head, torch.from_numpy(memory))
    st.start(torch.from_numpy(memory))
    with torch.no_grad():
        for _ in range(st.length):
            st.run_step()
    assert int(st.ran) == steps < head.steps
    gl, go = st.lbuf[:, :head.steps], st.obuf[:, :head.steps]
    np.testing.assert_array_equal(gl.argmax(-1).numpy(),
                                  el.argmax(-1).numpy())
    assert rel_err(gl.numpy(), el.numpy()) <= REL
    assert rel_err(go.numpy(), eo.numpy()) <= REL
    assert torch.equal(gl[:, steps:], el[:, steps:])
    assert torch.equal(go[:, steps:], eo[:, steps:])

"""The port's default formula recognizer against the JAX package on the
CPU.

Model at the tests' size: ``PPFormulaNet(vocab 64, dim 32, 2 decoder
layers, 4 heads, max_len 16)`` (the encoder's conv widths and its 8-head
block are fixed by the module), on the JAX model's ``init_params_fast``
leaves plus seeded numpy noise of 0.1 (BatchNorm variances in [0.75,
1.25]), carried to the port by ``runtime/weights.params_from_jax`` and
loaded strictly. Inputs and crops from numpy seeds.

Gates: the encoder's memory within 1e-5 of max|ref|; the whole 16-step
decode (the JAX ``nn.scan`` against the port's eager loop) with
identical ids and probs within 1e-5; ``recognize`` on seeded crops with
identical LaTeX and scores within 1e-5 in float32, the JAX host's
``(x/255 − 0.5)/0.5`` against the port's K1 plain version. Under a
bfloat16 Runtime (JAX ``compute_dtype="bfloat16"``) the encoder runs
bfloat16 on both sides and the decoder float32. Two frameworks round
bfloat16 convolutions in different orders (the memories differ by
~1.5e-2 of max, and JAX's own jitted and op-by-op encoders by as much),
and a random decoder has steps whose top-2 logits lie closer than that
moves them (3.8e-4 apart on one of the four rows here), so the bfloat16
test holds the decoder to JAX's ids step by step and compares the LaTeX
of the rows no near-tie decides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.models.recognition import formula as jf
from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu.runtime.runtime import init_params_fast
from oar_ocr_tpu.runtime.weights import flatten_params, unflatten_params
from oar_ocr_tpu_torch.models.layers import load_weights
from oar_ocr_tpu_torch.models.recognition import formula as tf
from oar_ocr_tpu_torch.models.recognition.formula_decode import (
    FormulaDecodeGraphs, decode_eager)
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.runtime.weights import params_from_jax

KW = dict(vocab_size=64, dim=32, dec_layers=2, heads=4, max_len=16)
MODEL_KW = dict(dim=32, dec_layers=2, heads=4)
INPUT_HW = (64, 96)
REL = 1e-5


def perturbed(flat, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.random(np.shape(v)) * 0.5 + 0.75).astype(np.float32)
            if k.endswith("/var") else
            (np.asarray(v, np.float32) + rng.normal(0, scale, np.shape(v))
             ).astype(np.float32) for k, v in sorted(flat.items())}


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def formula_crops(seed, n=4):
    """White crops of different sizes with dark strokes (bars, boxes,
    lines) and a white margin."""
    rng = np.random.default_rng(seed)
    crops = []
    for _ in range(n):
        h, w = int(rng.integers(20, 90)), int(rng.integers(40, 300))
        img = np.full((h, w, 3), 255, np.uint8)
        for _ in range(int(rng.integers(3, 9))):
            y, x = int(rng.integers(2, h - 4)), int(rng.integers(2, w - 6))
            img[y:y + int(rng.integers(2, 12)),
                x:x + int(rng.integers(2, 40))] = int(rng.integers(0, 120))
        crops.append(img)
    return crops


class Pair:
    def __init__(self):
        self.module = jf.PPFormulaNet(**KW)
        self.flat = perturbed(flatten_params(init_params_fast(
            self.module, (1, *INPUT_HW, 3))), 1, 0.1)
        self.params = unflatten_params(self.flat)
        self.apply = jax.jit(self.module.apply)
        self.state = params_from_jax(self.flat)

    def port(self):
        return load_weights(tf.PPFormulaNet(**KW), self.state)

    def jax_recognizer(self, dtype):
        rec = jf.FormulaRecognizer.__new__(jf.FormulaRecognizer)
        rec.runtime = JRuntime(JRuntimeConfig(compute_dtype=dtype,
                                              use_mesh=False))
        rec.vocab = None
        rec.INPUT_HW = INPUT_HW
        rec.model = self.module
        rec.params = self.params
        rec._step = self.apply
        return rec

    def port_recognizer(self, dtype):
        return tf.FormulaRecognizer(
            self.state, vocab_size=KW["vocab_size"], max_len=KW["max_len"],
            input_hw=INPUT_HW, runtime=Runtime(dtype, device="cpu"),
            **MODEL_KW)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def inputs(seed, n=3):
    return np.random.default_rng(seed).normal(
        0, 1, (n, *INPUT_HW, 3)).astype(np.float32)


def jax_memory(pair, x):
    enc = jf.FormulaEncoder(KW["dim"])
    variables = {col: tree["FormulaEncoder_0"]
                 for col, tree in pair.params.items()}
    return np.asarray(enc.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_matches(pair, seed):
    x = inputs(seed)
    got = pair.port().encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(got, jax_memory(pair, x)) <= REL


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 1), (2, 5)])
def test_scan_matches(pair, seed, n):
    """The whole fixed-length decode: ids identical over all 16 steps,
    probs within 1e-5."""
    x = inputs(seed, n)
    jids, jprobs = pair.apply(pair.params, x)
    ids, probs = pair.port()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert float(np.abs(probs.numpy() - np.asarray(jprobs)).max()) <= REL


def test_teacher_forcing_and_graph_entry(pair):
    """Fed its own ids, the eager loop repeats its free run (logits
    included); on a CPU tensor :class:`FormulaDecodeGraphs` runs the
    eager loop and reports one fetch."""
    model = pair.port()
    x = torch.from_numpy(inputs(3)).permute(0, 3, 1, 2)
    mk, mv = model.prefill(model.encode(x))
    ids, probs, logits = decode_eager(model.decoder, mk, mv,
                                      return_logits=True)
    fed = decode_eager(model.decoder, mk, mv, feed=ids, return_logits=True)
    assert torch.equal(fed[0], ids) and torch.equal(fed[2], logits)
    assert torch.equal(ids, logits.argmax(-1))
    graphs = FormulaDecodeGraphs(model.decoder)
    gi, gp = graphs.decode(mk, mv)
    assert torch.equal(gi, ids) and torch.equal(gp, probs)
    assert graphs.last == {"steps": 16, "replays": 0, "syncs": 1}
    assert not graphs.states


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recognize_matches_f32(pair, seed):
    crops = formula_crops(seed)
    want = pair.jax_recognizer("float32").recognize(crops)
    got = pair.port_recognizer("float32").recognize(crops)
    assert [r.latex for r in got] == [r.latex for r in want]
    assert all(r.latex for r in got)
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], atol=REL, rtol=0)


def test_recognize_matches_bf16(pair):
    """Under bfloat16: the inputs bit-equal (K1's plain version against
    the JAX host's normalize, both rounded to bfloat16), the memory
    within 2^-5·max|ref| of the JAX encoder's, and the decoder fed the
    JAX decode's ids: at every step the JAX id is the port's argmax or
    within 2^-5·max|logit| of it (a near-tie bfloat16 decides; counted).
    Rows without a near-tie give identical LaTeX, scores within 2^-5."""
    crops = formula_crops(5)
    want = pair.jax_recognizer("bfloat16").recognize(crops)
    rec = pair.port_recognizer("bfloat16")
    assert rec.model.FormulaEncoder_0.ConvBNAct_0.Conv_0.weight.dtype == \
        torch.bfloat16
    assert rec.model.decoder.lm_head.weight.dtype == torch.float32
    assert rec.model.mem_k0.weight.dtype == torch.float32
    got = rec.recognize(crops)

    x = rec.inputs(crops)
    xj = jnp.asarray((tf.formula_canvas(crops, INPUT_HW).astype(np.float32)
                      / 255.0 - 0.5) / 0.5, jnp.bfloat16)
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(xj.astype(jnp.float32)))
    memory = rec.model.encode(x.permute(0, 3, 1, 2))
    mem_err = rel_err(memory, jax_memory(pair, xj).astype(np.float32))
    assert mem_err <= 2.0 ** -5

    jids = torch.from_numpy(np.asarray(pair.apply(pair.params, xj)[0],
                                       np.int64))
    _, _, logits = decode_eager(rec.model.decoder,
                                *rec.model.prefill(memory), feed=jids,
                                return_logits=True)
    gap = logits.amax(-1) - logits.gather(-1, jids[..., None])[..., 0]
    tol = 2.0 ** -5 * logits.abs().amax((1, 2))[:, None]
    assert bool((gap <= tol).all())
    tied = (gap > 0).any(-1)
    print(f"bf16 memory rel err {mem_err!r}; rows decided by a near-tie "
          f"{tied.tolist()}, their gaps {gap[gap > 0].tolist()}")
    rows = [i for i in range(len(crops)) if not tied[i]]
    assert len(rows) >= 2
    for i in rows:
        assert got[i].latex == want[i].latex
        assert abs(got[i].score - want[i].score) <= 2.0 ** -5


def test_recognize_edges():
    """No crops → []; a blank crop (no margin to cut) still decodes; the
    vocab renders ids and drops the control artifacts."""
    rt = Runtime("float32", device="cpu")
    vocab = ["<s>", "<pad>", "</s>"] + [f"t{i}" for i in range(61)]
    rec = tf.FormulaRecognizer(None, vocab=vocab, max_len=8,
                               input_hw=INPUT_HW, runtime=rt, **MODEL_KW)
    assert rec.recognize([]) == []
    out = rec.recognize([np.full((30, 50, 3), 255, np.uint8)])
    assert len(out) == 1 and 0.0 <= out[0].score <= 1.0
    assert "⟨" not in out[0].latex
    r = tf.decode_ids(np.array([0, 5, 1, 3, 2, 7]),
                      np.array([0.9, 0.5, 0.9, 0.25, 0.9, 0.9]), vocab)
    assert (r.latex, r.score) == ("t2t0", 0.375)

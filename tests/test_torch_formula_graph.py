"""The exact formula models' decode forwards (``models/recognition/
exact_decode.py``) and their shared host loops against the JAX package on
the CPU: PP-FormulaNet-S (3 rows a forward), -L (1 row) and UniMERNet
(1 row).

Models: ``test_torch_formulanet.py``'s tiny configs with
``max_positions`` raised to 256 in both packages (the last bucket), on
its seeded weights (``Pair``), one pair per model for this module.

- The body the card's graph captures (``ExactForwardGraphs`` on its
  static buffers, run eagerly here) against the argmax of the JAX
  ``_decode``'s logits at the same padded query and rows, at every
  bucket 8-256, on seeded query ids (not free-running, so that no early
  ``eos`` leaves a bucket untested); and against the eager forward.
- The recognizers' strings (the factored host loop on the eager forward)
  against the JAX recognizers' at ``LOOP_TOKENS`` new tokens, which
  cross at least two buckets; at least one crop emits past 8 tokens. The
  same loop through ``ExactForwardGraphs`` gives the same ids.
- The keys: (bucket, rows, memory length), at most six a model, one per
  bucket reached, reused across crops; a query past 256 runs the eager
  forward and holds no key.
- The pad ids: ``eos_id`` for UniMERNet, ``pad_id`` for PP-FormulaNet.
- The modules load neither jax nor the JAX package.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oar_ocr_tpu.runtime.runtime import Runtime as JRuntime
from oar_ocr_tpu.runtime.runtime import RuntimeConfig as JRuntimeConfig
from oar_ocr_tpu_torch.models.recognition import unimernet as tu
from oar_ocr_tpu_torch.models.recognition.exact_decode import (
    DECODE_BUCKETS, EagerForward, ExactForwardGraphs)
from oar_ocr_tpu_torch.runtime.runtime import Runtime

from test_torch_formula import formula_crops
from test_torch_formulanet import MODELS, Pair
from torch_jax_tree import one_torch_thread  # noqa: F401

POSITIONS = 256
LOOP_TOKENS = 20           # ids reach 21 (+ 2 for -S): buckets 8, 16, 32
_PAIRS = {}


def pair(name) -> Pair:
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name, max_positions=POSITIONS)
    return _PAIRS[name]


def recognizer(name):
    p = pair(name)
    return p.trec(p.state, cfg=p.tcfg,
                  runtime=Runtime("float32", device="cpu"))


def rows_of(name) -> int:
    cfg = MODELS[name][1]
    return getattr(cfg, "parallel_step", 1)


def pad_of(name) -> int:
    cfg = MODELS[name][1]
    return cfg.eos_id if name == "unimernet" else cfg.pad_id


def crop_cross(rec, crops, i):
    with torch.no_grad():
        x = rec.inputs(crops)
        return rec.model.mbart.cross_kv(rec.model.encode(x[i:i + 1]))


class Recording:
    """A forward that logs each (query, rows) it is given."""

    def __init__(self, forward):
        self.forward, self.calls = forward, []

    def begin(self, cross):
        self.forward.begin(cross)

    def __call__(self, query, rows):
        self.calls.append((list(query), list(rows)))
        return self.forward(query, rows)


@pytest.mark.parametrize("bucket", DECODE_BUCKETS)
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_body_matches_jax(name, bucket):
    p = pair(name)
    rng = np.random.default_rng(bucket)
    x = rng.normal(0, 1, (1, *p.jcfg.image_hw, 3)).astype(np.float32)
    query = rng.integers(0, p.jcfg.vocab_size, bucket).astype(np.int64)
    step = rows_of(name)
    r = int(rng.integers(0, bucket - step + 1))
    rows = list(range(r, r + step))
    enc = p.encode(p.params, jnp.asarray(x))
    logits = np.asarray(p.decode(p.params, jnp.asarray(
        query[None].astype(np.int32)), enc))
    want = logits[0, rows].argmax(-1)
    with torch.no_grad():
        cross = p.port.mbart.cross_kv(torch.from_numpy(np.array(enc)))
        graphs, eager = (ExactForwardGraphs(p.port.mbart),
                         EagerForward(p.port.mbart))
        graphs.begin(cross)
        eager.begin(cross)
        got = graphs(query.tolist(), rows)
        ref = eager(query.tolist(), rows)
    assert got.tolist() == want.tolist()
    assert np.array_equal(got, ref)
    memory = cross[0][0].shape[2]
    assert set(graphs.inputs) == {(bucket, step, memory)}
    assert (graphs.forwards, graphs.reads, graphs.eager) == (1, 1, 0)


@pytest.mark.parametrize("name", list(MODELS))
def test_loop_matches_jax(name):
    p = pair(name)
    crops = formula_crops(11, n=3)
    want = p.jrec(p.params, cfg=p.jcfg, runtime=JRuntime(JRuntimeConfig(
        compute_dtype="float32", use_mesh=False))).recognize(
            crops, max_new_tokens=LOOP_TOKENS)
    rec = recognizer(name)
    assert isinstance(rec.forward, EagerForward)
    got = rec.recognize(crops, max_new_tokens=LOOP_TOKENS)
    assert got == want
    lengths = [len(t.split()) for t in got]
    assert max(lengths) > 8, lengths
    graphs = ExactForwardGraphs(rec.model.mbart)
    buckets = set()
    for i in range(len(crops)):
        cross = crop_cross(rec, crops, i)
        with torch.no_grad():
            ids_g = rec.decode_ids(graphs, cross, LOOP_TOKENS)
            ids_e = rec.decode_ids(EagerForward(rec.model.mbart), cross,
                                   LOOP_TOKENS)
        assert ids_g == ids_e
        assert tu.token_string(ids_g[1:], None) == got[i]
        buckets |= {k[0] for k in graphs.inputs}
    assert len(buckets) >= 2, buckets         # crossed a bucket boundary
    assert graphs.reads == graphs.forwards and graphs.eager == 0


@pytest.mark.parametrize("name", list(MODELS))
def test_keys_bounded_and_eager_past_last_bucket(name):
    """Queries of lengths 1-300 through one graphs object (seeded port
    weights at 320 positions): one key a bucket (six at most, reused by
    every query of the bucket), and the queries past 256 on the eager
    forward with no key; every forward's ids equal the eager
    forward's."""
    cfg = dataclasses.replace(MODELS[name][1], max_positions=320)
    rec = MODELS[name][5](None, cfg=cfg,
                          runtime=Runtime("float32", device="cpu"))
    cross = crop_cross(rec, formula_crops(5, n=1), 0)
    graphs, eager = (ExactForwardGraphs(rec.model.mbart),
                     EagerForward(rec.model.mbart))
    graphs.begin(cross)
    eager.begin(cross)
    step, memory = rows_of(name), cross[0][0].shape[2]
    rng = np.random.default_rng(3)
    lengths = (1, 7, 8, 9, 16, 30, 60, 65, 128, 200, 254, 257, 300)
    with torch.no_grad():
        for n in lengths:
            query = rng.integers(0, cfg.vocab_size, tu.decode_bucket(
                n + step - 1)).tolist()
            rows = list(range(n - 1, n - 1 + step))
            assert np.array_equal(graphs(query, rows), eager(query, rows))
    assert set(graphs.inputs) == {(b, step, memory)
                                  for b in DECODE_BUCKETS}
    past = sum(n + step - 1 > DECODE_BUCKETS[-1] for n in lengths)
    assert graphs.eager == past == 2
    assert graphs.forwards == graphs.reads == len(lengths)
    assert ExactForwardGraphs.key(257, step, memory) is None
    assert ExactForwardGraphs.key(256, step, memory) == (256, step, memory)


@pytest.mark.parametrize("name", list(MODELS))
def test_queries_padded_with_model_pad(name):
    """Every query of the loop: a bucket long, the ids so far, then the
    model's pad id (UniMERNet ``eos_id``, PP-FormulaNet ``pad_id``); the
    rows read are the last ``rows`` positions of ids + the parallel
    pads."""
    rec = recognizer(name)
    cross = crop_cross(rec, formula_crops(11, n=1), 0)
    log = Recording(EagerForward(rec.model.mbart))
    with torch.no_grad():
        ids = rec.decode_ids(log, cross, LOOP_TOKENS)
    step, pad = rows_of(name), pad_of(name)
    assert pad == (2 if name == "unimernet" else 1)
    assert len(log.calls) >= 3
    for query, rows in log.calls:
        n = rows[0] + 1                      # ids known at this forward
        assert query[:n] == ids[:n]
        assert len(query) == tu.decode_bucket(n + step - 1)
        assert query[n:] == [pad] * (len(query) - n)
        assert rows == list(range(n - 1, n - 1 + step))


def test_exact_decode_imports_no_jax():
    """The recognizers and their forward graphs load neither jax nor the
    JAX package (a fresh interpreter: this one imported both)."""
    code = ("import sys; "
            "import oar_ocr_tpu_torch.models.recognition.exact_decode, "
            "oar_ocr_tpu_torch.models.recognition.unimernet, "
            "oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'oar_ocr_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout

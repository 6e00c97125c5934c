"""The exact stacks' and the families' greedy decode on the static
buffers of ``vl/decode_graph.py`` against the JAX package's compiled
scan, on the CPU.

The step body that the card captures as a CUDA graph runs eagerly here,
through ``DecodeState``: its plain version. Four exact flavours
(MinerU's qkv bias and MRoPE, MonkeyOCRv2's SDAR decoder with K4's plain
path at a device slot, GLM-OCR's interleaved partial rotary and sandwich
norms, OvisOCR2's hybrid stack with its static delta carry) and two
families at their tiny configs (GLM-OCR; OvisOCR2, whose decoder has
delta layers), float32, each on the port's seeded weights in both
packages (``torch_exact_common.make_pair``,
``test_torch_vl_families.make_pair``). The reference is the JAX model's
own jitted scan (``ExactVLM._gen``, ``VLMFamily._gen``), run once a
flavour on the port's prompt embeddings for a left-padded batch of two
pages; its prefill and scan body report what they return through
``jax.debug.callback``, so one compile gives the ids, the prefill's
cache and recurrent states, and every step's logits. The gates:

- the port's whole path (its own prefill into the static cache, then the
  steps) gives the scan's ids;
- the step body started from the JAX prefill's cache, first token and
  delta carry gives the scan's ids, and every step's logits within
  1e-5 · max(1, max|ref|). From its own prefill the port's OvisOCR2
  state already differs from JAX's by float32 rounding (about 4e-6 of
  its size), which its random gated-delta layers amplify past that gate
  within a few steps; holding both sides to one start state checks the
  step alone;
- a key's static cache and delta carry, reused by a shorter second
  request, give that request the ids and logits it gets alone;
- a decode past the capacity raises ``InvalidInputError``.

The graph against the eager step on the card is in
``tests/test_torch_exact_decode_graph_cuda.py``.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from oar_ocr_tpu.vl import exact_models as jem
from oar_ocr_tpu.vl import families as jfam
from oar_ocr_tpu_torch.errors import InvalidInputError
from oar_ocr_tpu_torch.vl.decode_graph import DecodeGraphs
from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity
from test_torch_vl_families import make_pair as family_pair
from torch_exact_common import imgs, make_pair
from torch_jax_tree import one_torch_thread  # noqa: F401

MAX_NEW = 6
TOL = 1e-5
EXACT = ("mineru_exact", "monkey_exact", "glm_exact", "ovis_exact")
FAMILIES = ("glmocr", "ovisocr2")
FAMILY_LENGTHS = (40, 29)      # the families' two prompts, in tokens


# what the recorded JAX programs report; every program traced under
# ``recorded`` writes here, whenever it runs
SEEN = {"prefill": None, "steps": []}


def _record_prefill(out):
    SEEN["prefill"] = jax.tree_util.tree_map(np.array, out)


def _record_step(out):
    SEEN["steps"].append(np.asarray(out[0]))


@contextlib.contextmanager
def recorded(module_cls):
    """``module_cls``'s ``prefill`` and ``decode_step``, in the programs
    traced inside, report what they return (the prefill's whole output,
    each step's logits) into :data:`SEEN` through ordered callbacks."""
    def wrap(orig, record):
        def method(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            jax.debug.callback(record, out, ordered=True)
            return out
        return method

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module_cls, "prefill",
                   wrap(module_cls.prefill, _record_prefill))
        mp.setattr(module_cls, "decode_step",
                   wrap(module_cls.decode_step, _record_step))
        yield


def _exact_inputs(ours):
    """``ExactVLM.generate``'s left-padded batch of the two pages →
    (embeds, positions, valid lengths, capacity)."""
    prepared = [ours.prepare_prompt(p, "OCR:") for p in imgs()]
    t = max(n for _, _, n in prepared)
    mrope = prepared[0][1].ndim == 3
    pids = np.zeros((3, 2, t) if mrope else (2, t), np.int64)
    rows = []
    for i, (e, p, n) in enumerate(prepared):
        rows.append(torch.nn.functional.pad(e, (0, 0, t - n, 0)))
        pids[..., i, t - n:] = p[:, 0] if mrope else p[0]
    valid = torch.tensor([n for _, _, n in prepared])
    return (torch.cat(rows).float(), torch.from_numpy(pids), valid,
            decoder_cache_capacity(t, MAX_NEW))


def _family_inputs(ours, lengths, seed=0):
    """A left-padded batch of prompts of random token ids, each MRoPE
    axis offset from the others → (embeds, positions, valid lengths,
    capacity). Token prompts, not pages: the tiny OvisOCR2 family's
    delta layers diverge to NaN over its ~800-token page prompts in both
    packages (ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)
    b, t = len(lengths), max(lengths)
    ids = np.zeros((b, t), np.int64)
    pids = np.zeros((3, b, t), np.int64)
    for i, n in enumerate(lengths):
        ids[i, t - n:] = rng.integers(6, ours.cfg.decoder.vocab_size, n)
        pids[:, i, t - n:] = np.arange(n) + np.arange(3)[:, None]
    with torch.inference_mode():
        embeds = ours.module.lm.embed_tokens(torch.from_numpy(ids))
    return (embeds, torch.from_numpy(pids), torch.tensor(lengths),
            decoder_cache_capacity(t, MAX_NEW))


class Run:
    """One flavour: the pair, its batch and what both sides gave."""

    def __init__(self, name):
        self.name = name
        self.exact = name in EXACT
        if self.exact:
            self.ours, ref = make_pair(name)
            self.inputs = _exact_inputs(self.ours)
            module_cls = jem.ExactVLMModule
        else:
            self.ours, ref = family_pair(name)
            self.inputs = _family_inputs(self.ours, FAMILY_LENGTHS)
            module_cls = jfam.FamilyModule
        e, p, vl, cap = self.inputs
        SEEN.update(prefill=None, steps=[])
        with recorded(module_cls):
            self.jax_ids = np.asarray(ref._gen(
                ref.params, e.numpy(), p.numpy().astype(np.int32),
                vl.numpy(), max_new=MAX_NEW, capacity=cap))
            jax.effects_barrier()
        self.seen = dict(SEEN)
        self.ids = self.generate(*self.inputs).numpy()

    def generate(self, e, p, vl, cap, steps=None):
        """The port's whole path: prefill into the key's static cache,
        then the steps."""
        if self.exact:
            return self.ours.prefill_decode(e, p, vl, max_new=MAX_NEW,
                                            capacity=cap, step_logits=steps)
        return self.ours._generate_impl(e, p, vl, max_new=MAX_NEW,
                                        capacity=cap, step_logits=steps)

    @torch.inference_mode()
    def from_jax_prefill(self):
        """The step body alone, started from the JAX prefill's cache,
        first token and recurrent states → (ids, each step's logits)."""
        e, p, vl, cap = self.inputs
        b, t = e.shape[:2]
        out = self.seen["prefill"]
        if self.exact:
            logits, cache, *states = out
            nxt = self.ours._step_pids(self.ours._npos(p))
        else:
            logits, _, cache, *states = out
            nxt = (p.amax(dim=(0, 2)) + 1)[None, :, None]
        st = self.ours.decode_graphs.state(b, cap, torch.float32,
                                           torch.device("cpu"))
        st.cache.k.copy_(torch.from_numpy(cache.k))
        st.cache.v.copy_(torch.from_numpy(cache.v))
        st.cache.length.fill_(t)
        st.cache.pad.copy_(t - vl)
        st.start(torch.from_numpy(logits.argmax(-1)), nxt, slot=t,
                 states=[torch.from_numpy(s) for s in states])
        steps = []
        ids = self.ours.decode_graphs.decode(st, MAX_NEW, step_logits=steps)
        return ids.numpy(), steps


@pytest.fixture(scope="module", params=EXACT + FAMILIES)
def run(request):
    return Run(request.param)


def test_greedy_ids_match_jax_scan(run):
    """The port's left-padded batch of two pages, its own prefill then
    the eager step body: the ids of the JAX package's compiled scan."""
    assert run.ids.tolist() == run.jax_ids.tolist()
    assert run.ids.shape == (2, MAX_NEW)
    assert len(set(run.ids.ravel().tolist())) > 2, "vacuous comparison"


def test_step_logits_match_jax_scan(run):
    """The step body from the JAX prefill's state: the scan's ids, and
    every step's logits within 1e-5 · max(1, max|ref|)."""
    ids, steps = run.from_jax_prefill()
    assert ids.tolist() == run.jax_ids.tolist()
    ref = run.seen["steps"]
    assert len(steps) == len(ref) == MAX_NEW
    for i, (got, want) in enumerate(zip(steps, ref)):
        assert got.shape == want.shape and np.isfinite(want).all()
        err = float(np.abs(got.numpy() - want).max())
        assert err <= TOL * max(1.0, float(np.abs(want).max())), (i, err)


def test_static_state_reused_by_a_shorter_request(run):
    """A (batch 1, capacity 256) key serves the longer page, then the
    shorter one: the static cache and delta carry give the second
    request the ids and step logits it gets from a fresh key, bit for
    bit, and the key keeps its one state."""
    ours = run.ours
    if run.exact:
        requests = []
        for img in imgs():
            e, p, t = ours.prepare_prompt(img, "OCR:")
            requests.append((e, torch.from_numpy(p).long(),
                             torch.tensor([t]), 256))
    else:
        requests = [_family_inputs(ours, [n], seed=n)[:3] + (256,)
                    for n in FAMILY_LENGTHS]
    assert requests[0][0].shape[1] > requests[1][0].shape[1]
    key = (1, 256, torch.float32)
    ours.decode_graphs.states.pop(key, None)
    alone, steps_alone = [], []
    for req in requests:
        ours.decode_graphs.states.pop(key, None)
        steps_alone.append([])
        alone.append(run.generate(*req, steps=steps_alone[-1]))
    first = ours.decode_graphs.states[key]
    run.generate(*requests[0])
    steps = []
    again = run.generate(*requests[1], steps=steps)
    assert ours.decode_graphs.states[key] is first
    assert torch.equal(again, alone[1])
    assert len(steps) == len(steps_alone[1]) == MAX_NEW
    assert all(torch.equal(a, b) for a, b in zip(steps, steps_alone[1]))


def test_decode_past_the_capacity_raises(run):
    """The steps would write past the key's cache: refused before the
    first step."""
    e, p, vl, _ = run.inputs
    t = e.shape[1]
    # an exact request takes max_new steps, a family's max_new − 1
    over = 256 - t + (1 if run.exact else 2)
    with pytest.raises(InvalidInputError, match="capacity"):
        if run.exact:
            run.ours.prefill_decode(e, p, vl, max_new=over, capacity=256)
        else:
            run.ours._generate_impl(e, p, vl, max_new=over, capacity=256)


def test_decode_state_forms():
    """Plain rope's (B, 1) positions; static recurrent states loaded by
    ``start`` (one a static state, else ``InvalidInputError``) and
    written in place by the step, so the next step reads them."""
    class Cfg:
        layers, kv_heads, head_dim, eos_id = 1, 1, 2, 0

    def step(tok, positions, cache, slot, carry):
        cache.advance(1)
        carry += positions.float()
        return torch.nn.functional.one_hot((tok + 1).long() % 5,
                                           5).float() + carry

    graphs = DecodeGraphs(step, Cfg, axes=None,
                          states=lambda b, d: (torch.zeros((b, 1),
                                                           device=d),))
    st = graphs.state(2, 8, torch.float32, torch.device("cpu"))
    assert st.positions.shape == (2, 1) and st.states[0].shape == (2, 1)
    with pytest.raises(InvalidInputError):
        st.start(torch.tensor([1, 2]), 3, slot=2)
    st.cache.reset()
    st.start(torch.tensor([1, 2]), torch.tensor([[3], [4]]), slot=2,
             states=[torch.tensor([[10.0], [20.0]])])
    ids = graphs.decode(st, 3)
    # positions 3,4,5 (row 0) and 4,5,6 (row 1) added to the carry
    assert st.states[0].tolist() == [[22.0], [35.0]]
    assert ids.tolist() == [[1, 2, 3], [2, 3, 4]]
    assert st.cache.length.tolist() == [3, 3] and int(st.slot) == 5

"""HPD's fork rounds, HPD-Parsing's children and SDAR's block diffusion
as CUDA graphs on the card.

Each path at its tiny config, float32, replayed through its graphs
against the same bodies run eagerly (``graph=False``) on the card, bit
for bit: the fork scheduler's rounds (``vl/hpd_scheduler.SlotPool``, one
graph per (slots, k, capacity); each round's targets, accept counts and
hidden states compared as bits), HPD-Parsing's children at per-row slots
(the decode graph of a per-row key) and SDAR's trial and commit passes,
exact and family (``vl/diffusion.DiffusionBlocks``; ids and every trial's
logits as bits); the kernel launches counted through the replays equal
to the eager runs'; the static buffers at their addresses across
requests; and K4's two new instances against their plain version. The
CPU side, held to the JAX package, is
``tests/test_torch_hpd_diffusion_graph.py``; this file imports only the
port, since the card's machine has no flax. Every test needs a card and
is marked ``cuda``.
"""

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl import exact_models as em
from oar_ocr_tpu_torch.vl import families as fam
from oar_ocr_tpu_torch.vl.exact_models import _causal_prefill_mask
from oar_ocr_tpu_torch.vl.hpd_scheduler import HpdSchedulerConfig
from oar_ocr_tpu_torch.vl.kv_cache import decoder_cache_capacity

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

T = 9
KERNELS = (fnr.KERNEL, fnr.KERNEL_QK)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs and the kernels have no "
                    "CPU form")


def _bits(x):
    return x.float().cpu().view(torch.int32)


def _counted(run):
    """``run()`` and the K3/K4 launches it counted."""
    before = [k.launches for k in KERNELS]
    out = run()
    torch.cuda.synchronize()
    return out, [k.launches - n for k, n in zip(KERNELS, before)]


def _token_prompt(embed, vocab, seed=5):
    """Random token ids' embeddings (1, T, H) standing in for an image's
    (the tiny towers' head sizes are not ones the flash kernel is built
    for)."""
    ids = np.random.default_rng(seed).integers(6, vocab, (1, T))
    with torch.inference_mode():
        return embed(torch.tensor(ids, device="cuda")).float()


# ------------------------------ HPD rounds ------------------------------

class Hpd:
    """The exact HPD stack on the card, its prompt prefilled once."""

    def __init__(self):
        rt = Runtime("float32", "cuda", cfg=ONE_DEVICE)
        self.m = m = em.hpd_fork_exact(tiny=True, seed=4, runtime=rt)
        c = m.spec.text_cfg
        embeds = _token_prompt(m.net.embed, c.vocab_size)
        self.cap = decoder_cache_capacity(T + 10, 10)
        self.cache = m.new_cache(1, self.cap)
        with torch.inference_mode():
            logits, hidden, _, _ = m.net.prefill_hidden_all(
                embeds, torch.arange(T, device="cuda")[None], self.cache,
                _causal_prefill_mask(1, T, self.cap, m.device),
                *m.empty_states(1))
        self.cache.advance(T)
        self.first, self.hidden = int(logits.argmax(-1)[0]), hidden[:, -1]
        # fork wherever the greedy parent emits its most frequent token
        toks = self.run(False)[0].parent_tokens
        m.DEV_FORK_ID = max(set(toks), key=toks.count)
        for key in ("_sched", "_sched_mtp"):
            if hasattr(m, key):
                delattr(m, key)

    def run(self, use_mtp, graph=True):
        """One request's rounds → (output, round log, K3/K4 launches)."""
        log = []
        sched = self.m.scheduler(use_mtp)
        out, n = _counted(lambda: sched.run(
            self.cache, self.first, self.hidden, HpdSchedulerConfig(
                max_new_tokens=10, use_mtp=use_mtp,
                num_speculative_tokens=6), graph=graph, round_log=log))
        return out, log, n


@pytest.mark.cuda
@pytest.mark.parametrize("use_mtp", [False, True])
def test_cuda_hpd_round_graphs_match_eager(use_mtp):
    """The request that captures, one that only replays and the eager
    rounds: the same ids, stats and per-round targets and accept counts,
    every round's hidden states equal as bits, the same K3/K4 launches;
    the pools' static buffers keep their addresses across the requests
    (forks and growth included), their caches the leading rows of the
    model's one row buffer; P-MTP's ids are greedy's."""
    _need_card()
    h = Hpd()
    eager = h.run(use_mtp, graph=False)
    sched = h.m.scheduler(use_mtp)
    runs = []
    for _ in range(2):
        runs.append(h.run(use_mtp))
        if len(runs) == 1:
            ptrs = {key: [x.data_ptr() for x in (p.cache.k, p.cache.length,
                                                 p.hidden, p.inputs)]
                    for key, p in sched.pools.items()}
    assert eager[0].stats.forked_branches >= 1 and len(ptrs) >= 2
    for out, log, n in runs:
        assert out.token_ids == eager[0].token_ids
        assert out.children == eager[0].children
        assert out.stats == eager[0].stats
        assert len(log) == len(eager[1])
        for a, b in zip(log, eager[1]):
            assert a[0] == b[0]
            assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
            assert torch.equal(_bits(a[3]), _bits(b[3]))
        assert n == eager[2]
    assert {key: [x.data_ptr() for x in (p.cache.k, p.cache.length,
                                         p.hidden, p.inputs)]
            for key, p in sched.pools.items()} == ptrs
    assert all(p.graphs for p in sched.pools.values())
    rows = h.m.slot_rows.buffers[(h.cap, torch.float32)]
    assert all(p.cache.k.data_ptr() == rows.k.data_ptr()
               for p in sched.pools.values())
    c = h.m.spec.text_cfg
    for p in sched.pools.values():
        for k, g in p.graphs.items():
            assert g.launches.counts[fnr.KERNEL_QK] == c.layers
            assert g.launches.counts[fnr.KERNEL] == 2 * c.layers + k
    if use_mtp:
        greedy = h.run(False)[0]
        assert runs[0][0].token_ids == greedy.token_ids


# ------------------- HPD-Parsing's children, per-row slots -------------------

@pytest.mark.cuda
def test_cuda_hpd_family_children_match_eager():
    """HPD-Parsing's parent at the 0-d slot and its children forked at
    depths 2 and 5 at per-row slots, through their decode graphs and
    eagerly: ids and every step's logits equal as bits."""
    _need_card()
    rt = Runtime("float32", "cuda", cfg=ONE_DEVICE)
    m = fam.HPDParsing(tiny=True, seed=5, runtime=rt)
    c = m.cfg.decoder
    embeds = _token_prompt(m.module.lm.embed_tokens, c.vocab_size)
    pos = torch.arange(T, device="cuda", dtype=torch.int32).expand(3, 1, T)
    n = 8

    def run(graph):
        cap = decoder_cache_capacity(T, n + 1)
        st = m.decode_graphs.state(1, cap, torch.float32, rt.device)
        with torch.inference_mode():
            cache, full, _ = m._new_cache(embeds, np.array([T]), cap,
                                          cache=st.cache)
            logits, _, _ = m.module.lm.prefill(embeds, pos, cache, full)
            cache.advance(T)
        steps, csteps = [], []
        parent, pcache = m._decode_from_cache(
            logits.argmax(-1).to(torch.int32), cache, T, T, n,
            step_logits=steps, graph=graph)
        ends = (2, 5)
        child = pcache.keep_indices([0, 0]).with_lengths(
            [T + e for e in ends])
        children, _ = m._decode_from_cache(
            torch.tensor([int(parent[0, e]) for e in ends],
                         dtype=torch.int32, device="cuda"), child,
            torch.tensor([T + e for e in ends], device="cuda"),
            torch.tensor([T + e for e in ends], device="cuda"), n,
            step_logits=csteps, graph=graph)
        return parent, children, torch.cat(
            [torch.stack([s.cpu() for s in part], 1).flatten(0, 1)
             for part in (steps, csteps)])

    eager = run(False)
    for got in (run(True), run(True)):
        assert np.array_equal(got[0], eager[0])
        assert np.array_equal(got[1], eager[1])
        assert torch.equal(_bits(got[2]), _bits(eager[2]))
    st = m.decode_graphs.states[(2, decoder_cache_capacity(T, n + 1),
                                 torch.float32, "rows")]
    assert st.graph is not None and st.slot.shape == (2,)


# ---------------------------- SDAR diffusion ----------------------------

def _diffusion(name):
    """(start() → the key's state after a prefill, the model's blocks,
    eos, block length) for the exact stack or the family."""
    rt = Runtime("float32", "cuda", cfg=ONE_DEVICE)
    if name == "exact":
        m = em.mineru_diffusion_exact(tiny=True, seed=3, runtime=rt)
        c = m.spec.text_cfg
        embeds = _token_prompt(m.net.embed, c.vocab_size)

        def start():
            return m.diffusion_start(
                embeds, torch.arange(T, device="cuda")[None],
                max_new_tokens=16, block_len=8, confidence_threshold=0.9)

        return start, m.diffusion, c.eos_id, 8
    m = fam.MinerUDiffusion(tiny=True, seed=5, runtime=rt)
    c, L = m.cfg.decoder, m.cfg.diffusion_block
    embeds = _token_prompt(m.module.lm.embed_tokens, c.vocab_size)
    pos = torch.arange(T, device="cuda", dtype=torch.int32).expand(3, 1, T)

    def start():
        cap = decoder_cache_capacity(T, 3 * L)
        st = m.diffusion_state(cap, torch.float32, rt.device)
        with torch.inference_mode():
            cache, full, _ = m._new_cache(embeds, np.array([T]), cap,
                                          cache=st.cache)
            m.module.lm.prefill(embeds, pos, cache, full)
            cache.advance(T)
            st.begin(T, T + torch.arange(L, device="cuda"), 0.9)
        return st

    return start, m.diffusion, c.eos_id, L


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["exact", "family"])
def test_cuda_diffusion_graphs_match_eager(name):
    """Two blocks through the captured trial and commit graphs (a request
    that captures, one that replays) against the eager passes: the ids
    and every trial's logits equal as bits, the same K3/K4 launches; the
    second request replays the first one's graphs."""
    _need_card()
    start, blocks, eos, L = _diffusion(name)

    def run(graph):
        st, logits = start(), []
        (ids, n) = _counted(lambda: blocks.decode(st, 2, 4, eos, graph=graph,
                                                  logits=logits))
        return ids, torch.stack([g.cpu() for g in logits]), n, st

    eager = run(False)
    first = run(True)
    graphs = dict(first[3].graphs)
    assert set(graphs) == {"trial", "commit"}
    for got in (first, run(True)):
        assert got[0] == eager[0]
        assert torch.equal(_bits(got[1]), _bits(eager[1]))
        assert got[2] == eager[2]
    assert first[3].graphs == graphs


# ------------------------------- K4 instances -------------------------------

def _k4_case(b, t, slot, cap):
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k = (torch.randn((b, t, h, 128), generator=g, device="cuda")
            for h in (16, 8))
    qs, ks = (torch.rand((128,), generator=g, device="cuda") + 0.5
              for _ in range(2))
    ang = torch.rand((b, t, 64), generator=g, device="cuda") * cap
    caches = [torch.zeros((b, 8, cap, 128), device="cuda") for _ in range(2)]
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope_qk(q, k, qs, ks, ang.cos(), ang.sin(),
                                    k_out=caches[0], slot=slot, eps=1e-6)
    torch.cuda.synchronize()
    assert fnr.KERNEL_QK.launches == before + 1
    ref = fnr.qk_norm_rope_qk_ref(q, k, qs, ks, ang.cos(), ang.sin(),
                                  k_out=caches[1], slot=slot, eps=1e-6)
    assert torch.equal(caches[0] == 0, caches[1] == 0)
    for out, want in ((got, ref), (caches[0], caches[1])):
        assert float((out - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


@pytest.mark.cuda
def test_cuda_k4_hpd_round_per_row_matches_plain():
    """K4 as the HPD round graph's verify block runs it: 8 slots of
    SDAR's 16 q and 8 k heads of 128, a block of 7 (6 drafts + the
    pending token), each row's k into a (8, 8, 512, 128) layer cache from
    its slot in an (8,) device vector, the last clamped to C − T."""
    _need_card()
    _k4_case(8, 7, torch.tensor([300, 17, 0, 509, 260, 261, 4, 100],
                                device="cuda"), 512)


@pytest.mark.cuda
def test_cuda_k4_sdar_block_device_slot_matches_plain():
    """K4 as SDAR's trial and commit graphs run it: one row, a block of 8
    at the 0-d device slot 300 of a (1, 8, 512, 128) layer cache."""
    _need_card()
    _k4_case(1, 8, torch.tensor(300, device="cuda"), 512)

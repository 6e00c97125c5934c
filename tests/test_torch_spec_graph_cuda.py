"""The speculative rounds as CUDA graphs on the card.

Each round path of ``vl/decode_graph.SpecRounds`` — HunyuanOCRSpeculative's
DFlash round, the HunyuanOCR family's DFlash and the GLM-OCR family's MTP
rounds, OvisOCR2's exact n-gram round and GLM-OCR's exact MTP round — at
its tiny config, float32: the replayed graphs against the same halves run
eagerly (``graph=False``) bit for bit (ids, accept counts, each round's
verify logits compared as bits), the kernel launches counted through the
replays equal to the eager rounds', a forced accept through the replayed
verify half alone, and K4 at the verify block's device slot for
``block_size`` rows against its plain version. The CPU side, held to the
JAX package, is ``tests/test_torch_spec_graph.py``; this file imports
only the port, since the card's machine has no flax. Every test needs a
card and is marked ``cuda``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl import exact_models as em
from oar_ocr_tpu_torch.vl import families as fam
from oar_ocr_tpu_torch.vl import hunyuan as hy
from oar_ocr_tpu_torch.vl.dflash import DFlashConfig

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

PATHS = ("hunyuan", "family_dflash", "family_mtp", "ngram", "glm_mtp")
MAX_NEW = 12
T = 9
HY_CFG = dataclasses.replace(hy.HunyuanOCRConfig().tiny(), bos_id=1,
                             eos_id=2, image_start_id=500,
                             image_end_id=501, image_token_id=502)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs and the kernels have no "
                    "CPU form")


class Path:
    """A round path's model on the card and its prompt: random token ids
    whose embeddings stand in for an image's (the tiny towers' head
    sizes are not ones the flash kernel is built for)."""

    def __init__(self, name):
        self.name = name
        rt = Runtime("float32", "cuda", cfg=ONE_DEVICE)
        ids = np.random.default_rng(5).integers(3, 200, (1, T))
        tok = torch.tensor(ids, device="cuda")
        ar = torch.arange(T, device="cuda")
        with torch.inference_mode():
            if name == "hunyuan":
                m = hy.HunyuanOCRSpeculative(
                    cfg=HY_CFG, seed=3, runtime=rt,
                    dflash_cfg=DFlashConfig().tiny(
                        vocab_size=HY_CFG.vocab_size, hidden=HY_CFG.hidden))
                self.embeds = m.net.model.embed_tokens(tok)
                self.pos = ar.expand(4, 1, T)
                self.k, self.eos = m.dcfg.block_size - 1, m.cfg.eos_id
            elif name.startswith("family"):
                key = "hunyuanocr" if name == "family_dflash" else "glmocr"
                m = fam.FAMILY_CLASSES[key](tiny=True, seed=7, runtime=rt)
                self.embeds = m.module.lm.embed_tokens(tok)
                self.pos = ar.to(torch.int32).expand(3, 1, T)
                self.valid = np.array([T], np.int32)
                self.k = (m.cfg.dflash.block_size - 1 if m.cfg.dflash
                          else m.cfg.draft_len)
                self.eos = m.cfg.decoder.eos_id
            else:
                m = (em.ovis_exact(tiny=True, seed=5, runtime=rt)
                     if name == "ngram" else
                     em.glm_speculative_exact(tiny=True, seed=3, runtime=rt))
                self.embeds = m.net.embed(tok)
                self.pos = ar[None]
                self.k = 3 if name == "ngram" else m.draft_k
                self.eos = m.spec.text_cfg.eos_id
        self.m = m

    def start(self):
        """Prefill into the round key's static buffers → (round runner,
        state, page-bucket function)."""
        m, n = self.m, self.name
        if n == "hunyuan":
            _, cache, _ = m.start(self.embeds, self.pos, max_new=MAX_NEW)
            return (m.spec_rounds, m.spec_rounds.states[
                (1, cache.capacity, torch.float32)], m.bucket)
        if n == "family_dflash":
            _, cache, _ = m.dflash_start(self.embeds, self.pos, self.valid,
                                         max_new=MAX_NEW)
            return (m.spec_rounds, m.spec_rounds.states[
                (1, cache.capacity, torch.float32)], m.dflash_bucket)
        if n == "family_mtp":
            return (m.spec_rounds, m.mtp_start(self.embeds, self.pos,
                                               self.valid, max_new=MAX_NEW),
                    lambda st: None)
        if n == "ngram":
            return (m.spec_rounds, m.ngram_start(
                self.embeds, self.pos, [5, 6, 7], max_new_tokens=MAX_NEW,
                draft_k=self.k, ngram=2), lambda st: None)
        return (m.mtp_rounds, m.mtp_start(self.embeds, self.pos,
                                          max_new_tokens=MAX_NEW),
                lambda st: None)

    def greedy(self, n):
        """The target's greedy ids, through its decode graph."""
        m = self.m
        if self.name == "hunyuan":
            return m.prefill_decode(self.embeds, self.pos, max_new=n,
                                    capacity=256)[0][0].tolist()
        if self.name.startswith("family"):
            return m._generate_impl(self.embeds, self.pos, self.valid,
                                    max_new=n, capacity=256)[0].tolist()
        return m.prefill_decode(
            self.embeds, self.pos, torch.tensor([T], device="cuda"),
            max_new=n, capacity=256)[0].tolist()

    def request(self, graph):
        """One request's rounds → (ids, accept counts, verify logits on
        the host, K3 and K4 launches of the rounds)."""
        rounds, st, bucket = self.start()
        kernels = (fnr.KERNEL, fnr.KERNEL_QK)
        before = [k.launches for k in kernels]
        acc, logits = [], []
        ids = rounds.decode(st, int(st.tok[0]), MAX_NEW, self.eos,
                            bucket=bucket, graph=graph, rounds=acc,
                            logits=logits)
        torch.cuda.synchronize()
        counts = [k.launches - n for k, n in zip(kernels, before)]
        return ids, acc, [g.cpu() for g in logits], counts


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_cuda_round_graphs_match_eager(path):
    """The request that captures, one that only replays and the eager
    rounds: the same ids and accept counts, every round's verify logits
    equal as bits, the same K3/K4 launches; HunyuanOCR's rounds run one
    target forward each (2 K3 and 1 K4 a layer)."""
    _need_card()
    p = Path(path)
    eager = p.request(False)
    for graph in (p.request(True), p.request(True)):
        assert graph[0] == eager[0] and graph[1] == eager[1]
        assert len(graph[2]) == len(eager[2]) == len(eager[1]) >= 2
        for g, e in zip(graph[2], eager[2]):
            assert torch.equal(g.view(torch.int32), e.view(torch.int32))
        assert graph[3] == eager[3]
    rounds, st, _ = p.start()
    assert st.verify_graphs[None].graph is not None and st.draft_graphs
    if path == "hunyuan":
        n = len(eager[1])
        assert eager[3] == [2 * HY_CFG.layers * n, HY_CFG.layers * n]
        assert {k.name: v for k, v in
                st.verify_graphs[None].launches.counts.items()} == {
            fnr.KERNEL.name: 2 * HY_CFG.layers,
            fnr.KERNEL_QK.name: HY_CFG.layers}


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_cuda_forced_accept_through_replayed_verify(path):
    """After a request captured the graphs: the greedy's next k ids
    written into the static drafts and the verify half replayed alone
    accept all k and emit the greedy's k + 1 ids."""
    _need_card()
    p = Path(path)
    p.request(True)                       # captures both halves
    greedy = p.greedy(p.k + 2)
    rounds, st, _ = p.start()
    verify = st.verify_graphs[None]
    before = fnr.KERNEL.launches
    with torch.inference_mode():
        st.drafts.copy_(torch.tensor([greedy[1:p.k + 1]],
                                     dtype=torch.int32))
    emitted, n_acc = rounds.run(st, draft=False)
    assert st.verify_graphs[None] is verify          # replayed, not captured
    assert fnr.KERNEL.launches - before == verify.launches.counts[
        fnr.KERNEL]
    assert n_acc == p.k and emitted.tolist() == greedy[1:p.k + 2]
    assert st.at == T + p.k + 1
    assert st.cache.length.tolist() == [T + p.k + 1]


@pytest.mark.cuda
def test_cuda_k4_verify_block_device_slot_matches_plain():
    """K4 as HunyuanOCR's verify block runs it inside a round's graph:
    q+k (16+4 heads, 8 rows, 128) at a 0-d device slot into the layer's
    whole (1, 4, 2048, 128) cache, one launch, within 1e-6 · max of the
    plain version, nothing else of the cache written."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(20)
    q, k = (torch.randn((1, 8, h, 128), generator=g, device="cuda")
            for h in (16, 4))
    qs, ks = (torch.rand((128,), generator=g, device="cuda") + 0.5
              for _ in range(2))
    ang = torch.rand((1, 8, 64), generator=g, device="cuda") * 2048.0
    slot = torch.tensor(1300, device="cuda")
    caches = [torch.zeros((1, 4, 2048, 128), device="cuda")
              for _ in range(2)]
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope_qk(q, k, qs, ks, ang.cos(), ang.sin(),
                                    k_out=caches[0], slot=slot, eps=1e-5)
    torch.cuda.synchronize()
    assert fnr.KERNEL_QK.launches == before + 1
    ref = fnr.qk_norm_rope_qk_ref(q, k, qs, ks, ang.cos(), ang.sin(),
                                  k_out=caches[1], slot=slot, eps=1e-5)
    assert not caches[0][:, :, :1300].any() and \
        not caches[0][:, :, 1308:].any()
    for out, want in ((got, ref), (caches[0], caches[1])):
        assert float((out - want).abs().max()) <= 1e-6 * float(
            want.abs().max())

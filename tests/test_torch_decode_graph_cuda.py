"""The decode graph and K4's device slot on the card.

The replayed CUDA graph of ``vl/decode_graph.py`` against the eager step
body (``graph=False``) on the same inputs, for both VL decoders at their
tiny configs, and K4's kernel writing k at a device slot into a layer's
whole cache against its plain version. The CPU side of both is in
``tests/test_torch_decode_graph.py``, held to the JAX package; this file
imports only the port, since the card's machine has no flax. Every test
needs a card and is marked ``cuda``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from oar_ocr_tpu_torch.config.runtime import RuntimeConfig
from oar_ocr_tpu_torch.ops import fused_norm_rope as fnr
from oar_ocr_tpu_torch.runtime.runtime import Runtime
from oar_ocr_tpu_torch.vl import PaddleOCRVL, PaddleOCRVLConfig
from oar_ocr_tpu_torch.vl import hunyuan as hy

# a mesh only where a test asks for one, whatever the card count
ONE_DEVICE = RuntimeConfig(use_mesh=False)

VL_CFG = PaddleOCRVLConfig().tiny()
HY_CFG = dataclasses.replace(hy.HunyuanOCRConfig().tiny(), bos_id=1,
                             eos_id=2, image_start_id=500,
                             image_end_id=501, image_token_id=502)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the kernel have no "
                    "CPU form")


def _inputs(model):
    """``prefill_decode``'s inputs for 2 rows of random token ids, each
    rotary axis offset from the others; the VL rows left-padded to
    lengths 9 and 6. Token embeddings stand in for the image's: the tiny
    towers' head size (16) is not one the flash kernel is built for."""
    rng = np.random.default_rng(5)
    cfg = VL_CFG if model == "vl" else HY_CFG
    rt = Runtime("float32", "cuda", cfg=ONE_DEVICE)
    m = (PaddleOCRVL(cfg=cfg, runtime=rt, seed=1) if model == "vl"
         else hy.HunyuanOCRModel(cfg=cfg, runtime=rt, seed=1))
    ids = rng.integers(3, cfg.vocab_size, (2, 9)).astype(np.int32)
    axes = 3 if model == "vl" else 4
    pids = np.broadcast_to(np.arange(9, dtype=np.int32)[None, None],
                           (axes, 2, 9)).copy()
    pids[1] += 1
    pids[2] += 2
    with torch.inference_mode():
        embeds = m.net.model.embed_tokens(rt.put(ids))
    if model == "hunyuan":
        pids[3] = 0
        return m, (embeds, rt.put(pids))
    valid = np.array([9, 6], np.int32)
    pids[:, 1] = np.clip(pids[:, 1] - 3, 0, None)
    return m, (embeds, rt.put(pids), rt.put(valid))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["vl", "hunyuan"])
def test_cuda_graph_matches_eager(model):
    """float32: the replayed graph gives the eager step's ids and its
    step logits within 1e-5 of max|logit|, for the request that captures
    and for one that only replays; the kernel counts through replays
    equal the eager loop's."""
    _need_card()
    m, args = _inputs(model)
    kernels = (fnr.KERNEL, fnr.KERNEL_QK)
    runs = {True: [], False: []}
    for graph in (True, True, False):
        before = [k.launches for k in kernels]
        steps = []
        ids, _ = m.prefill_decode(*args, max_new=9, capacity=256,
                                  step_logits=steps, graph=graph)
        torch.cuda.synchronize()
        counts = [k.launches - n for k, n in zip(kernels, before)]
        runs[graph].append((ids.cpu(), steps, counts))
    eager_ids, eager_steps, eager_counts = runs[False][0]
    for ids, steps, counts in runs[True]:
        assert torch.equal(ids, eager_ids) and counts == eager_counts
        assert len(steps) == len(eager_steps) == 9
        for g, e in zip(steps, eager_steps):
            assert float((g - e).abs().max()) <= 1e-5 * float(e.abs().max())
    st = m.decode_graphs.states[(2, 256, torch.float32)]
    assert st.graph is not None and st.capture_ms > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,pos", [(1, 1, 1249), (2, 1, 7), (1, 3, 2046)])
def test_cuda_qk_norm_rope_qk_slot_matches_plain(dtype, b, t, pos):
    """K4 with the device slot writing into a layer's whole cache: one
    launch, q and k within the K4 gates of the plain version with the
    same slot, and nothing else of the cache written (the last case
    clamps its start)."""
    _need_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(b + t)
    q, k = (torch.randn((b, t, h, 128), generator=g, device="cuda").to(dt)
            for h in (16, 4))
    qs, ks = ((torch.rand((128,), generator=g, device="cuda") + 0.5).to(dt)
              for _ in range(2))
    ang = torch.rand((b, t, 64), generator=g, device="cuda") * 2048.0
    slot = torch.tensor(pos, device="cuda")
    caches = [torch.zeros((b, 4, 2048, 128), dtype=dt, device="cuda")
              for _ in range(2)]
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope_qk(q, k, qs, ks, ang.cos(), ang.sin(),
                                    k_out=caches[0], slot=slot, eps=1e-5)
    torch.cuda.synchronize()
    assert fnr.KERNEL_QK.launches == before + 1
    ref = fnr.qk_norm_rope_qk_ref(q, k, qs, ks, ang.cos(), ang.sin(),
                                  k_out=caches[1], slot=slot, eps=1e-5)
    at = min(pos, 2048 - t)
    assert not caches[0][:, :, :at].any() and \
        not caches[0][:, :, at + t:].any()
    for out, want in ((got, ref), (caches[0], caches[1])):
        diff = (out.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if dt == torch.float32:
            assert float(diff.max()) <= 1e-5 * top
        else:
            a = want.float().abs().clamp_min(2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
            assert bool((diff <= ulp + 1e-6 * top).all())


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [[5, 0, 2040, 300], [2047, 1]])
def test_cuda_qk_norm_rope_qk_per_row_slots_match_plain(slots):
    """K4 with a (B,) per-row slot vector (the HPD scheduler's branches):
    one launch, each row's k written from its own slot (the last clamped
    to C − T) as the plain version writes it, nothing else of the cache
    written, q within the float32 K4 gate."""
    _need_card()
    b, t = len(slots), 7
    g = torch.Generator(device="cuda").manual_seed(b)
    q, k = (torch.randn((b, t, h, 128), generator=g, device="cuda")
            for h in (16, 8))
    qs, ks = (torch.rand((128,), generator=g, device="cuda") + 0.5
              for _ in range(2))
    ang = torch.rand((b, t, 64), generator=g, device="cuda") * 2048.0
    slot = torch.tensor(slots, device="cuda")
    caches = [torch.zeros((b, 8, 2048, 128), device="cuda")
              for _ in range(2)]
    before = fnr.KERNEL_QK.launches
    got = fnr.fused_qk_norm_rope_qk(q, k, qs, ks, ang.cos(), ang.sin(),
                                    k_out=caches[0], slot=slot, eps=1e-6)
    torch.cuda.synchronize()
    assert fnr.KERNEL_QK.launches == before + 1
    ref = fnr.qk_norm_rope_qk_ref(q, k, qs, ks, ang.cos(), ang.sin(),
                                  k_out=caches[1], slot=slot, eps=1e-6)
    assert torch.equal(caches[0] != 0, caches[1] != 0)
    for out, want in ((got, ref), (caches[0], caches[1])):
        assert float((out - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
